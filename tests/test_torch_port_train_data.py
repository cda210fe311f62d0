"""The port's training dataset (``train/data.py``) against the JAX package's.

The tree is ``test_torch_port_stages``'s: volumes 24x28x24, patients P1, P2
(fold 1 of 2) and P30 (fold 2), 6 lesion slices a patient, FLAIR and T1.
Both packages build the dataset of the three patients at train size 64 and
96, under GC and under CLAHE (FLAIR) and with no enhancement (T1 + FLAIR).

Tolerance. Instance maps, boxes, ``valid``, ``meta``, ``src_hw``, ``ratio``
and ``max_inst`` equal; the fold split equal. Images: the reference's
bilinear resize is rebuilt from its weight matrices and float32 rounding
order. XLA computes some weight matrices at compile time, rounding a
sample position twice where its compiled program rounds it once, and its
matrix products may sum in another order, so a pixel within an ulp of an
integer can land one grey level away after the truncating cast. The tests
print how many pixels differ and allow at most one grey level on at most
0.05% of the pixels (measured here: 0 to 14 pixels a case, none at 218 x 182
to 640).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_stages import write_dataset
from tpu_mslesseg.train import data as jdata
from tpu_mslesseg_torch.train import data as tdata

MAX_SHARE = 5e-4  # of the pixels, where a resize is not matched bit for bit
PIDS = ["P1", "P2", "P30"]
CASES = {"gc": (["FLAIR"], "GC"), "clahe": (["FLAIR"], "CLAHE"), "none_multi": (["T1", "FLAIR"], None)}


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("train_data")
    write_dataset(root)
    return root / "MSLesSeg-Dataset" / "train"


@pytest.mark.parametrize("size", [64, 96])
@pytest.mark.parametrize("case", sorted(CASES))
def test_build_dataset_equals_jax(tree, case, size):
    mods, mejora = CASES[case]
    j = jdata.build_dataset(PIDS, "axial", mods, mejora, 6, tree, train_size=size)
    t = tdata.build_dataset(PIDS, "axial", mods, mejora, 6, tree, train_size=size, device="cpu")
    ji = np.asarray(j.images)
    ti = t.images.numpy()
    assert ti.dtype == np.uint8 and ti.shape == ji.shape
    _assert_within_a_level(ti, ji, f"{case} at {size}")
    np.testing.assert_array_equal(t.instmaps.numpy(), np.asarray(j.instmaps))
    np.testing.assert_array_equal(t.boxes.numpy(), np.asarray(j.boxes))
    np.testing.assert_array_equal(t.valid.numpy(), np.asarray(j.valid))
    assert t.meta == j.meta and t.src_hw == j.src_hw and t.ratio == j.ratio
    assert t.max_inst == j.max_inst and len(t) == len(j)
    assert t.nbytes() == sum(np.asarray(a).nbytes for a in j.as_dict().values())


def test_build_dataset_with_a_given_max_inst(tree):
    j = jdata.build_dataset(["P30"], "coronal", ["FLAIR"], "GC", 6, tree, train_size=64, max_inst=12)
    t = tdata.build_dataset(["P30"], "coronal", ["FLAIR"], "GC", 6, tree, train_size=64,
                            max_inst=12, device="cpu")
    assert t.max_inst == 12
    _assert_within_a_level(t.images.numpy(), np.asarray(j.images), "coronal at 64")
    np.testing.assert_array_equal(t.boxes.numpy(), np.asarray(j.boxes))


def test_no_slices_raises_like_jax(tree):
    for build, kw in ((jdata.build_dataset, {}), (tdata.build_dataset, {"device": "cpu"})):
        with pytest.raises(ValueError, match="No se encontraron"):
            build([], "axial", ["FLAIR"], None, 6, tree, train_size=64, **kw)


@pytest.mark.parametrize("hw,size", [((218, 182), 640), ((182, 182), 640), ((28, 24), 96),
                                     ((28, 24), 64), ((24, 28), 200), ((218, 182), 160)])
def test_resize_against_jax_image_resize(hw, size):
    rng = np.random.default_rng(hw[0] + size)
    imgs = rng.integers(0, 256, (6,) + hw).astype(np.uint8)
    r = size / max(hw)
    nh, nw = round(hw[0] * r), round(hw[1] * r)
    want = np.asarray(jax.image.resize(jnp.asarray(imgs, jnp.float32), (6, nh, nw), "bilinear")
                      ).astype(np.uint8)
    got = tdata.resize_bilinear_u8(torch.from_numpy(imgs), nh, nw).numpy()
    _assert_within_a_level(got, want, f"resize {hw} -> {(nh, nw)}")


def _assert_within_a_level(got, want, what):
    diff = np.abs(got.astype(int) - want.astype(int))
    n = int((diff > 0).sum())
    print(f"{what}: {n} of {diff.size} pixels differ (by at most {int(diff.max())})")
    assert diff.max() <= 1 and n <= MAX_SHARE * diff.size


def test_label_instances_drops_the_smallest_like_jax():
    rng = np.random.default_rng(5)
    for _ in range(20):
        mask = (rng.uniform(size=(20, 24)) > 0.8).astype(np.uint8)
        for max_inst in (2, 5, 40):
            got, want = tdata.label_instances(mask, max_inst), jdata.label_instances(mask, max_inst)
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)
    masks = (rng.uniform(size=(5, 20, 24)) > 0.7)
    assert tdata.count_max_instances(masks) == jdata.count_max_instances(masks)


@pytest.mark.parametrize("k_folds", [2, 5])
def test_fold_patient_split_equals_jax(k_folds):
    pids = [f"P{i}" for i in range(1, 54)]
    for fold in range(1, k_folds + 1):
        assert tdata.fold_patient_split(pids, fold, k_folds) == \
            jdata.fold_patient_split(pids, fold, k_folds)


@pytest.mark.parametrize("n,batch,mosaic", [(10, 4, True), (10, 4, False), (3, 4, True),
                                            (3, 8, False)])
def test_epoch_indices(n, batch, mosaic):
    gen = torch.Generator().manual_seed(1)
    idx = tdata.epoch_indices(gen, n, batch, mosaic)
    steps = max(n // batch, 1)
    assert idx.shape == (steps, batch, 4) and idx.dtype == torch.int64
    col0 = idx[..., 0].reshape(-1)
    if steps * batch <= n:
        assert len(set(col0.tolist())) == col0.numel()  # a permutation's prefix
    else:  # wraps: every slice appears, the first n form a permutation
        assert sorted(col0[:n].tolist()) == list(range(n))
    assert bool(((idx >= 0) & (idx < n)).all())
    if not mosaic:
        assert not idx[..., 1:].any()
    again = tdata.epoch_indices(torch.Generator().manual_seed(1), n, batch, mosaic)
    assert torch.equal(idx, again)
