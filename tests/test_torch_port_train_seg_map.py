"""The port's seg-mAP evaluator (``evalx/seg_map.py``) against the JAX package's.

The cases are the reference's own (``tests/test_seg_map.py``,
``tests/test_seg_map_goldens.py``: hand-derived matches and AP values) and
seeded random ones, fed to both packages. Tolerances: IoUs within 1e-6,
match bits exactly equal, counts exactly equal, averages within 1e-6 (and
the hand-derived values within 1e-9, as the reference's goldens hold them).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_mslesseg.evalx import seg_map as jsm
from tpu_mslesseg_torch.evalx import seg_map as tsm

MATCH_CASES = {  # iou [K, I], pred valid [K], gt valid [I]
    "perfect": ([[1.0, 0.0], [0.0, 1.0]], [True, True], [True, True]),
    "claims_once": ([[0.9], [0.85]], [True, True], [True]),
    "smaller_pred_index": ([[0.6], [0.9]], [True, True], [True]),
    "threshold_cut": ([[0.6]], [True], [True]),
    "invalid_gt": ([[0.99]], [True], [False]),
    "ties": ([[0.7, 0.7], [0.7, 0.7], [0.5, 0.7]], [True, True, True], [True, True]),
}


def _match_both(iou, pv, gv):
    iou, pv, gv = (np.asarray(a) for a in (iou, pv, gv))
    want = np.asarray(jsm.match_image(jnp.asarray(iou, jnp.float32), jnp.asarray(pv),
                                      jnp.asarray(gv)))
    got = tsm.match_image(torch.as_tensor(iou, dtype=torch.float32), torch.as_tensor(pv),
                          torch.as_tensor(gv)).numpy()
    return got, want


@pytest.mark.parametrize("case", sorted(MATCH_CASES))
def test_match_image_reference_cases(case):
    got, want = _match_both(*MATCH_CASES[case])
    np.testing.assert_array_equal(got, want)


def test_match_image_random_and_batched():
    rng = np.random.default_rng(7)
    ious, pvs, gvs = [], [], []
    for _ in range(40):
        K, I = rng.integers(1, 12), rng.integers(1, 6)
        iou = rng.uniform(0, 1, (K, I)).astype(np.float32)
        iou[rng.uniform(size=(K, I)) < 0.2] = 0.7  # exact ties
        pv, gv = rng.uniform(0, 1, K) > 0.2, rng.uniform(0, 1, I) > 0.2
        got, want = _match_both(iou, pv, gv)
        np.testing.assert_array_equal(got, want)
        padded = np.zeros((12, 6), np.float32)
        padded[:K, :I] = iou
        ious.append(padded)
        pvs.append(np.pad(pv, (0, 12 - K)))
        gvs.append(np.pad(gv, (0, 6 - I)))
    # a batch at once (the validation step's layout) equals image by image
    batched = tsm.match_image(torch.from_numpy(np.stack(ious)), torch.from_numpy(np.stack(pvs)),
                              torch.from_numpy(np.stack(gvs))).numpy()
    for b in range(len(ious)):
        _, want = _match_both(ious[b], pvs[b], gvs[b])
        np.testing.assert_array_equal(batched[b], want)


def test_box_and_mask_iou_pairs():
    rng = np.random.default_rng(3)
    a = rng.uniform(0, 40, (20, 4)).astype(np.float32)
    b = rng.uniform(0, 40, (5, 4)).astype(np.float32)
    a[:, 2:] += a[:, :2]
    b[:, 2:] += b[:, :2]
    a[3] = b[1]  # an exact overlap
    np.testing.assert_allclose(tsm.box_iou_pairs(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
                               np.asarray(jsm.box_iou_pairs(jnp.asarray(a), jnp.asarray(b))),
                               rtol=0, atol=1e-6)
    pm = rng.uniform(size=(7, 16, 16)) > 0.6
    gm = rng.uniform(size=(3, 16, 16)) > 0.5
    np.testing.assert_allclose(
        tsm.mask_iou_pairs(torch.from_numpy(pm), torch.from_numpy(gm)).numpy(),
        np.asarray(jsm.mask_iou_pairs(jnp.asarray(pm), jnp.asarray(gm))), rtol=0, atol=1e-6)
    one = np.zeros((1, 8, 8)); one[0, :4] = 1
    two = np.zeros((2, 8, 8)); two[0, :4] = 1; two[1, 2:6] = 1
    iou = tsm.mask_iou_pairs(torch.from_numpy(one), torch.from_numpy(two)).numpy()
    assert abs(iou[0, 0] - 1.0) < 1e-6 and abs(iou[0, 1] - 16 / 48) < 1e-6


def _tp_from_ious(ious):
    return np.asarray([[v >= t for t in tsm.IOU_THRESHES] for v in ious], bool)


# (images: [(scores, per-pred iou, n_gt)], hand-derived map50_b or None)
ACC_CASES = {
    "perfect_single": ([([0.9], [1.0], 1)], 0.995),
    "half_recall": ([([0.9], [1.0], 2)], 0.75),
    "fp_before_tp": ([([0.9, 0.8], [0.0, 1.0], 1)], 0.4975),
    "iou_sweep": ([([0.9], [0.78], 1)], 0.995),
    "two_images": ([([0.9], [1.0], 1), ([0.8], [0.0], 1)], 0.6225),
    "random": (None, None),
}


@pytest.mark.parametrize("case", sorted(ACC_CASES))
def test_accumulator_equals_jax(case):
    images, golden = ACC_CASES[case]
    if images is None:
        rng = np.random.default_rng(9)
        images = [(rng.uniform(size=k).tolist(), rng.uniform(0.3, 1.0, size=k).tolist(),
                   int(rng.integers(0, 4))) for k in rng.integers(1, 9, size=12)]
    accs = [jsm.SegMapAccumulator(), tsm.SegMapAccumulator()]
    for scores, ious, n_gt in images:
        tp = _tp_from_ious(ious)
        valid = np.ones(len(scores), bool)
        for acc in accs:
            acc.add_image(np.asarray(scores), valid, tp, tp[:, ::-1].copy(), n_gt)
    want, got = (acc.compute() for acc in accs)
    assert accs[1].n_gt == accs[0].n_gt
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == pytest.approx(want[k], abs=1e-6), k
    if golden is not None:
        assert got["map50_b"] == pytest.approx(golden, abs=1e-9)


def test_average_precision_known_curve_and_empty():
    scores = np.array([0.9, 0.8, 0.7])
    tps = np.zeros((3, 10), bool)
    tps[0, 0] = tps[2, 0] = True
    expected = 0.49 + (1 + 2 / 3) / 2 * 0.01 + 2 / 3 * 0.49 + (2 / 3) / 2 * 0.01
    got = tsm.average_precision(scores, tps, n_gt=2)
    np.testing.assert_allclose(got, jsm.average_precision(scores, tps, n_gt=2), rtol=0, atol=1e-6)
    assert got[0] == pytest.approx(expected, abs=1e-9)
    assert not tsm.average_precision(np.zeros(0), np.zeros((0, 10), bool), 3).any()
    assert tsm.SegMapAccumulator().compute() == jsm.SegMapAccumulator().compute()
    np.testing.assert_array_equal(tsm.IOU_THRESHES, jsm.IOU_THRESHES)
