"""PyTorch port vs the JAX package, module by module, on the CPU.

Inputs come from numpy seeds and go through both packages as numpy arrays.
Tolerances: geometry, enhancement, vote, counts and metrics exact; the
letterbox 1e-6 (the separable resize sums in another order) and its
sampling grid one ulp; decoded boxes
1e-4 (softmax and exp differ in the last ulp between XLA and PyTorch); NMS
keep and indices exact.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_mslesseg.core import geometry as jgeo
from tpu_mslesseg.evalx import metrics as jmx
from tpu_mslesseg.infer import decode as jdec
from tpu_mslesseg.infer import nms as jnms
from tpu_mslesseg.infer import predictor as jpred
from tpu_mslesseg.infer import reconstruct as jrec
from tpu_mslesseg.model import yolo11 as jyolo
from tpu_mslesseg.preproc import enhance as jenh
from tpu_mslesseg_torch.core import geometry as tgeo
from tpu_mslesseg_torch.evalx import metrics as tmx
from tpu_mslesseg_torch.infer import decode as tdec
from tpu_mslesseg_torch.infer import nms as tnms
from tpu_mslesseg_torch.infer import predictor as tpred
from tpu_mslesseg_torch.infer import reconstruct as trec
from tpu_mslesseg_torch.model import yolo11 as tyolo
from tpu_mslesseg_torch.preproc import enhance as tenh
from torch_threads import one_torch_thread  # noqa: F401

VOL_SHAPE = (24, 28, 20)
GOLDENS = Path(__file__).parent / "goldens" / "enhance_goldens.npz"


def _t(x):
    return torch.from_numpy(np.array(x))


# --------------------------------------------------------------------------
# geometry
# --------------------------------------------------------------------------


@pytest.mark.parametrize("plane", ["axial", "coronal", "sagital"])
def test_geometry_matches_jax(plane):
    rng = np.random.default_rng(0)
    vol = rng.normal(size=VOL_SHAPE).astype(np.float32)
    ids = np.array([3, 0, 7, 5])
    assert tgeo.slice_shape(VOL_SHAPE, plane) == jgeo.slice_shape(VOL_SHAPE, plane)
    assert tgeo.plane_axis(plane) == jgeo.plane_axis(plane)
    want = np.asarray(jgeo.extract_slices(vol, plane, ids))
    got = tgeo.extract_slices(_t(vol), plane, ids).numpy()
    np.testing.assert_array_equal(got, want)

    np.testing.assert_array_equal(
        tgeo.to_png_space_batch(_t(want)).numpy(),
        np.asarray(jgeo.to_png_space_batch(want)),
    )
    np.testing.assert_array_equal(
        tgeo.from_png_space_batch(_t(want)).numpy(),
        np.asarray(jgeo.from_png_space_batch(want)),
    )
    np.testing.assert_array_equal(
        tgeo.to_png_space(_t(want[0])).numpy(), np.asarray(jgeo.to_png_space(want[0]))
    )
    np.testing.assert_array_equal(
        tgeo.from_png_space(_t(want[0])).numpy(),
        np.asarray(jgeo.from_png_space(want[0])),
    )


@pytest.mark.parametrize("plane", ["axial", "coronal", "sagital"])
def test_insert_slices_drops_out_of_range_like_xla(plane):
    """Group padding uses the index max(vol_shape): XLA drops those writes,
    and so must the port (torch indexing would raise). A negative index
    counts from the end in both."""
    rng = np.random.default_rng(1)
    axis = jgeo.plane_axis(plane)
    hw = jgeo.slice_shape(VOL_SHAPE, plane)
    size = VOL_SHAPE[axis]
    oob = max(VOL_SHAPE)
    ids = np.array([2, oob, size, -1, 5, -size - 3], np.int64)
    slices = rng.uniform(1, 2, (len(ids),) + hw).astype(np.float32)
    want = np.asarray(jgeo.insert_slices(VOL_SHAPE, slices, plane, ids))
    got = tgeo.insert_slices(VOL_SHAPE, _t(slices), plane, _t(ids)).numpy()
    assert got.shape == VOL_SHAPE
    np.testing.assert_array_equal(got, want)
    # exactly the three in-range slices were written
    written = np.any(got != 0, axis=tuple(i for i in range(3) if i != axis))
    assert sorted(np.nonzero(written)[0]) == sorted({2, size - 1, 5})


# --------------------------------------------------------------------------
# enhancement
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def goldens():
    return np.load(GOLDENS)


@pytest.mark.parametrize("mejora", ["HE", "GC", "LT"])
def test_enhancement_matches_goldens_and_jax(goldens, mejora):
    imgs = goldens["imgs"]
    got = tenh.enhance_batch(_t(imgs), mejora, normalize=False).numpy()
    np.testing.assert_array_equal(got, goldens[mejora])
    want = np.asarray(jenh.enhance_batch(imgs, mejora, normalize=False))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mejora", [None, "HE", "GC", "LT"])
def test_enhance_for_model_matches_jax(mejora):
    rng = np.random.default_rng(2)
    slices = rng.normal(500, 150, (3, 24, 28)).astype(np.float32)
    slices[1] = 7.0  # constant slice: the stretch maps it to 0
    slices[2, :4] += 900.0
    want = np.asarray(jenh.enhance_for_model(jnp.asarray(slices), mejora))
    got = tenh.enhance_for_model(_t(slices), mejora).numpy()
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


def test_normalize_and_he_constant_image_match_jax():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 9, 11)).astype(np.float32) * 1e3
    np.testing.assert_array_equal(
        tenh.normalize_to_uint8(_t(x)).numpy(), np.asarray(jenh.normalize_to_uint8(x))
    )
    np.testing.assert_array_equal(
        tenh.normalize_to_uint8(_t(x[0])).numpy(),
        np.asarray(jenh.normalize_to_uint8(x[0])),
    )
    const = np.full((2, 5, 6), 77, np.uint8)
    np.testing.assert_array_equal(tenh.he_batch(_t(const)).numpy(), const)


def test_clahe_names_its_roadmap_item():
    """ROADMAP B2 is done: CLAHE dispatches to the port's `clahe_batch`
    (held against JAX in tests/test_torch_port_clahe.py); an unknown name
    still raises."""
    assert tenh._KERNELS["CLAHE"] is tenh.clahe_batch
    imgs = np.random.default_rng(0).integers(0, 256, (2, 24, 28), dtype=np.uint8)
    want = np.asarray(jenh.enhance_batch(imgs, "CLAHE", normalize=False))
    got = tenh.enhance_batch(_t(imgs), "CLAHE", normalize=False).numpy()
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        tenh.enhance_batch(torch.zeros((1, 8, 8)), "XYZ")


# --------------------------------------------------------------------------
# letterbox and decode
# --------------------------------------------------------------------------


@pytest.mark.parametrize(
    "src_hw,size", [((28, 24), 64), ((218, 182), 640), ((182, 182), 640), ((24, 20), 64)]
)
def test_letterbox_matches_jax(src_hw, size):
    rng = np.random.default_rng(4)
    imgs = rng.uniform(0, 1, (2,) + src_hw).astype(np.float32)
    jlb = jdec.Letterbox(*src_hw, size=size)
    tlb = tdec.Letterbox(*src_hw, size=size)
    assert (tlb.new_h, tlb.new_w, tlb.pad_top, tlb.pad_left) == (
        jlb.new_h, jlb.new_w, jlb.pad_top, jlb.pad_left,
    )
    want = np.asarray(jlb.apply(jnp.asarray(imgs)))
    got = tlb.apply(_t(imgs)).numpy()
    assert got.shape == want.shape == (2, size, size)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    # the sampling grid, within one ulp of what the reference's compiled
    # program computes (XLA fuses its multiply-add, mostly into one FMA)
    want_grid = jax.jit(jlb.src_centers_in_letterbox)()
    for g, w in zip(tlb.src_centers_in_letterbox(), want_grid):
        np.testing.assert_array_max_ulp(g.numpy(), np.asarray(w), maxulp=1)


def test_decode_matches_jax():
    rng = np.random.default_rng(5)
    imgsz = 64
    a = sum((imgsz // s) ** 2 for s in jdec.STRIDES)
    box_d = (rng.normal(size=(2, a, 64)) * 3).astype(np.float32)
    ja, js = jdec.make_anchors(imgsz, imgsz)
    ta, ts = tdec.make_anchors(imgsz, imgsz)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    want = np.asarray(jdec.decode_boxes(jnp.asarray(box_d), ja, js))
    got = tdec.decode_boxes(_t(box_d), ta, ts).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_bilinear_sample_matches_jax():
    """Sampling the union logits at the inverse-letterbox grid, indices
    clamped at the edges (the grid runs past both ends)."""
    rng = np.random.default_rng(10)
    imgs = rng.normal(size=(3, 16, 16)).astype(np.float32)
    ys = np.linspace(-0.9, 15.7, 28).astype(np.float32)
    xs = np.linspace(-0.4, 15.9, 24).astype(np.float32)
    want = jax.vmap(lambda m: jpred._bilinear_sample(m, ys, xs))(imgs)
    got = tpred._bilinear_sample(_t(imgs), _t(ys), _t(xs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_flatten_level_outputs_matches_jax():
    rng = np.random.default_rng(6)
    out = {
        key: [rng.normal(size=(2, s, s, c)).astype(np.float32) for s in (8, 4, 2)]
        for key, c in (("box", 64), ("cls", 1), ("mcoef", 32))
    }
    want = jdec.flatten_level_outputs(out)
    got = tdec.flatten_level_outputs({k: [_t(x) for x in v] for k, v in out.items()})
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# --------------------------------------------------------------------------
# NMS
# --------------------------------------------------------------------------


def _nms_case(rng, b, a, ties):
    xy = rng.uniform(0, 50, (b, a, 2))
    wh = rng.uniform(4, 30, (b, a, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    # near-duplicates so that suppression chains form
    boxes[:, 1::3] = boxes[:, 0::3][:, : boxes[:, 1::3].shape[1]] + 0.5
    if ties:
        # sigmoid of bf16 logits: few distinct values, exact ties everywhere
        logits = rng.integers(-6, 6, (b, a)).astype(np.float32) / 4
        scores = 1 / (1 + np.exp(-logits))
    else:
        scores = rng.uniform(0, 1, (b, a))
    return boxes, scores.astype(np.float32)


@pytest.mark.parametrize(
    "a,max_det,ties", [(60, 300, True), (400, 300, True), (400, 300, False), (50, 20, True)]
)
def test_nms_matches_jax(a, max_det, ties):
    """Keep and indices equal exactly, including exact score ties (the
    stable sort puts the lower index first, as lax.top_k does) and the
    k < max_det padding."""
    rng = np.random.default_rng(7 + a)
    boxes, scores = _nms_case(rng, 3, a, ties)
    jb, js, jk, ji = jnms.nms_batch(jnp.asarray(boxes), jnp.asarray(scores), 0.25, 0.7, max_det)
    tb, ts, tk, ti = tnms.nms_batch(_t(boxes), _t(scores), 0.25, 0.7, max_det)
    assert tk.shape == (3, max_det) and ti.shape == (3, max_det)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    assert tk.any() and not tk.all()


# --------------------------------------------------------------------------
# vote, counts, metrics
# --------------------------------------------------------------------------


def test_vote_counts_and_metrics_match_jax():
    rng = np.random.default_rng(8)
    vols = [(rng.uniform(size=VOL_SHAPE) > 0.6).astype(np.float32) for _ in range(3)]
    gt = (rng.uniform(size=VOL_SHAPE) > 0.7).astype(np.float32)
    for umbral in (1, 2, 3):
        want = np.asarray(jrec.consensus_vote(*vols, umbral))
        got = trec.consensus_vote(*(_t(v) for v in vols), umbral).numpy()
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, want)
    cons = trec.consensus_vote(*(_t(v) for v in vols), 2)
    jc = np.asarray(jmx._confusion_counts(gt, np.asarray(cons)))
    tc = tmx.confusion_counts(_t(gt), cons)
    np.testing.assert_array_equal(tc.numpy(), jc)
    # batched counts: one row per volume
    batch = tmx.confusion_counts(_t(np.stack([gt, gt])), torch.stack([cons, cons * 0]))
    np.testing.assert_array_equal(batch[0].numpy(), jc)
    np.testing.assert_array_equal(
        batch[1].numpy(), np.asarray(jmx._confusion_counts(gt, np.zeros(VOL_SHAPE)))
    )
    assert tmx.metrics_from_counts(tc) == jmx.metrics_from_counts(jc)
    assert tmx.compute_metrics(_t(gt), cons) == jmx.compute_metrics(gt, np.asarray(cons))
    single = tmx.metrics_from_counts(np.array([0.0, 3.0, 0.0, 5.0]))
    assert np.isnan(single["AUC"])


def test_reconstruct_volume_matches_jax():
    rng = np.random.default_rng(9)
    masks = rng.uniform(size=(3, 24, 20)) > 0.5
    ids = np.array([1, 4, 27])
    want = np.asarray(jrec.reconstruct_volume(VOL_SHAPE, masks, "coronal", ids))
    got = trec.reconstruct_volume(VOL_SHAPE, _t(masks), "coronal", _t(ids)).numpy()
    np.testing.assert_array_equal(got, want)


# --------------------------------------------------------------------------
# model construction
# --------------------------------------------------------------------------

_ENV = ("TPU_MSLESSEG_DTYPE", "TPU_MSLESSEG_SCALE", "TPU_MSLESSEG_IMGSZ")


@pytest.mark.parametrize(
    "env", [{}, {"TPU_MSLESSEG_DTYPE": "float32", "TPU_MSLESSEG_SCALE": "s",
                 "TPU_MSLESSEG_IMGSZ": "320"}]
)
def test_create_model_from_env_resolves_like_jax(monkeypatch, env):
    for k in _ENV:
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    jm, jcfg, jimg = jyolo.create_model_from_env()
    tm, tcfg, timg = tyolo.create_model_from_env()
    assert (tcfg.scale, tcfg.nc, timg) == (jcfg.scale, jcfg.nc, jimg)
    assert str(tm.dtype).removeprefix("torch.") == jnp.dtype(jm.dtype).name
    assert tcfg.head_ch == jcfg.head_ch


def test_fold_gray_stem_equals_three_channel_input():
    model, _ = tyolo.create_model(nc=1, scale="n")
    sd = tyolo.init_variables(model, seed=3)
    x = torch.rand((2, 64, 64, 1), generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        full = torch.func.functional_call(model, sd, (x.expand(-1, -1, -1, 3),))
        folded = tyolo.fold_gray_stem(sd)
        gray = torch.func.functional_call(model, folded, (x,))
    assert folded[tyolo._STEM_KEY].shape[1] == 1 and sd[tyolo._STEM_KEY].shape[1] == 3
    assert tyolo.fold_gray_stem(folded) is folded
    torch.testing.assert_close(gray["proto"], full["proto"], atol=1e-5, rtol=1e-5)
    for lvl in range(3):
        torch.testing.assert_close(gray["cls"][lvl], full["cls"][lvl], atol=1e-5, rtol=1e-5)


def test_init_variables_is_seeded_and_sets_the_class_prior():
    model, cfg = tyolo.create_model(nc=1, scale="n")
    a, b = tyolo.init_variables(model, seed=7), tyolo.init_variables(model, seed=7)
    assert set(a) == set(model.state_dict())
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["model.0.conv.weight"], tyolo.init_variables(model, 8)["model.0.conv.weight"])
    for i, s in enumerate(tyolo.STRIDES):
        assert float(a[f"model.23.cv3.{i}.2.bias"][0]) == pytest.approx(
            tyolo.cls_bias_prior(cfg.nc, s)
        )
    assert bool((a["model.2.cv1.bn.weight"] == 1).all())
    assert bool((a["model.2.cv1.bn.running_var"] == 1).all())
