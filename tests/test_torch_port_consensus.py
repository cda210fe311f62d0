"""The port's model, weight bridge and ConsensusPredictor vs the JAX package.

Small size, as in ``tests/test_consensus3.py``: scale n, imgsz 64, volume
(24, 28, 24), 3 slices per plane, in float32. The weights come from the
JAX model's ``init``, with perturbed batch-norm statistics and a detection
head set so that NMS has work to do (class bias 0.0 and a steep class
kernel, so some anchors fall under the confidence threshold; short DFL
boxes, so masks are cut by their crops), and reach the port through the
bridge.

Tolerances: the forward pass atol 2e-4, rtol 1e-3. The predictor's plane
volumes, consensus and counts must equal JAX's; a voxel may differ only
where JAX's sampled mask logit lies within 1e-3 of the threshold 0, and
the test asserts that for every differing voxel.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_mslesseg.core import geometry as jgeo
from tpu_mslesseg.infer.consensus3 import PLANES
from tpu_mslesseg.infer.consensus3 import ConsensusPredictor as JConsensus
from tpu_mslesseg.infer.predictor import SlicePredictor as JSlicePredictor
from tpu_mslesseg.infer.predictor import _bilinear_sample as j_bilinear
from tpu_mslesseg.model.yolo11 import create_model as j_create
from tpu_mslesseg_torch.infer.consensus3 import ConsensusPredictor as TConsensus
from tpu_mslesseg_torch.infer.predictor import SlicePredictor as TSlicePredictor
from tpu_mslesseg_torch.model.bridge import state_dict_from_reference
from tpu_mslesseg_torch.model.yolo11 import create_model as t_create
from tpu_mslesseg_torch.preproc import enhance as tenh
from torch_threads import one_torch_thread  # noqa: F401


IMGSZ = 64
VOL_SHAPE = (24, 28, 24)
N = 3
OOB = max(VOL_SHAPE)


def _leaves(tree, path=()):
    for name, node in tree.items():
        if isinstance(node, dict):
            yield from _leaves(node, path + (name,))
        else:
            yield path + (name,), tree


def _perturbed(base, seed):
    """Numpy copy of JAX variables with seeded BN statistics and head."""
    rng = np.random.default_rng(seed)
    v = copy.deepcopy(base)
    for path, parent in _leaves(v["batch_stats"]):
        x = parent[path[-1]]
        if path[-1] == "mean":
            parent["mean"] = (x + rng.normal(0, 0.1, x.shape)).astype(np.float32)
        else:
            parent["var"] = (x * rng.uniform(0.5, 1.5, x.shape)).astype(np.float32)
    for path, parent in _leaves(v["params"]):
        if path[-2:] == ("bn", "bias"):
            parent["bias"] = rng.normal(0, 0.3, parent["bias"].shape).astype(np.float32)
    p = v["params"]
    for i in range(3):
        p[f"cls{i}_2"]["kernel"] = p[f"cls{i}_2"]["kernel"] * 100
        p[f"cls{i}_2"]["bias"] = np.zeros_like(p[f"cls{i}_2"]["bias"])
        p[f"box{i}_2"]["kernel"] = p[f"box{i}_2"]["kernel"] * 30
        # DFL logits favour short distances: boxes of a few grid cells
        p[f"box{i}_2"]["bias"] = np.tile(-1.2 * np.arange(16, dtype=np.float32), 4)
    return v


def _volume(seed):
    rng = np.random.default_rng(seed)
    vol = rng.normal(500, 150, VOL_SHAPE).astype(np.float32)
    g = np.mgrid[: VOL_SHAPE[0], : VOL_SHAPE[1], : VOL_SHAPE[2]].astype(np.float32)
    lesion = ((g[0] - 11) / 3.5) ** 2 + ((g[1] - 14) / 4.5) ** 2 + ((g[2] - 12) / 3.5) ** 2 <= 1
    vol[lesion] += 900.0
    return vol, lesion.astype(np.float32)


@pytest.fixture(scope="module")
def case():
    jmodel, _ = j_create(nc=1, scale="n")
    init = jax.jit(lambda k: jmodel.init(k, jnp.zeros((1, IMGSZ, IMGSZ, 3)), train=False))
    base = jax.tree_util.tree_map(np.asarray, init(jax.random.PRNGKey(0)))
    base = {c: jax.tree_util.tree_map(lambda x: x, dict(base[c])) for c in base}
    shared = _perturbed(base, 1)
    per_plane = {p: _perturbed(base, 2 + i) for i, p in enumerate(PLANES)}
    tmodel, _ = t_create(nc=1, scale="n")
    to_sd = lambda v: state_dict_from_reference(v, tmodel)
    ids = np.arange(10, 10 + N)
    vol_a, gt = _volume(0)
    vol_b, _ = _volume(1)
    pats = []
    for vol in (vol_a, vol_b):
        pats.append({p: np.array(jgeo.extract_slices(vol, p, ids)) for p in PLANES})
    return {
        "jmodel": jmodel, "tmodel": tmodel, "gt": gt, "ids": ids, "pats": pats,
        "jvars": {"shared": shared, "per_plane": per_plane},
        "tvars": {
            "shared": to_sd(shared),
            "per_plane": {p: to_sd(v) for p, v in per_plane.items()},
        },
    }


# --------------------------------------------------------------------------
# bridge and forward
# --------------------------------------------------------------------------


def test_bridge_sets_every_parameter_and_forward_matches_jax(case):
    tmodel = case["tmodel"]
    sd = case["tvars"]["shared"]
    assert set(sd) == set(tmodel.state_dict())
    tmodel.load_state_dict(sd, strict=True)
    x = np.random.default_rng(5).uniform(0, 1, (2, IMGSZ, IMGSZ, 3)).astype(np.float32)
    want = jax.jit(lambda v, a: case["jmodel"].apply(v, a, train=False))(
        case["jvars"]["shared"], x
    )
    with torch.no_grad():
        got = tmodel(torch.from_numpy(x))
    for key in ("box", "cls", "mcoef"):
        for lvl in range(3):
            g, w = got[key][lvl].numpy(), np.asarray(want[key][lvl])
            assert g.shape == w.shape
            np.testing.assert_allclose(g, w, atol=2e-4, rtol=1e-3, err_msg=f"{key}{lvl}")
    np.testing.assert_allclose(
        got["proto"].numpy(), np.asarray(want["proto"]), atol=2e-4, rtol=1e-3
    )


def test_bridge_refuses_unknown_and_missing_leaves(case):
    tmodel = case["tmodel"]
    extra = copy.deepcopy(case["jvars"]["shared"])
    extra["params"]["b0"]["conv"]["stray"] = np.zeros(3, np.float32)
    with pytest.raises(KeyError):
        state_dict_from_reference(extra, tmodel)
    missing = copy.deepcopy(case["jvars"]["shared"])
    del missing["batch_stats"]["b9"]
    with pytest.raises(ValueError, match="missing"):
        state_dict_from_reference(missing, tmodel)


@pytest.mark.parametrize("plane", ["axial", "coronal"])
def test_slice_predictor_matches_jax(case, plane):
    imgs = tenh.enhance_for_model(torch.from_numpy(case["pats"][0][plane]), "GC")
    hw = tuple(imgs.shape[1:])
    want = JSlicePredictor(case["jmodel"], case["jvars"]["shared"], hw, imgsz=IMGSZ)(
        jnp.asarray(imgs.numpy())
    )
    got = TSlicePredictor(case["tmodel"], case["tvars"]["shared"], hw, imgsz=IMGSZ,
                          device="cpu")(imgs)
    assert got.dtype == torch.bool and tuple(got.shape) == tuple(want.shape)
    assert bool(got.any()) and not bool(got.all())
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# --------------------------------------------------------------------------
# ConsensusPredictor
# --------------------------------------------------------------------------


def _scatter_np(sampled, ids, plane):
    """[n, h, w] sampled logits -> volume (NaN where no slice, OOB dropped)."""
    axis = jgeo.plane_axis(plane)
    out = np.full(VOL_SHAPE, np.nan, np.float32)
    moved = np.moveaxis(out, axis, 0)
    for s, i in zip(sampled, ids):
        if 0 <= i < VOL_SHAPE[axis]:
            moved[i] = s
    return out


def _jax_logit_volumes(jcp, slices_flat, idx, n_pat):
    """JAX's sampled union logits per plane, scattered like its masks:
    {plane: [n_pat, X, Y, Z]}."""
    union = np.asarray(
        jax.jit(lambda v, s: jcp._union_logits(v, s)[0])(jcp.variables, slices_flat)
    )
    out, start = {}, 0
    for p in PLANES:
        n = slices_flat[p].shape[0]
        ys, xs = jcp.lb[p].src_centers_in_letterbox()
        ys = (ys + 0.5) / 4.0 - 0.5
        xs = (xs + 0.5) / 4.0 - 0.5
        sampled = jax.vmap(lambda m: j_bilinear(m, ys, xs))(union[start : start + n])
        sampled = np.asarray(jgeo.from_png_space_batch(sampled))
        start += n
        sampled = sampled.reshape((n_pat, -1) + sampled.shape[1:])
        out[p] = np.stack([_scatter_np(s, i, p) for s, i in zip(sampled, idx[p])])
    return out


def _counts_np(gt, vol):
    t, p = gt > 0, vol > 0
    return np.array([(t & p).sum(), (~t & p).sum(), (t & ~p).sum(), (~t & ~p).sum()],
                    np.float32)


def _assert_matches_jax(jout, tout, logits_fn, gts):
    """Plane volumes, consensus and counts equal; a differing voxel only
    where JAX's sampled logit is within 1e-3 of the threshold 0."""
    jcounts, jcons, jvols = jout
    tcounts, tcons, tvols = tout
    differ = np.zeros(np.shape(jcons), bool)
    for p in PLANES:
        a, b = np.asarray(jvols[p]), tvols[p].numpy()
        assert a.shape == b.shape
        d = a != b
        if d.any():
            near = np.abs(logits_fn()[p].reshape(a.shape)[d])
            assert np.all(near < 1e-3), (p, int(d.sum()), near.max())
            differ |= d
    jc, tc = np.asarray(jcons), tcons.numpy()
    assert tc.dtype == jc.dtype
    np.testing.assert_array_equal(tc[~differ], jc[~differ])
    jcounts = {k: np.asarray(v) for k, v in jcounts.items()}
    tcounts = {k: v.numpy() for k, v in tcounts.items()}
    assert set(tcounts) == set(jcounts) == set(PLANES) | {"consenso"}
    if not differ.any():
        for k in jcounts:
            np.testing.assert_array_equal(tcounts[k], jcounts[k], err_msg=k)
        return
    # the counts then follow each side's own volumes exactly
    gts = np.reshape(gts, (-1,) + VOL_SHAPE)
    for p in PLANES:
        got = np.reshape(tvols[p].numpy(), (-1,) + VOL_SHAPE)
        want = np.stack([_counts_np(g, v) for g, v in zip(gts, got)])
        np.testing.assert_array_equal(np.reshape(tcounts[p], want.shape), want)


@pytest.mark.parametrize(
    "mejora,weights",
    [("GC", "shared"), (None, "shared"), ("GC", "per_plane"), ("CLAHE", "per_plane")],
)
def test_consensus_call_matches_jax(case, mejora, weights):
    pat = case["pats"][0]
    idx = {p: case["ids"] for p in PLANES}
    kw = dict(mejora=mejora, imgsz=IMGSZ, umbral=2, per_plane_counts=True)
    jcp = JConsensus(case["jmodel"], case["jvars"][weights], VOL_SHAPE, **kw)
    tcp = TConsensus(case["tmodel"], case["tvars"][weights], VOL_SHAPE, device="cpu", **kw)
    jout = jcp({p: jnp.asarray(s) for p, s in pat.items()}, idx, jnp.asarray(case["gt"]))
    tout = tcp(pat, idx, case["gt"])
    assert int(tout[1].sum()) > 0 and not bool(tout[1].all())  # masks are mixed
    _assert_matches_jax(
        jout, tout,
        lambda: {p: v[0] for p, v in _jax_logit_volumes(
            jcp, pat, {p: [case["ids"]] for p in PLANES}, 1).items()},
        case["gt"],
    )


@pytest.mark.parametrize("weights", ["shared", "per_plane"])
def test_consensus_lote_with_padded_group_matches_jax(case, weights):
    _check_padded_lote(case, "GC", weights)


def test_consensus_lote_clahe_per_plane_matches_jax(case):
    _check_padded_lote(case, "CLAHE", "per_plane")


def _check_padded_lote(case, mejora, weights):
    """Two patients in one call; the second serves N-1 slices, padded to N
    with a blank slice and the out-of-range index max(vol_shape)."""
    a, b = case["pats"]
    ids = case["ids"]
    slices = {
        p: np.stack([a[p], np.concatenate([b[p][:-1], np.zeros_like(b[p][:1])])])
        for p in PLANES
    }
    idx = {p: np.stack([ids, np.concatenate([ids[:-1], [OOB]])]) for p in PLANES}
    gts = np.stack([case["gt"], case["gt"]])
    kw = dict(mejora=mejora, imgsz=IMGSZ, umbral=2, per_plane_counts=True)
    jcp = JConsensus(case["jmodel"], case["jvars"][weights], VOL_SHAPE, **kw)
    tcp = TConsensus(case["tmodel"], case["tvars"][weights], VOL_SHAPE, device="cpu", **kw)
    jout = jcp.lote({p: jnp.asarray(s) for p, s in slices.items()}, idx, jnp.asarray(gts))
    tout = tcp.lote(slices, idx, gts)
    for p in PLANES:
        assert tout[2][p].shape == (2,) + VOL_SHAPE
    flat = {p: s.reshape((-1,) + s.shape[2:]) for p, s in slices.items()}
    _assert_matches_jax(jout, tout, lambda: _jax_logit_volumes(jcp, flat, idx, 2), gts)
    if weights == "shared":
        # the logits that excuse a differing voxel are the ones JAX thresholded
        logits = _jax_logit_volumes(jcp, flat, idx, 2)
        for p in PLANES:
            seen = ~np.isnan(logits[p])
            np.testing.assert_array_equal(
                (logits[p] > 0)[seen], np.asarray(jout[2][p])[seen] > 0
            )
            assert not np.asarray(jout[2][p])[~seen].any()

    # the padded slot wrote nothing: patient b equals its own unpadded call
    short = tcp({p: b[p][:-1] for p in PLANES}, {p: ids[:-1] for p in PLANES}, case["gt"])
    for p in PLANES:
        np.testing.assert_array_equal(tout[2][p][1].numpy(), short[2][p].numpy())
        np.testing.assert_array_equal(tout[0][p][1].numpy(), short[0][p].numpy())
    np.testing.assert_array_equal(tout[1][1].numpy(), short[1].numpy())


def test_consensus_lote_multimodal_matches_jax(case):
    """The CLI's multimodal serving (``--modalidad T1 FLAIR``): each plane's
    forward holds both modalities' slices, and a voxel is set where either
    modality's mask is. Two patients, the second padded, GC, one set of
    weights (one forward of every plane's and modality's slices). A voxel
    may differ only where one modality's JAX logit lies within 1e-3 of the
    threshold."""
    a, b = case["pats"]
    ids = case["ids"]
    mods = {"T1": lambda s: -s + 2000.0, "FLAIR": lambda s: s}  # T1: the lesion dark
    stack = lambda p, f: np.stack(
        [f(a[p]), np.concatenate([f(b[p][:-1]), np.zeros_like(b[p][:1])])])
    slices = {p: {m: stack(p, f) for m, f in mods.items()} for p in PLANES}
    idx = {p: np.stack([ids, np.concatenate([ids[:-1], [OOB]])]) for p in PLANES}
    gts = np.stack([case["gt"], case["gt"]])
    kw = dict(mejora="GC", imgsz=IMGSZ, umbral=2, per_plane_counts=True)
    jcp = JConsensus(case["jmodel"], case["jvars"]["shared"], VOL_SHAPE, **kw)
    tcp = TConsensus(case["tmodel"], case["tvars"]["shared"], VOL_SHAPE, device="cpu", **kw)
    jout = jcp.lote({p: {m: jnp.asarray(v) for m, v in s.items()} for p, s in slices.items()},
                    idx, jnp.asarray(gts))
    tout = tcp.lote(slices, idx, gts)
    for p in PLANES:
        assert tout[2][p].shape == (2,) + VOL_SHAPE

    def nearest_logits():
        """Per voxel, the modality's JAX logit nearest the threshold."""
        per_mod = [_jax_logit_volumes(
            jcp, {p: s[m].reshape((-1,) + s[m].shape[2:]) for p, s in slices.items()}, idx, 2)
            for m in mods]
        return {p: np.where(np.abs(per_mod[0][p]) <= np.abs(per_mod[1][p]),
                            per_mod[0][p], per_mod[1][p]) for p in PLANES}

    _assert_matches_jax(jout, tout, nearest_logits, gts)
    # and the port's own single-modality calls, OR'd
    singles = {m: tcp.lote({p: s[m] for p, s in slices.items()}, idx, gts)[2] for m in mods}
    for p in PLANES:
        assert bool(tout[2][p].any())
        assert torch.equal(tout[2][p], torch.maximum(singles["T1"][p], singles["FLAIR"][p]))
