"""NMS (``infer/nms.py``) against the JAX package's, on the CPU.

On a CPU tensor ``nms_batch`` suppresses through ``suppress``, which takes
the plain version ``suppress_ref``: the reference's fixpoint, run from the
host. The kernel (``csrc/nms.cu``) computes the same keep on the card and is
held against ``suppress_ref`` there by ``tests/test_torch_port_cuda.py``.
Inputs are seeded numpy arrays (``tools/nms_cases.py``): the served shape
(8,400 anchors, K = 300), deep suppression chains, score ties, k < max_det,
conf 0.001 and pairs of boxes at, one ulp above and one ulp below the IoU
threshold. Tolerance: exact equality of keep, indices, boxes and scores.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_mslesseg.infer import nms as jnms
from tpu_mslesseg_torch.infer import nms
from tpu_mslesseg_torch.tools import nms_cases


def _case(name):
    """-> (boxes, scores, conf, iou, max_det)"""
    if name == "served_shape":
        return (*nms_cases.clustered(0, 4, 8400), 0.25, 0.7, 300)
    if name.startswith("chain_"):
        return (*nms_cases.chain(int(name[6:]), 8400), 0.25, 0.7, 300)
    if name == "ties_partly_valid":
        return (*nms_cases.clustered(1, 4, 400), 0.25, 0.7, 300)
    if name == "distinct_scores":
        return (*nms_cases.clustered(2, 4, 400, ties=False), 0.25, 0.7, 300)
    if name == "k_below_max_det":
        return (*nms_cases.clustered(3, 4, 50), 0.25, 0.7, 300)
    if name == "conf_0.001":
        return (*nms_cases.clustered(4, 4, 400), 0.001, 0.7, 300)
    if name == "none_valid":
        return (*nms_cases.clustered(5, 2, 400), 0.9999, 0.7, 300)
    if name.startswith("threshold_"):
        thr = float(name[10:])
        return (*nms_cases.threshold_pairs(thr, 12, 6)[:2], 0.25, thr, 300)
    raise KeyError(name)


CASES = ("served_shape", "chain_40", "chain_250", "ties_partly_valid", "distinct_scores",
         "k_below_max_det", "conf_0.001", "none_valid", "threshold_0.7", "threshold_0.3")


@pytest.mark.parametrize("name", CASES)
def test_nms_batch_matches_jax(name):
    boxes, scores, conf, iou, max_det = _case(name)
    want = jnms.nms_batch(jnp.asarray(boxes), jnp.asarray(scores), conf, iou, max_det)
    before = nms.LAUNCHES
    got = nms.nms_batch(torch.from_numpy(boxes), torch.from_numpy(scores), conf, iou, max_det)
    assert nms.LAUNCHES == before  # the CPU takes the plain version
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    keep = got[2].numpy()
    if name == "none_valid":
        assert not keep.any()
    else:
        assert keep.any() and not keep.all()


@pytest.mark.parametrize("depth", [40, 250])
def test_a_chain_keeps_every_second_box_after_a_step_a_link(depth):
    """The chain cases are deep: the fixpoint runs about one step a link,
    and the greedy result keeps every second box of the row."""
    boxes, scores = nms_cases.chain(depth, 300)
    keep, steps = nms.suppress_ref_steps(torch.from_numpy(boxes),
                                         torch.from_numpy(scores > 0.25), 0.7)
    assert steps >= depth
    np.testing.assert_array_equal(keep[0, :depth].numpy(), np.arange(depth) % 2 == 0)


@pytest.mark.parametrize("thr", [0.7, 0.3, 0.45])
def test_threshold_pairs_sit_at_and_beside_the_threshold(thr):
    """The pairs' IoU, as ``box_iou_matrix`` rounds it, is the float32
    threshold, one ulp above or one ulp below; only those above suppress.
    At 0.3 float32 rounds the threshold up, so comparing in float64 would
    suppress the pairs at it."""
    boxes, _, ious = nms_cases.threshold_pairs(thr, 12, 6)
    iou = nms.box_iou_matrix(torch.from_numpy(boxes))[0]
    np.testing.assert_array_equal(iou[1::2, 0::2].diagonal().numpy(), ious)
    t = np.float32(thr)
    assert set(ious.tolist()) == {float(t), float(np.nextafter(t, 2)), float(np.nextafter(t, -1))}
    keep = nms.suppress_ref(torch.from_numpy(boxes), torch.ones((1, 24), dtype=torch.bool), thr)
    np.testing.assert_array_equal(keep[0, 1::2].numpy(), ious <= t)
    assert keep[0, 0::2].all()


@pytest.mark.parametrize("name", ["served_shape", "chain_250", "conf_0.001", "threshold_0.3"])
def test_suppress_ref_matches_jax_nms_single(name):
    """The plain suppression alone on the JAX package's own candidates:
    ``nms_single``'s top boxes and validity in, its keep out."""
    boxes, scores, conf, iou, max_det = _case(name)
    for n in range(boxes.shape[0]):
        jb, js, jk, _ = jnms.nms_single(jnp.asarray(boxes[n]), jnp.asarray(scores[n]), conf, iou,
                                        max_det=max_det)
        k = min(max_det, boxes.shape[1])
        top = torch.from_numpy(np.array(jb)[None, :k])
        valid = torch.from_numpy(np.asarray(js)[None, :k] > np.float32(conf))
        got = nms.suppress_ref(top, valid, iou)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(jk)[:k])


def test_suppress_checks_its_inputs():
    boxes, scores = nms_cases.clustered(0, 2, 64)
    top = torch.from_numpy(boxes[:, :40])
    valid = torch.from_numpy(scores[:, :40] > 0.25)
    before = nms.LAUNCHES
    assert torch.equal(nms.suppress(top, valid, 0.7), nms.suppress_ref(top, valid, 0.7))
    assert nms.LAUNCHES == before
    with pytest.raises(ValueError, match="no kernel for device meta"):
        nms.suppress(top.to("meta"), valid.to("meta"), 0.7)
    over = nms.MAX_K + 1
    with pytest.raises(ValueError, match=f"at most {nms.MAX_K}"):
        nms.suppress(torch.zeros((1, over, 4)), torch.ones((1, over), dtype=torch.bool), 0.7)
    with pytest.raises(ValueError, match=f"at most {nms.MAX_K}"):
        nms.nms_batch(torch.zeros((1, over, 4)), torch.ones((1, over)), 0.25, 0.7, over)
    with pytest.raises(TypeError):
        nms.suppress(top.double(), valid, 0.7)
    with pytest.raises(TypeError):
        nms.suppress(top, valid.float(), 0.7)
    with pytest.raises(ValueError):
        nms.suppress(top, valid[:, :30], 0.7)
    with pytest.raises(ValueError):
        nms.suppress(top[..., :3], valid, 0.7)


# --------------------------------------------------------------------------
# The kernel's comparison without the division (csrc/nms.cu, its note)
# --------------------------------------------------------------------------


def _fma32(a, b, c):
    """float32 ``fma(a, b, c)``: a * b + c rounded once. The float64 product
    is exact; the float64 sum's rounding error (TwoSum) decides the one case
    where rounding the sum to float64 first would round again, a sum that
    lands on a float32 midpoint."""
    p = a.astype(np.float64) * b.astype(np.float64)
    cc = c.astype(np.float64)
    with np.errstate(invalid="ignore", over="ignore"):
        s = p + cc
        bb = s - p
        err = (p - (s - bb)) + (cc - bb)
        r = s.astype(np.float32)
        toward = np.where(s > r.astype(np.float64), np.float32(np.inf), np.float32(-np.inf))
        other = np.nextafter(r, toward)
        midpoint = (r.astype(np.float64) + other.astype(np.float64)) / 2 == s
        up = np.where(err > 0, np.maximum(r, other), np.minimum(r, other))
    return np.where(midpoint & (err != 0) & np.isfinite(s), up, r)


def _screened(inter, uni, thr):
    """The kernel's rule for ``inter / uni > thr`` in float32, thr in [2^-60,
    1]: d = fma(-thr, uni, inter) against hu = h * uni, h half an ulp of thr.
    -> (above, tie): above where d > hu, undecided (the kernel divides) where
    d == hu."""
    t = np.float32(thr)
    h = (np.nextafter(t, np.float32(np.inf)) - t) * np.float32(0.5)
    d = _fma32(np.full_like(uni, -t), uni, inter)
    hu = h * uni
    return d > hu, d == hu


def _inter_union(a, b):
    """float32 intersection and clamped union of box pairs, in
    ``box_iou_matrix``'s order of operations."""
    zero = np.float32(0)
    with np.errstate(invalid="ignore", over="ignore"):
        area_a = np.maximum(a[:, 2] - a[:, 0], zero) * np.maximum(a[:, 3] - a[:, 1], zero)
        area_b = np.maximum(b[:, 2] - b[:, 0], zero) * np.maximum(b[:, 3] - b[:, 1], zero)
        w = np.maximum(np.minimum(a[:, 2], b[:, 2]) - np.maximum(a[:, 0], b[:, 0]), zero)
        h = np.maximum(np.minimum(a[:, 3], b[:, 3]) - np.maximum(a[:, 1], b[:, 1]), zero)
        inter = w * h
        return inter, np.maximum((area_a + area_b) - inter, np.float32(1e-7))


def _divided(inter, uni, thr):
    with np.errstate(invalid="ignore", divide="ignore", over="ignore"):
        return inter / uni > np.float32(thr)


def _seeded_pairs(seed: int, n: int):
    """n float32 (inter, uni) pairs: a third from random box pairs (most
    disjoint or far from any threshold), two thirds with inter / uni within
    a few ulps of 0.3, 0.45 or 0.7 (where one rounding more or less flips
    the answer), and the special values: zero, NaN, infinities."""
    rng = np.random.default_rng(seed)
    m = n // 3
    xy = rng.uniform(0, 600, (2, m, 2)).astype(np.float32)
    wh = rng.uniform(1, 200, (2, m, 2)).astype(np.float32)
    inter_r, uni_r = _inter_union(np.concatenate([xy[0], xy[0] + wh[0]], 1),
                                  np.concatenate([xy[1], xy[1] + wh[1]], 1))
    uni_t = np.float32(10) ** rng.uniform(-6, 6, n - m).astype(np.float32)
    t = rng.choice(np.float32([0.3, 0.45, 0.7]), n - m)
    ulps = rng.integers(-3, 4, n - m)
    inter_t = (t.astype(np.float64) * uni_t * (1 + ulps * 2.0 ** -24)).astype(np.float32)
    special = np.float32([0, np.nan, np.inf, -np.inf, 1e-7, 3e38])
    inter_s, uni_s = (g.ravel() for g in np.meshgrid(special, special))
    inter = np.concatenate([inter_r, inter_t, inter_s])
    uni = np.concatenate([uni_r, uni_t, np.maximum(uni_s, np.float32(1e-7))])
    return inter, uni


def _near_ties(thr, count: int, seed: int):
    """`count` pairs whose inter / uni lies as near the midpoint m between
    float32 thr and the next float up as float32 allows:
    uni's significand makes m * uni a few units of its last place from a
    float (m's significand is odd, so it has an inverse mod 2^25), and
    inter is that float."""
    rng = np.random.default_rng(seed)
    sig, e = np.frexp(np.float64(np.float32(thr)))
    m_sig = 2 * int(sig * 2 ** 24) + 1  # m = m_sig * 2^(e - 25)
    inv = pow(m_sig, -1, 2 ** 25)
    sigs = [u for c in range(1, 4 * count) for u in ((c * inv) % 2 ** 25, (-c * inv) % 2 ** 25)
            if 2 ** 23 <= u < 2 ** 24][:count]
    uni = (np.array(sigs, np.float64) * 2.0 ** rng.integers(-34, -4, len(sigs))).astype(np.float32)
    inter = (m_sig * 2.0 ** (e - 25) * uni.astype(np.float64)).astype(np.float32)
    return inter, uni


@pytest.mark.parametrize("thr", [0.7, 0.3, 0.45])
def test_division_free_comparison_equals_the_division(thr):
    """Every pair the rule decides, it decides as ``inter / uni > thr`` in
    float32 does: on the pairs at, one ulp above and one ulp below the
    threshold, and on 10^6 seeded pairs (a third of them within three ulps
    of a threshold), and on pairs built to sit next to the rounding's
    midpoint. Ties, which the kernel leaves to the division, stay rare; a
    float32 ``inter > thr * uni`` would get pairs near the threshold
    wrong."""
    boxes, _, ious = nms_cases.threshold_pairs(thr, 30, 7)
    inter, uni = _inter_union(boxes[0, 0::2], boxes[0, 1::2])
    above, tie = _screened(inter, uni, thr)
    np.testing.assert_array_equal(_divided(inter, uni, thr), ious > np.float32(thr))
    assert not tie.any()
    np.testing.assert_array_equal(above, ious > np.float32(thr))

    inter, uni = _seeded_pairs(int(thr * 100), 1_000_000)
    above, tie = _screened(inter, uni, thr)
    want = _divided(inter, uni, thr)
    np.testing.assert_array_equal(above[~tie], want[~tie])
    assert tie.sum() < 1e-3 * len(tie)

    inter, uni = _near_ties(thr, 400, int(thr * 100))
    above, tie = _screened(inter, uni, thr)
    want = _divided(inter, uni, thr)
    np.testing.assert_array_equal(above[~tie], want[~tie])
    with np.errstate(invalid="ignore", over="ignore"):
        naive = inter > np.float32(thr) * uni
    assert (naive != want).any()
