"""The port's CIoU and task-aligned assigner against the reference's.

Float32 on the CPU, inputs from a seed with numpy. ``fg_mask`` and
``target_gt_idx`` must be equal exactly, on random inputs and on tie-heavy
ones (predictions far from every ground truth, so that most metrics are
exact zeros and the top-k falls back on the lowest index); target boxes are
gathered ground-truth values (equal exactly) and the soft scores agree at
atol 1e-6 (``pow`` and ``atan`` of two libraries, one float32 ulp apart).
The same functions in float64 are held against the numpy transcription of
ultralytics in ``tests/ultralytics_np.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import ultralytics_np as unp  # tests/ is on sys.path under pytest

from tpu_mslesseg.train import assigner as jas
from tpu_mslesseg_torch.infer import decode as dec
from tpu_mslesseg_torch.train import assigner as tas

IMGSZ = 160


def _anchor_points():
    anchors, strides = dec.make_anchors(IMGSZ, IMGSZ)
    return (anchors * strides).numpy().astype(np.float64)


def _boxes(rng, n):
    a = rng.uniform(0, 600, (n, 4))
    a = np.concatenate([np.minimum(a[:, :2], a[:, 2:]), np.maximum(a[:, :2], a[:, 2:])], 1)
    a[:4, 2:] = a[:4, :2]  # a few degenerate boxes
    return a


def _case(rng, kind, B=3, M=8, nc=1):
    """A random assignment problem: half the ground truths lesion-sized.
    ``random``: predictions around their anchors, some images with boxes
    anywhere. ``tie_heavy``: every image's predictions anywhere, so that few
    anchors have a positive metric, and image 0's first ground truth is a
    box in the top-left corner, where the zero-metric ties land."""
    anc = _anchor_points()
    A = anc.shape[0]
    strides = np.repeat([8.0, 16.0, 32.0], [(IMGSZ // s) ** 2 for s in (8, 16, 32)])[:, None]
    gt_bboxes = np.zeros((B, M, 4))
    gt_valid = np.zeros((B, M), bool)
    for b in range(B):
        for m in range(rng.integers(1, M + 1)):
            w, h = rng.uniform(2, 14 if rng.random() < 0.5 else 90, 2)
            cx, cy = rng.uniform(w / 2, IMGSZ - w / 2), rng.uniform(h / 2, IMGSZ - h / 2)
            gt_bboxes[b, m] = [cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2]
            gt_valid[b, m] = True
    if kind == "tie_heavy":
        gt_bboxes[0, 0] = [0.5, 0.5, 60.0, 60.0]
    ltrb = np.abs(rng.normal(2.0, 2.0, (B, A, 4)))
    pd_boxes = np.concatenate([anc - ltrb[..., :2] * strides, anc + ltrb[..., 2:] * strides], -1)
    for b in range(B):
        if kind == "tie_heavy" or rng.random() < 0.4:
            c, wh = rng.uniform(0, IMGSZ, (A, 2)), rng.uniform(1, 30, (A, 2))
            pd_boxes[b] = np.concatenate([c - wh / 2, c + wh / 2], -1)
    pd_scores = 1 / (1 + np.exp(-rng.normal(-2.0, 1.5, (B, A, nc))))
    return pd_scores, pd_boxes, anc, np.zeros((B, M), np.int64), gt_bboxes, gt_valid


def _quirk_case():
    """One ground truth in the top-left corner and every prediction far from
    it: all its metrics are zero, and its top-k is the ten lowest anchors."""
    anc = _anchor_points()
    gt = np.zeros((1, 2, 4))
    gt[0, 0] = [0.5, 0.5, 60.0, 60.0]
    gv = np.array([[True, False]])
    pd_boxes = np.tile(np.array([150.0, 150.0, 158.0, 158.0]), (1, anc.shape[0], 1))
    return np.full((1, anc.shape[0], 1), 0.5), pd_boxes, anc, np.zeros((1, 2), np.int64), gt, gv


def _torch_assign(case, dtype):
    ps, pb, anc, gl, gb, gv = case
    t = lambda a: torch.from_numpy(np.asarray(a)).to(dtype)
    out = tas.assign(t(ps), t(pb), t(anc), torch.from_numpy(gl), t(gb), torch.from_numpy(gv))
    return {k: v.numpy() for k, v in out.items()}


def _jax_assign(case, dtype):
    ps, pb, anc, gl, gb, gv = case
    j = lambda a: jnp.asarray(a, dtype)
    out = jas.assign(j(ps), j(pb), j(anc), jnp.asarray(gl, jnp.int32), j(gb), jnp.asarray(gv))
    return jax.tree_util.tree_map(np.asarray, out)


@pytest.mark.parametrize("seed", range(3))
def test_ciou_matches_reference(seed):
    rng = np.random.default_rng(seed)
    a, b = _boxes(rng, 256).astype(np.float32), _boxes(rng, 256).astype(np.float32)
    got = tas.bbox_iou_ciou(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    want = np.asarray(jas.bbox_iou_ciou(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    # broadcast as the assigner calls it: [M, 1, 4] against [1, A, 4]
    got = tas.bbox_iou_ciou(torch.from_numpy(a[:8, None]), torch.from_numpy(b[None])).numpy()
    want = np.asarray(jas.bbox_iou_ciou(jnp.asarray(a[:8, None]), jnp.asarray(b[None])))
    assert got.shape == want.shape == (8, 256)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_ciou_matches_ultralytics_in_float64():
    rng = np.random.default_rng(5)
    for _ in range(20):
        a, b = _boxes(rng, 64), _boxes(rng, 64)
        got = tas.bbox_iou_ciou(torch.from_numpy(a), torch.from_numpy(b)).numpy()
        np.testing.assert_allclose(got, unp.bbox_iou_ciou(a, b), rtol=1e-12, atol=1e-12)


def test_ciou_gradient_stops_at_alpha():
    """The gradient of the CIoU with respect to both boxes equals the
    reference's, whose ``alpha`` is behind a stop_gradient; with ``alpha``
    differentiated it is another gradient."""
    rng = np.random.default_rng(9)
    a, b = _boxes(rng, 64)[4:].astype(np.float32), _boxes(rng, 64)[4:].astype(np.float32)
    ta, tb = (torch.from_numpy(x).requires_grad_() for x in (a, b))
    tas.bbox_iou_ciou(ta, tb).sum().backward()
    ja, jb = jax.grad(lambda x, y: jas.bbox_iou_ciou(x, y).sum(), argnums=(0, 1))(
        jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_allclose(ta.grad.numpy(), np.asarray(ja), rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(tb.grad.numpy(), np.asarray(jb), rtol=1e-4, atol=1e-7)

    def v_alpha_attached(box1, box2, eps=1e-7):
        """The CIoU's aspect term ``v * alpha`` with `alpha` differentiated."""
        (x1, y1, x2, y2), (u1, v1, u2, v2) = box1.unbind(-1), box2.unbind(-1)
        w1, h1, w2, h2 = x2 - x1, y2 - y1 + eps, u2 - u1, v2 - v1 + eps
        inter = (torch.minimum(x2, u2) - torch.maximum(x1, u1)).clamp(min=0) * (
            torch.minimum(y2, v2) - torch.maximum(y1, v1)).clamp(min=0)
        iou = inter / (w1 * h1 + w2 * h2 - inter + eps)
        v = (4 / torch.pi**2) * (torch.atan(w2 / h2) - torch.atan(w1 / h1)) ** 2
        alpha = v / (v - iou + (1 + eps))
        return v * alpha, v * alpha.detach()

    tc, td = (torch.from_numpy(a).requires_grad_() for _ in range(2))
    v_alpha_attached(tc, torch.from_numpy(b))[0].sum().backward()
    v_alpha_attached(td, torch.from_numpy(b))[1].sum().backward()
    # so the comparison above would notice a missing detach
    assert float((tc.grad - td.grad).abs().max()) > 1e-4


@pytest.mark.parametrize("kind", ["random", "tie_heavy"])
@pytest.mark.parametrize("seed", range(6))
def test_assign_matches_reference(seed, kind):
    case = _case(np.random.default_rng(seed * 7 + (kind == "tie_heavy")), kind)
    got, want = _torch_assign(case, torch.float32), _jax_assign(case, jnp.float32)
    np.testing.assert_array_equal(got["fg_mask"], want["fg_mask"])
    np.testing.assert_array_equal(got["target_gt_idx"], want["target_gt_idx"])
    np.testing.assert_array_equal(got["target_bboxes"], want["target_bboxes"])
    np.testing.assert_allclose(got["target_scores"], want["target_scores"], atol=1e-6, rtol=0)
    assert got["fg_mask"].sum() > 0
    if kind == "tie_heavy":  # foreground anchors that a zero metric claimed
        assert (got["target_scores"][got["fg_mask"]] == 0).any()


def test_assign_zero_metric_ties_take_the_lowest_anchors():
    case = _quirk_case()
    got, want = _torch_assign(case, torch.float32), _jax_assign(case, jnp.float32)
    np.testing.assert_array_equal(got["fg_mask"], want["fg_mask"])
    np.testing.assert_array_equal(got["target_gt_idx"], want["target_gt_idx"])
    np.testing.assert_array_equal(got["target_scores"], want["target_scores"])
    fg = np.nonzero(got["fg_mask"][0])[0]
    # the ten lowest-index anchors, of which those inside the box are foreground
    assert fg.size > 0 and fg.max() < 10 and (got["target_scores"][0, fg] == 0).all()


@pytest.mark.parametrize("kind", ["random", "tie_heavy"])
@pytest.mark.parametrize("seed", range(4))
def test_assign_matches_ultralytics_in_float64(seed, kind):
    case = _case(np.random.default_rng(100 + seed), kind)
    got = _torch_assign(case, torch.float64)
    _, tb, tsc, fg, tgi = unp.tal_forward(*case)
    np.testing.assert_array_equal(got["fg_mask"], fg)
    np.testing.assert_array_equal(got["target_gt_idx"][fg], tgi[fg])
    np.testing.assert_allclose(got["target_bboxes"][fg], tb[fg], rtol=1e-12)
    np.testing.assert_allclose(got["target_scores"], tsc, rtol=1e-9, atol=1e-12)


def test_topk_indices_are_the_stable_descending_order():
    x = torch.tensor([[0.0, 3.0, 0.0, 3.0, 1.0, 0.0], [0.0, 0.0, 0.0, 0.0, 0.0, 0.0]])
    assert tas.topk_indices_desc(x, 4).tolist() == [[1, 3, 4, 0], [0, 1, 2, 3]]
    want = np.asarray(jax.lax.top_k(jnp.asarray(x.numpy()), 4)[1])
    np.testing.assert_array_equal(tas.topk_indices_desc(x, 4).numpy(), want)
