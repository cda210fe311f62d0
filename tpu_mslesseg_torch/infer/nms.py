"""Padded fixed-shape NMS over a batch of images.

Port of ``tpu_mslesseg/infer/nms.py``: take the top `max_det` candidates by
score and return a validity mask instead of a ragged result. Suppression
is the fixpoint of ``keep_i = valid_i and no higher-scored kept j overlaps
i`` (IoU > iou_thres), iterated from keep = valid as one batched
``S @ keep`` per step until no image changes — the exact greedy result in
(suppression-chain depth) steps.

Ties: the reference's ``lax.top_k`` puts the lower index first among equal
scores, and sigmoids of bf16 logits tie often; ``torch.topk`` promises no
order, so candidates come from a stable descending sort.

The convergence test reads one bool to the host per step (a device sync).
"""

from __future__ import annotations

import torch


def box_iou_matrix(boxes):
    """[..., K, 4] xyxy -> [..., K, K] pairwise IoU."""
    area = (boxes[..., 2] - boxes[..., 0]).clamp(min=0) * (
        boxes[..., 3] - boxes[..., 1]
    ).clamp(min=0)
    lt = torch.maximum(boxes[..., :, None, :2], boxes[..., None, :, :2])
    rb = torch.minimum(boxes[..., :, None, 2:], boxes[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = area[..., :, None] + area[..., None, :] - inter
    return inter / union.clamp(min=1e-7)


def nms_batch(boxes, scores, conf_thres: float = 0.25, iou_thres: float = 0.7,
              max_det: int = 300):
    """Greedy NMS on each image of a batch.

    boxes [B,A,4] xyxy, scores [B,A] (already sigmoid'd, single class).
    Returns (boxes [B,max_det,4], scores [B,max_det], keep [B,max_det]
    bool, indices [B,max_det] into the A anchors); slots past A are
    zero-padded and not kept.
    """
    b, a = scores.shape
    k = min(max_det, a)
    sorted_scores, order = torch.sort(scores, dim=1, descending=True, stable=True)
    top_scores, top_idx = sorted_scores[:, :k], order[:, :k]
    top_boxes = torch.gather(boxes, 1, top_idx[..., None].expand(b, k, 4))

    valid = top_scores > conf_thres
    tri = torch.ones((k, k), dtype=torch.bool, device=scores.device).tril(-1)
    # S[n, i, j] = 1 when the higher-scored candidate j can suppress i
    s = ((box_iou_matrix(top_boxes) > iou_thres) & tri).to(torch.float32)
    keep = valid
    for _ in range(k):
        suppressed = (s @ keep.to(torch.float32)[..., None])[..., 0] > 0.0
        new = valid & ~suppressed
        if torch.equal(new, keep):
            break
        keep = new

    if k < max_det:
        pad = max_det - k
        top_boxes = torch.nn.functional.pad(top_boxes, (0, 0, 0, pad))
        top_scores = torch.nn.functional.pad(top_scores, (0, pad))
        keep = torch.nn.functional.pad(keep, (0, pad))
        top_idx = torch.nn.functional.pad(top_idx, (0, pad))
    return top_boxes, top_scores, keep, top_idx
