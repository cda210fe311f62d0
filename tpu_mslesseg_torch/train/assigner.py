"""Task-aligned label assignment (TAL) on tensors.

Port of ``tpu_mslesseg/train/assigner.py``: for every ground-truth box,
anchors are scored by ``cls_score**alpha * CIoU**beta`` (alpha 0.5, beta
6.0), the top 10 a GT are kept, anchors claimed by several GTs go to the GT
of highest IoU, and the soft target scores are normalised per GT by
max-IoU / max-metric. The upstream quirks the reference pins are kept:

* top-k indices are masked by GT validity only, not by metric > eps, so a
  GT with fewer than ``topk`` positive-metric anchors pads its claims with
  zero-metric anchors, lowest index first; claim counts above 1 are zeroed;
* a multi-claimed anchor goes to the argmax over the overlaps of all GTs,
  which need not be a claiming one;
* ``bbox_iou_ciou``'s eps lands on h1/h2 and on the union.

Where the reference spells gathers and scatters as one-hot sums and
compare-reduces (forms written for the TPU), this module gathers and
scatter-adds directly: the results are equal, the other terms of those sums
being exact zeros. ``torch.topk`` promises no order among ties, so the
top-k is a stable descending sort.
"""

from __future__ import annotations

import math

import torch


def bbox_iou_ciou(box1, box2, eps: float = 1e-7):
    """CIoU between broadcastable xyxy boxes (last dim 4), as
    ultralytics' ``bbox_iou(xywh=False, CIoU=True)``: eps on h1/h2 and on
    the union; ``alpha`` carries no gradient."""
    b1x1, b1y1, b1x2, b1y2 = (box1[..., i] for i in range(4))
    b2x1, b2y1, b2x2, b2y2 = (box2[..., i] for i in range(4))
    w1, h1 = b1x2 - b1x1, b1y2 - b1y1 + eps
    w2, h2 = b2x2 - b2x1, b2y2 - b2y1 + eps

    inter_w = (torch.minimum(b1x2, b2x2) - torch.maximum(b1x1, b2x1)).clamp(min=0)
    inter_h = (torch.minimum(b1y2, b2y2) - torch.maximum(b1y1, b2y1)).clamp(min=0)
    inter = inter_w * inter_h
    union = w1 * h1 + w2 * h2 - inter + eps
    iou = inter / union

    cw = torch.maximum(b1x2, b2x2) - torch.minimum(b1x1, b2x1)
    ch = torch.maximum(b1y2, b2y2) - torch.minimum(b1y1, b2y1)
    c2 = cw**2 + ch**2 + eps
    rho2 = ((b2x1 + b2x2 - b1x1 - b1x2) ** 2 + (b2y1 + b2y2 - b1y1 - b1y2) ** 2) / 4
    v = (4 / math.pi**2) * (torch.atan(w2 / h2) - torch.atan(w1 / h1)) ** 2
    alpha = (v / (v - iou + (1 + eps))).detach()
    return iou - (rho2 / c2 + v * alpha)


def topk_indices_desc(x, k: int):
    """Indices of the k largest entries along the last dim, descending,
    ties lowest index first (a stable sort)."""
    return torch.sort(x, dim=-1, descending=True, stable=True).indices[..., :k]


@torch.no_grad()
def assign(
    pd_scores,  # [B, A, nc] sigmoid class scores
    pd_bboxes,  # [B, A, 4] xyxy (input-pixel units)
    anc_points,  # [A, 2] anchor centers (input-pixel units)
    gt_labels,  # [B, M] int
    gt_bboxes,  # [B, M, 4] xyxy (input-pixel units)
    gt_valid,  # [B, M] bool
    topk: int = 10,
    num_classes: int = 1,
    alpha: float = 0.5,
    beta: float = 6.0,
    eps: float = 1e-9,
):
    """Returns a dict: target_bboxes [B,A,4], target_scores [B,A,nc],
    fg_mask [B,A] bool, target_gt_idx [B,A] int64 (index into M, valid only
    where fg). Nothing here carries a gradient."""
    B, A, nc = pd_scores.shape
    M = gt_bboxes.shape[1]
    gt_labels = gt_labels.long()

    # anchors inside GT boxes: [B, M, A]
    px = anc_points[None, None, :, 0]
    py = anc_points[None, None, :, 1]
    in_gt = (
        (px - gt_bboxes[..., 0:1] > eps)
        & (py - gt_bboxes[..., 1:2] > eps)
        & (gt_bboxes[..., 2:3] - px > eps)
        & (gt_bboxes[..., 3:4] - py > eps)
    )
    valid = in_gt & gt_valid[:, :, None]

    # overlaps and class scores per (gt, anchor), zero outside in-gt & valid
    ciou = bbox_iou_ciou(gt_bboxes[:, :, None, :], pd_bboxes[:, None, :, :])
    overlaps = torch.where(valid, ciou.clamp(min=0), 0.0)  # [B, M, A]
    cls_idx = gt_labels.clamp(0, nc - 1)  # [B, M]
    scores = pd_scores.transpose(1, 2).gather(1, cls_idx[:, :, None].expand(B, M, A))
    scores = torch.where(valid, scores, 0.0)
    align = (scores**alpha) * (overlaps**beta)  # zero outside valid

    # top-k anchors per GT: the indices of invalid GTs are masked to 0 (their
    # rows die at the mask_pos product), claims are counted, counts > 1 zeroed
    k = min(topk, A)
    topk_idx = topk_indices_desc(align, k)  # [B, M, k]
    topk_idx = torch.where(gt_valid[:, :, None], topk_idx, 0)
    counts = torch.zeros((B, M, A), dtype=torch.int32, device=align.device)
    counts.scatter_add_(2, topk_idx, torch.ones_like(topk_idx, dtype=torch.int32))
    mask_pos = (counts == 1) & valid  # [B, M, A]

    # anchors claimed by several GTs: argmax over the overlaps of ALL GTs
    n_claims = mask_pos.sum(dim=1)  # [B, A]
    best_gt_by_iou = overlaps.argmax(dim=1)  # [B, A], first of equal maxima
    gt_m = torch.arange(M, device=align.device)
    is_best = gt_m[None, :, None] == best_gt_by_iou[:, None, :]
    mask_pos = torch.where((n_claims > 1)[:, None, :], is_best, mask_pos)

    fg_mask = mask_pos.any(dim=1)  # [B, A]
    target_gt_idx = mask_pos.to(torch.uint8).argmax(dim=1)  # [B, A]

    tb = gt_bboxes.gather(1, target_gt_idx[..., None].expand(B, A, 4))  # [B, A, 4]
    tl = gt_labels.gather(1, target_gt_idx)  # [B, A]

    # normalized soft scores (align/overlaps already masked to valid)
    align_pos = torch.where(mask_pos, align, 0.0)
    pos_align = align_pos.amax(dim=-1, keepdim=True)  # [B, M, 1]
    pos_overlap = torch.where(mask_pos, overlaps, 0.0).amax(dim=-1, keepdim=True)
    norm = (align_pos * pos_overlap / (pos_align + eps)).amax(dim=1)  # [B, A]

    onehot = torch.nn.functional.one_hot(tl.clamp(0, nc - 1), nc).to(pd_scores.dtype)
    target_scores = onehot * norm[..., None] * fg_mask[..., None]

    return {
        "target_bboxes": tb,
        "target_scores": target_scores,
        "fg_mask": fg_mask,
        "target_gt_idx": target_gt_idx,
    }
