"""Segmentation mAP (box and mask AP50 and AP50-95), as ultralytics computes it.

Port of ``tpu_mslesseg/evalx/seg_map.py``. The per-image IoUs and matches
run on the device with fixed shapes (padded predictions x padded ground
truths); only the small (score, match bits) table goes to the host, where
`SegMapAccumulator` accumulates AP over the validation set in numpy.

Matching is ultralytics' ``BaseValidator.match_predictions`` (IoU-descending
unique matching at each threshold 0.50:0.05:0.95, see `match_image`), AP its
101-point trapezoidal integral with sentinel end points (`average_precision`).
"""

from __future__ import annotations

import numpy as np
import torch

IOU_THRESHES = np.arange(0.5, 0.96, 0.05).round(2)  # 10 thresholds


def box_iou_pairs(a, b, eps=1e-7):
    """a [..., K, 4], b [..., I, 4] xyxy -> [..., K, I] IoU."""
    area_a = (a[..., 2] - a[..., 0]).clamp(min=0) * (a[..., 3] - a[..., 1]).clamp(min=0)
    area_b = (b[..., 2] - b[..., 0]).clamp(min=0) * (b[..., 3] - b[..., 1]).clamp(min=0)
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    return inter / (area_a[..., :, None] + area_b[..., None, :] - inter).clamp(min=eps)


def mask_iou_pairs(pred_masks, gt_masks, eps=1e-7):
    """pred [..., K, H, W] {0,1}, gt [..., I, H, W] {0,1} -> [..., K, I] IoU
    (one matrix product)."""
    p = pred_masks.flatten(-2).to(torch.float32)
    g = gt_masks.flatten(-2).to(torch.float32)
    inter = p @ g.transpose(-1, -2)
    union = p.sum(-1)[..., :, None] + g.sum(-1)[..., None, :] - inter
    return inter / union.clamp(min=eps)


def match_image(iou, pred_valid, gt_valid):
    """Ultralytics' true-positive matching. iou [..., K, I] -> tp [..., K, 10].

    At each IoU threshold, among the pairs with iou >= thr: each prediction
    keeps its highest-IoU ground truth (exact ties to the larger index),
    then each ground truth goes to the smallest prediction index still
    pointing at it. Scores take no part (they only order the AP sweep)."""
    K, I = iou.shape[-2:]
    thr = torch.as_tensor(IOU_THRESHES, dtype=torch.float32, device=iou.device)
    cand = torch.where(pred_valid[..., :, None] & gt_valid[..., None, :], iou, 0.0)
    c = torch.where(cand[..., None, :, :] >= thr[:, None, None], cand[..., None, :, :], 0.0)
    # step 1: each prediction's best ground truth, ties to the larger index
    bestg = (I - 1) - c.flip(-1).argmax(-1)  # [..., 10, K]
    pair_iou = c.gather(-1, bestg[..., None])[..., 0]
    pairs = (pair_iou > 0.0)[..., None] & (
        bestg[..., None] == torch.arange(I, device=iou.device))  # [..., 10, K, I]
    # step 2: each ground truth's first prediction in ascending order
    # (argmax of a bool picks the first True)
    bestk = pairs.to(torch.uint8).argmax(-2)  # [..., 10, I]
    gt_has = pairs.any(-2)
    sel = gt_has[..., None] & (bestk[..., None] == torch.arange(K, device=iou.device))
    return sel.any(-2).transpose(-1, -2)  # [..., K, 10]


def average_precision(scores, tps, n_gt: int):
    """101-point AP per IoU threshold, as ultralytics' ``compute_ap``:
    sentinels (0, 1) and (1, 0) around the PR curve, its precision envelope
    and the trapezoidal integral of the interpolation (a perfect detector
    scores 0.995). scores [N], tps [N, 10] bool, `n_gt` ground truths.
    Returns ap [10]."""
    if n_gt == 0 or len(scores) == 0:
        return np.zeros(10)
    order = np.argsort(-scores)
    tps = tps[order]
    x = np.linspace(0, 1, 101)
    aps = np.zeros(10)
    for t in range(10):
        tp_cum = np.cumsum(tps[:, t])
        fp_cum = np.cumsum(~tps[:, t])
        recall = tp_cum / (n_gt + 1e-16)
        precision = tp_cum / np.maximum(tp_cum + fp_cum, 1e-16)
        mrec = np.concatenate(([0.0], recall, [1.0]))
        mpre = np.concatenate(([1.0], precision, [0.0]))
        mpre = np.flip(np.maximum.accumulate(np.flip(mpre)))
        aps[t] = np.trapezoid(np.interp(x, mrec, mpre), x)
    return aps


class SegMapAccumulator:
    """Accumulates per-image matches (host arrays) into the set's metrics."""

    def __init__(self):
        self.scores = []
        self.tp_box = []
        self.tp_mask = []
        self.n_gt = 0

    def add_image(self, scores, valid, tp_box, tp_mask, n_gt: int):
        keep = np.asarray(valid)
        self.scores.append(np.asarray(scores)[keep])
        self.tp_box.append(np.asarray(tp_box)[keep])
        self.tp_mask.append(np.asarray(tp_mask)[keep])
        self.n_gt += int(n_gt)

    def compute(self) -> dict:
        if not self.scores:
            return {k: 0.0 for k in (
                "map50_b", "map_b", "map50_m", "map_m",
                "precision_b", "recall_b", "precision_m", "recall_m")}
        scores = np.concatenate(self.scores)
        tpb = np.concatenate(self.tp_box)
        tpm = np.concatenate(self.tp_mask)
        ap_b = average_precision(scores, tpb, self.n_gt)
        ap_m = average_precision(scores, tpm, self.n_gt)

        # P and R at the confidence that maximises F1, at IoU 0.5
        def pr_best_f1(tps):
            if len(scores) == 0 or self.n_gt == 0:
                return 0.0, 0.0
            order = np.argsort(-scores)
            t = tps[order, 0]
            tp_cum = np.cumsum(t)
            fp_cum = np.cumsum(~t)
            prec = tp_cum / np.maximum(tp_cum + fp_cum, 1e-9)
            rec = tp_cum / self.n_gt
            f1 = 2 * prec * rec / np.maximum(prec + rec, 1e-9)
            i = int(np.argmax(f1))
            return float(prec[i]), float(rec[i])

        pb, rb = pr_best_f1(tpb)
        pm, rm = pr_best_f1(tpm)
        return {
            "map50_b": float(ap_b[0]),
            "map_b": float(ap_b.mean()),
            "map50_m": float(ap_m[0]),
            "map_m": float(ap_m.mean()),
            "precision_b": pb,
            "recall_b": rb,
            "precision_m": pm,
            "recall_m": rm,
        }
