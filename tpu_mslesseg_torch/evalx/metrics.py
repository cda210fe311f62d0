"""Volume metrics: DSC / AUC / Precision / Recall from confusion counts.

Port of ``tpu_mslesseg/evalx/metrics.py``. The counts are integer sums on
the device, returned as one float32 ``[..., 4]`` tensor ``[tp, fp, fn,
tn]`` so a caller fetches them once; the metrics dict is finished on the
host with the reference's formulas (DSC/precision/recall with the 1e-8
guard, binary AUC as ``(1 + TPR - FPR) / 2``, all rounded to 3 decimals).
"""

from __future__ import annotations

import math

import numpy as np
import torch


def confusion_counts(y_true, y_pred):
    """[tp, fp, fn, tn] over the last three (volume) dims -> [..., 4] f32.

    A volume with a leading batch dim gives one row per volume. Sums are
    taken in int64, so they are exact; the f32 result is exact up to 2**24
    voxels per volume (a 182x218x182 volume has 7.2M)."""
    t = y_true > 0
    p = y_pred > 0
    dims = (-3, -2, -1)
    tp = (t & p).sum(dim=dims)
    fp = (~t & p).sum(dim=dims)
    fn = (t & ~p).sum(dim=dims)
    tn = (~t & ~p).sum(dim=dims)
    return torch.stack([tp, fp, fn, tn], dim=-1).to(torch.float32)


def _round3(x: float) -> float:
    return float(np.round(x, 3))


def compute_metrics(y_true, y_pred) -> dict:
    """All four volume metrics; {"DSC", "AUC", "Precision", "Recall"}."""
    return metrics_from_counts(confusion_counts(y_true, y_pred))


def metrics_from_counts(counts) -> dict:
    """Host-side finish: [tp, fp, fn, tn] -> the reference metrics dict."""
    if isinstance(counts, torch.Tensor):
        counts = counts.detach().cpu().numpy()
    tp, fp, fn, tn = np.asarray(counts, np.float64)

    dsc = (2.0 * tp) / (2 * tp + fp + fn + 1e-8)
    prec = tp / (tp + fp + 1e-8)
    rec = tp / (tp + fn + 1e-8)

    pos = tp + fn
    neg = fp + tn
    if pos == 0 or neg == 0:
        auc = math.nan  # single-class GT: AUC undefined (reference warns+NaN)
    else:
        auc = (1.0 + tp / pos - fp / neg) / 2.0

    return {
        "DSC": _round3(dsc),
        "AUC": _round3(auc) if not math.isnan(auc) else float("nan"),
        "Precision": _round3(prec),
        "Recall": _round3(rec),
    }
