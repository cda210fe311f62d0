"""Shared overlay rendering: TP/FP/FN color scheme over a slice image.

Port of ``tpu_mslesseg/viz/overlay.py``. Host code over PNGs: numpy, as the
reference, with the float64 blend kept as it is so every frame is the same
uint8 array. Reference color vocabulary
(``extras/generar_gif_predicciones.py:181-195``): TP #00CC66 (green), FP
#FF4500 (orange-red), FN #0099FF (blue). All rendering happens in PNG space
(images as stored, predictions rotated into alignment via ``np.rot90`` ==
our `to_png_space`).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from tpu_mslesseg_torch.core import geometry
from tpu_mslesseg_torch.io import png as png_io

COLOR_TP = (0x00, 0xCC, 0x66)
COLOR_FP = (0xFF, 0x45, 0x00)
COLOR_FN = (0x00, 0x99, 0xFF)


def load_triplet(img_path, pred_path, gt_path):
    """(img, pred, gt) in PNG space as float64 arrays, pred/gt binarized.

    Mirrors ``preparar_cortes_pred_gt`` (``utils.py:372-384``): our pred
    PNGs are stored in volume-slice orientation, so the corrective
    ``np.rot90`` is `to_png_space`."""
    img = png_io.load_gray(img_path).astype(float)
    pred_vol = (png_io.load_gray(pred_path) > 0).astype(float)
    pred = geometry.to_png_space(torch.from_numpy(pred_vol)).numpy()
    gt = (png_io.load_gray(gt_path) > 0).astype(float)
    return img, pred, gt


def render_overlay(img, pred, gt, lo=None, hi=None) -> np.ndarray:
    """RGB uint8 frame: grayscale image + TP/FP/FN tint."""
    img = img.astype(np.float32)
    lo = img.min() if lo is None else lo
    hi = img.max() if hi is None else hi
    base = np.clip((img - lo) / max(hi - lo, 1e-8) * 255, 0, 255).astype(np.uint8)
    frame = np.stack([base, base, base], axis=-1)

    tp = (pred > 0) & (gt > 0)
    fp = (pred > 0) & (gt == 0)
    fn = (pred == 0) & (gt > 0)
    for mask, color in ((tp, COLOR_TP), (fp, COLOR_FP), (fn, COLOR_FN)):
        for c in range(3):
            frame[..., c][mask] = (
                0.45 * frame[..., c][mask] + 0.55 * color[c]
            ).astype(np.uint8)
    return frame


def slice_dsc(pred, gt) -> float:
    inter = float((pred * gt).sum())
    return round(2 * inter / (pred.sum() + gt.sum() + 1e-8), 3)


def viz_output_dir(modelo, epochs, fold, paciente_id, plano, root=None) -> Path:
    root = Path(root) if root else Path.cwd()
    return (
        root / "visualizaciones" / modelo.exp_string
        / f"{modelo.modalidad_str}_{modelo.num_cortes}c_"
          f"{modelo.k_folds}folds_{epochs}epochs"
        / f"fold{fold}" / paciente_id / plano
    )
