"""Image enhancement: HE / CLAHE / GC / LT on batches of uint8 slices ``[N, H, W]``.

Port of ``tpu_mslesseg/preproc/enhance.py``, with the same numerics (the
reference's OpenCV chains collapse to 1-D maps on grayscale slices):

* HE — ``cv2.equalizeHist`` on the luma channel;
* CLAHE — clip 2.0, 8x8 tiles on the LAB L channel: the fixed-point L
  maps, the tile LUTs and the four-LUT bilinear blend (``preproc/clahe.py``,
  two CUDA kernels on the card, the backward L map fused into the blend);
* GC — the LUT ``uint8((linspace(0,1,256)**gamma)*255)``, gamma 2.0;
* LT — ``c*log(1+v)`` with ``c = 255/log(1+max)`` per slice.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_mslesseg_torch.preproc import clahe


def normalize_to_uint8(slices):
    """Per-slice min-max to [0,255] uint8 (f32 math, truncating cast).

    `slices`: float [N, H, W] (or [H, W])."""
    x = torch.as_tensor(slices).to(torch.float32)
    dims = (1, 2) if x.ndim == 3 else (0, 1)
    lo = x.amin(dim=dims, keepdim=True)
    ptp = x.amax(dim=dims, keepdim=True) - lo
    y = torch.where(ptp > 0, 255.0 * (x - lo) / torch.where(ptp > 0, ptp, 1.0), 0.0)
    return y.to(torch.uint8)


def he_batch(imgs_u8):
    """cv2.equalizeHist semantics on each uint8 image of [N, H, W]."""
    n = imgs_u8.shape[0]
    flat = imgs_u8.reshape(n, -1).long()
    hist = torch.zeros((n, 256), dtype=torch.long, device=flat.device)
    hist.scatter_add_(1, flat, torch.ones_like(flat))
    i0 = (hist > 0).to(torch.int32).argmax(dim=1, keepdim=True)  # first used bin
    denom = flat.shape[1] - hist.gather(1, i0)
    cdf = hist.cumsum(dim=1)
    scale = 255.0 / denom.clamp(min=1).to(torch.float32)
    lut = torch.round((cdf - cdf.gather(1, i0)).to(torch.float32) * scale)
    lut = lut.clamp(0, 255).to(torch.uint8)
    out = lut.gather(1, flat).reshape(imgs_u8.shape)
    # constant image: cv2 returns the input unchanged
    return torch.where((denom == 0).view(n, 1, 1), imgs_u8, out)


def _gc_lut(gamma: float) -> np.ndarray:
    # truncating cast, like the reference's np.array(..., dtype=np.uint8)
    return (np.linspace(0, 1, 256) ** gamma * 255).astype(np.uint8)


def gc_batch(imgs_u8, gamma: float = 2.0):
    lut = torch.from_numpy(_gc_lut(gamma)).to(imgs_u8.device)
    return lut[imgs_u8.long()]


def _log1p_lut() -> np.ndarray:
    """float32 ``log1p`` of 0..255 as the reference computes it: float64
    ``log1p`` rounded to float32, with XLA's one-ulp differences from that
    written as ``{index: delta}`` corrections. The card and the CPU read the
    same values from the table."""
    lut = np.log1p(np.arange(256, dtype=np.float64)).astype(np.float32)
    for i, d in {6: 1, 46: 1, 48: 1, 178: -1}.items():
        lut.view(np.int32)[i] += d
    return lut


_LOG1P = _log1p_lut()


def lt_batch(imgs_u8):
    lut = torch.from_numpy(_LOG1P).to(imgs_u8.device)
    lx = lut[imgs_u8.long()]
    lm = lx.amax(dim=(1, 2), keepdim=True)  # log1p is increasing: log1p of the maximum
    # tensor by tensor: a Python scalar over a tensor is computed as a
    # reciprocal times the scalar, which rounds differently from a division
    c = torch.full_like(lm, 255.0) / lm
    y = c * lx
    # reference: np.clip(...).astype(np.uint8) — truncation
    return torch.floor(y.clamp(0, 255)).to(torch.uint8)


def _lab_luts():
    """Forward (gray->L8) and backward (L8->gray) CIELAB luma maps.

    The sRGB-gamma CIELAB transforms for neutral gray, with the reference's
    per-entry integer corrections so that both maps equal OpenCV's
    fixed-point colorspace tables bit for bit."""
    v = np.arange(256) / 255.0
    vlin = np.where(v <= 0.04045, v / 12.92, ((v + 0.055) / 1.055) ** 2.4)
    L = np.where(vlin > 0.008856, 116.0 * np.cbrt(vlin) - 16.0, 903.3 * vlin)
    fwd = np.round(L * 255.0 / 100.0).astype(np.int32)

    l8 = np.arange(256)
    Lf = l8 * 100.0 / 255.0
    fy = (Lf + 16.0) / 116.0
    Y = np.where(Lf > 903.3 * 0.008856, fy**3, Lf / 903.3)
    srgb = np.where(Y <= 0.0031308, 12.92 * Y, 1.055 * np.power(Y, 1 / 2.4) - 0.055)
    bwd = np.clip(np.round(srgb * 255.0), 0, 255).astype(np.int32)

    # fixed-point corrections: {index: delta} vs the analytic formula
    fwd_fix = {
        4: -1, 6: 1, 9: 1, 12: 1, 17: -1, 23: -1, 25: 1, 28: 1, 30: -1, 33: 1,
        37: 1, 42: -1, 47: 1, 67: 1, 75: 1, 77: -1, 89: 1, 110: 1, 112: 1,
        113: 1, 143: 1, 144: 1, 145: 1, 146: 1, 147: 1, 171: 1, 172: 1,
        187: 1, 188: 1, 189: 1, 201: 1, 202: 1, 213: 1, 214: 1, 224: 1,
        233: 1, 234: 1, 243: 1, 251: 1, 252: 1,
    }
    bwd_fix = {
        1: 1, 19: 1, 23: -1, 33: 1, 38: 1, 44: 1, 50: 1, 56: -1, 64: -1,
        121: -1,
    }
    for i, d in fwd_fix.items():
        fwd[i] += d
    for i, d in bwd_fix.items():
        bwd[i] += d
    return fwd.astype(np.uint8), bwd.astype(np.uint8)


_LAB_FWD, _LAB_BWD = _lab_luts()


def _clahe_core(l_imgs, out_map, clip_limit: float, tiles_x: int, tiles_y: int):
    """OpenCV's CLAHE on each uint8 L image of [N, H, W]: the tile LUTs and
    the four-LUT bilinear blend, rounded half to even and clipped, each
    pixel then mapped through `out_map` [256] uint8. Both steps are CUDA
    kernels on the card (``preproc/clahe.py``)."""
    luts = clahe.clahe_tile_luts(l_imgs, clip_limit, tiles_x, tiles_y)
    return clahe.clahe_blend(l_imgs, luts, out_map, tiles_x, tiles_y)


def clahe_batch(imgs_u8, clip_limit: float = 2.0, tiles_x: int = 8, tiles_y: int = 8):
    """The reference's CLAHE chain: gray -> LAB L -> CLAHE -> back to gray
    (the backward map fused into the blend)."""
    dev = imgs_u8.device
    fwd = torch.from_numpy(_LAB_FWD).to(dev)
    bwd = torch.from_numpy(_LAB_BWD).to(dev)
    # PyTorch reads a uint8 index tensor as a mask: int32 indices, not int64
    l_imgs = fwd.index_select(0, imgs_u8.reshape(-1).to(torch.int32)).reshape(imgs_u8.shape)
    return _clahe_core(l_imgs, bwd, clip_limit, tiles_x, tiles_y)


_KERNELS = {
    "HE": he_batch,
    "CLAHE": clahe_batch,
    "GC": gc_batch,
    "LT": lt_batch,
}


def enhance_batch(slices, mejora: str | None, normalize: bool = True):
    """Apply an enhancement to a batch of slices.

    `slices`: float volume-space slices [N, H, W] (normalize=True) or
    uint8 images (normalize=False). Returns uint8 [N, H, W].
    """
    imgs = normalize_to_uint8(slices) if normalize else torch.as_tensor(slices)
    if mejora is None:
        return imgs
    if mejora not in _KERNELS:
        raise ValueError(f"Mejora no reconocida: {mejora}.")
    return _KERNELS[mejora](imgs)


def enhance_for_model(slices, mejora: str | None):
    """Enhancement followed by the per-slice min-max stretch the PNG
    artifacts carry (``plt.imsave`` re-normalizes each slice) — the model
    was trained on the stretched PNGs, so its inputs must match."""
    return normalize_to_uint8(enhance_batch(slices, mejora))
