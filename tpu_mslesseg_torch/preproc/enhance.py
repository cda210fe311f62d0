"""Image enhancement: HE / GC / LT on batches of uint8 slices ``[N, H, W]``.

Port of ``tpu_mslesseg/preproc/enhance.py``, with the same numerics (the
reference's OpenCV chains collapse to 1-D maps on grayscale slices):

* HE — ``cv2.equalizeHist`` on the luma channel;
* GC — the LUT ``uint8((linspace(0,1,256)**gamma)*255)``, gamma 2.0;
* LT — ``c*log(1+v)`` with ``c = 255/log(1+max)`` per slice.

CLAHE is not ported yet: it arrives with its kernel (ROADMAP B2).
"""

from __future__ import annotations

import numpy as np
import torch


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


def lt_batch(imgs_u8):
    x = imgs_u8.to(torch.float32)
    m = x.amax(dim=(1, 2), keepdim=True)
    c = 255.0 / torch.log1p(m)
    y = c * torch.log1p(x)
    # reference: np.clip(...).astype(np.uint8) — truncation
    return torch.floor(y.clamp(0, 255)).to(torch.uint8)


def _clahe_not_ported(imgs_u8):
    raise NotImplementedError(
        "CLAHE is not ported yet: it arrives with its tile-LUT kernel "
        "(ROADMAP B2)"
    )


_KERNELS = {
    "HE": he_batch,
    "CLAHE": _clahe_not_ported,
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
