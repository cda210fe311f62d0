"""Detection decode: anchors, DFL box regression, letterbox geometry.

Port of ``tpu_mslesseg/infer/decode.py``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

STRIDES = (8, 16, 32)


def make_anchors(h: int, w: int, strides=STRIDES, offset: float = 0.5,
                 device=None):
    """Anchor centers (in feature-grid units) and per-anchor strides for a
    letterboxed input of size (h, w). Returns ([A,2] xy, [A,1])."""
    points, stride_vals = [], []
    for s in strides:
        fh, fw = h // s, w // s
        ys = torch.arange(fh, dtype=torch.float32, device=device) + offset
        xs = torch.arange(fw, dtype=torch.float32, device=device) + offset
        yv, xv = torch.meshgrid(ys, xs, indexing="ij")
        points.append(torch.stack([xv, yv], dim=-1).reshape(-1, 2))
        stride_vals.append(
            torch.full((fh * fw, 1), float(s), dtype=torch.float32, device=device)
        )
    return torch.cat(points, 0), torch.cat(stride_vals, 0)


def dfl_expectation(box_dist, reg_max: int = 16):
    """[..., 4*reg_max] DFL logits -> [..., 4] expected ltrb distances."""
    d = box_dist.reshape(*box_dist.shape[:-1], 4, reg_max).to(torch.float32)
    p = d.softmax(dim=-1)
    bins = torch.arange(reg_max, dtype=torch.float32, device=d.device)
    return (p * bins).sum(dim=-1)


def dist2bbox(ltrb, anchor_points):
    """ltrb distances (grid units) + anchor centers -> xyxy (grid units)."""
    return torch.cat(
        [anchor_points - ltrb[..., :2], anchor_points + ltrb[..., 2:]], dim=-1
    )


def flatten_level_outputs(out, reg_max: int = 16):
    """Model output dict -> ([B,A,4*reg_max], [B,A,nc], [B,A,nm]) with
    levels concatenated in stride order (8, 16, 32)."""
    def flat(xs):
        return torch.cat([x.reshape(x.shape[0], -1, x.shape[-1]) for x in xs], 1)

    return flat(out["box"]), flat(out["cls"]), flat(out["mcoef"])


def decode_boxes(box_dist, anchor_points, stride_vals, reg_max: int = 16):
    """DFL logits -> xyxy boxes in letterbox-pixel units. [B,A,4]."""
    ltrb = dfl_expectation(box_dist, reg_max)
    return dist2bbox(ltrb, anchor_points[None]) * stride_vals[None]


def _fma_f32(a, b: float, c: float):
    """f32 ``a * b + c`` rounded once, as the reference's compiled programs
    compute it: XLA fuses the multiply and the add into one FMA. ``a`` holds
    small half-integers, so the float64 product and sum are exact."""
    b32 = float(np.float32(b))
    return (a.to(torch.float64) * b32 + c).to(torch.float32)


def _resize_weights(in_size: int, out_size: int, device) -> torch.Tensor:
    """[in, out] bilinear (triangle-kernel) weights exactly as the
    reference's ``jax.image.resize(..., "bilinear")`` builds them: half-pixel
    sample positions, a kernel widened by 1/scale when downsampling
    (antialias), column normalisation, and zero weight for samples outside
    the input. ``F.interpolate`` differs at the edges."""
    inv_scale = 1.0 / (out_size / in_size)
    kernel_scale = max(inv_scale, 1.0)
    sample_f = _fma_f32(
        torch.arange(out_size, dtype=torch.float32, device=device) + 0.5,
        inv_scale, -0.5,
    )
    src = torch.arange(in_size, dtype=torch.float32, device=device)
    x = (sample_f[None, :] - src[:, None]).abs() / kernel_scale
    w = (1 - x).clamp(min=0)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(
        total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
        w / torch.where(total != 0, total, 1.0),
        0.0,
    )
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[None, :], w, 0.0)


@dataclass(frozen=True)
class Letterbox:
    """Static letterbox transform from an (h, w) source image to a
    (size, size) network input (Ultralytics LetterBox with auto=False —
    scale to fit, center with gray padding)."""

    src_h: int
    src_w: int
    size: int = 640

    @property
    def ratio(self) -> float:
        return min(self.size / self.src_h, self.size / self.src_w)

    @property
    def new_h(self) -> int:
        return round(self.src_h * self.ratio)

    @property
    def new_w(self) -> int:
        return round(self.src_w * self.ratio)

    @property
    def pad_top(self) -> int:
        return round((self.size - self.new_h) / 2 - 0.1)

    @property
    def pad_left(self) -> int:
        return round((self.size - self.new_w) / 2 - 0.1)

    def apply(self, imgs):
        """[N, src_h, src_w] float in [0,1] -> [N, size, size]: separable
        bilinear resize as two matmuls, then pad with 114/255."""
        x = imgs.to(torch.float32)
        if self.new_h != self.src_h:
            wh = _resize_weights(self.src_h, self.new_h, x.device)
            x = torch.matmul(wh.T, x)
        if self.new_w != self.src_w:
            ww = _resize_weights(self.src_w, self.new_w, x.device)
            x = torch.matmul(x, ww)
        pad_b = self.size - self.new_h - self.pad_top
        pad_r = self.size - self.new_w - self.pad_left
        return F.pad(
            x, (self.pad_left, pad_r, self.pad_top, pad_b), value=114.0 / 255.0
        )

    def src_centers_in_letterbox(self, device=None):
        """Letterbox-pixel coordinates of every source-pixel center:
        ([src_h], [src_w]) — the exact inverse-letterbox sampling grid."""
        f32 = torch.float32
        ys = _fma_f32(
            torch.arange(self.src_h, dtype=f32, device=device) + 0.5,
            self.new_h / self.src_h, -0.5,
        )
        xs = _fma_f32(
            torch.arange(self.src_w, dtype=f32, device=device) + 0.5,
            self.new_w / self.src_w, -0.5,
        )
        return ys + self.pad_top, xs + self.pad_left
