"""Training augmentation on the device: mosaic, affine, flip, value jitter.

Port of ``tpu_mslesseg/train/augment.py``. Mosaic placement followed by an
axis-aligned affine (scale and translation) is an affine map per tile, so
every output pixel samples one of its sample's four source slices at a
computed coordinate: bilinearly for the image, nearest for the instance
map. Pixels whose coordinate leaves the 2S x 2S canvas, or every tile, read
the 114 border. The reference resamples with one-hot interpolation matrices
(``Wy @ img @ Wx.T``), a form that suits the TPU's matrix unit; here each
axis is a two-tap gather, which gives the same values but for float32
rounding.

The random draws and their application are split: `draw_params` draws a
batch's seven parameters a sample from a ``torch.Generator`` on the host,
`apply_batch` applies given parameters on the device.

Instances: tile k's ids are offset by ``k * max_inst`` so the mosaic keeps
every instance apart. Boxes are moved analytically (exact for a scale and a
translation), clipped to the canvas before the affine and to the output
after it, and kept by upstream's ``box_candidates`` criteria.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class AugConfig(NamedTuple):
    imgsz: int = 640
    scale: float = 0.5  # uniform(1 - s, 1 + s)
    translate: float = 0.1
    fliplr: float = 0.5
    hsv_v: float = 0.4
    max_inst: int = 16  # a source slice's instance slots
    mosaic: bool = True


class AugParams(NamedTuple):
    """A batch's draws, one float32 value a sample each: the mosaic centre,
    the scale, the translation, the flip's uniform and the brightness gain."""

    yc: torch.Tensor
    xc: torch.Tensor
    s: torch.Tensor
    tx: torch.Tensor
    ty: torch.Tensor
    flip_u: torch.Tensor
    gain: torch.Tensor

    def to(self, device) -> "AugParams":
        return AugParams(*(t.to(device) for t in self))

    def rows(self, part) -> "AugParams":
        """The draws of the samples `part` (a slice) selects."""
        return AugParams(*(t[part] for t in self))


def draw_params(gen: torch.Generator, cfg: AugConfig, batch: int) -> AugParams:
    """The seven draws of each of `batch` samples, in the reference's ranges:
    integer centres in [S/2, 3S/2), the scale in [1 - scale, 1 + scale), the
    translation in S * [0.5 - translate, 0.5 + translate), the flip's
    uniform in [0, 1) and the gain in [1 - hsv_v, 1 + hsv_v)."""
    S = cfg.imgsz
    u = torch.rand((7, batch), generator=gen, dtype=torch.float32)

    def uniform(row, lo, hi):
        lo, hi = (torch.tensor(v, dtype=torch.float32) for v in (lo, hi))
        return u[row] * (hi - lo) + lo

    return AugParams(
        yc=torch.floor(uniform(0, 0.5 * S, 1.5 * S)),
        xc=torch.floor(uniform(1, 0.5 * S, 1.5 * S)),
        s=uniform(2, 1 - cfg.scale, 1 + cfg.scale),
        tx=uniform(3, 0.5 - cfg.translate, 0.5 + cfg.translate) * S,
        ty=uniform(4, 0.5 - cfg.translate, 0.5 + cfg.translate) * S,
        flip_u=u[5],
        gain=uniform(6, 1 - cfg.hsv_v, 1 + cfg.hsv_v),
    )


def _bilinear_taps(coords, size: int):
    """Per coordinate [B, S]: the two source indices, the second's weight and
    whether the coordinate is in [0, size - 1]."""
    c0 = torch.floor(coords)
    w1 = coords - c0
    i0 = c0.to(torch.long)
    inb = (coords >= 0) & (coords <= size - 1)
    return i0.clamp(0, size - 1), (i0 + 1).clamp(0, size - 1), w1, inb


def _rows(img, idx):
    """img [B, H, W], idx [B, S] -> img[b, idx[b], :] [B, S, W]."""
    return img.gather(1, idx[:, :, None].expand(-1, -1, img.shape[2]))


def _cols(img, idx):
    """img [B, S, W], idx [B, S] -> img[b, :, idx[b]] [B, S, S]."""
    return img.gather(2, idx[:, None, :].expand(-1, img.shape[1], -1))


def apply_batch(p: AugParams, images, instmaps, boxes, valid, cfg: AugConfig):
    """One augmented batch from the drawn parameters `p` (on the device of
    the inputs). images [B, T, H, W] float (0..255), instmaps [B, T, H, W]
    uint8, boxes [B, T, I, 4] source-pixel xyxy, valid [B, T, I] bool, with
    T = 4 tiles (1 with the mosaic off). Returns (image [B, S, S] float32,
    instmap [B, S, S] uint8, boxes [B, 4I, 4], valid [B, 4I])."""
    S = cfg.imgsz
    B, _, H, W = images.shape
    dev = images.device
    s, tx, ty = p.s[:, None], p.tx[:, None], p.ty[:, None]
    if cfg.mosaic:
        # the mosaic centre on the 2S x 2S canvas; tile k's corner meets it
        yc, xc = p.yc, p.xc
        offs_y = torch.stack([yc - H, yc - H, yc, yc], 1)
        offs_x = torch.stack([xc - W, xc, xc - W, xc], 1)
        canvas, n_tiles = 2 * S, 4
    else:
        # one image centred on an S canvas (letterbox placement)
        offs_y = torch.full((B, 1), (S - H) / 2.0, device=dev)
        offs_x = torch.full((B, 1), (S - W) / 2.0, device=dev)
        canvas, n_tiles = S, 1
    # output pixel o -> canvas point (o - t) / s + canvas / 2, each axis apart
    out_px = torch.arange(S, dtype=torch.float32, device=dev)[None, :]
    cy = (out_px - ty) / s + canvas / 2.0
    cx = (out_px - tx) / s + canvas / 2.0
    # tile content exists only inside the canvas: outside it, the border
    cyv = (cy >= 0) & (cy <= canvas - 1)
    cxv = (cx >= 0) & (cx <= canvas - 1)

    img_out = torch.full((B, S, S), 114.0, device=dev)
    inst_out = torch.zeros((B, S, S), dtype=torch.int32, device=dev)
    for k in range(n_tiles):
        ys = cy - offs_y[:, k : k + 1]
        xs = cx - offs_x[:, k : k + 1]
        y0, y1, wy, hy = _bilinear_taps(ys, H)
        x0, x1, wx, hx = _bilinear_taps(xs, W)
        img = images[:, k].to(torch.float32)
        rows = (1.0 - wy)[:, :, None] * _rows(img, y0) + wy[:, :, None] * _rows(img, y1)
        v = _cols(rows, x0) * (1.0 - wx)[:, None, :] + _cols(rows, x1) * wx[:, None, :]
        hit = (hy & cyv)[:, :, None] & (hx & cxv)[:, None, :]
        img_out = torch.where(hit, v, img_out)

        ny, nx = torch.round(ys).to(torch.long), torch.round(xs).to(torch.long)
        nyv, nxv = (ny >= 0) & (ny < H), (nx >= 0) & (nx < W)
        m = _cols(_rows(instmaps[:, k], ny.clamp(0, H - 1)), nx.clamp(0, W - 1)).to(torch.int32)
        nhit = (nyv & cyv)[:, :, None] & (nxv & cxv)[:, None, :] & (m > 0)
        inst_out = torch.where(nhit, m + k * cfg.max_inst, inst_out)

    # boxes: source -> canvas (clipped to it) -> output (clipped to it)
    all_boxes, all_valid = [], []
    for k in range(n_tiles):
        b = boxes[:, k]
        ox, oy = offs_x[:, k : k + 1], offs_y[:, k : k + 1]
        cx1 = (b[..., 0] + ox).clamp(0, canvas)
        cy1 = (b[..., 1] + oy).clamp(0, canvas)
        cx2 = (b[..., 2] + ox).clamp(0, canvas)
        cy2 = (b[..., 3] + oy).clamp(0, canvas)
        nb = torch.stack([
            ((cx1 - canvas / 2.0) * s + tx).clamp(0, S), ((cy1 - canvas / 2.0) * s + ty).clamp(0, S),
            ((cx2 - canvas / 2.0) * s + tx).clamp(0, S), ((cy2 - canvas / 2.0) * s + ty).clamp(0, S),
        ], -1)
        # upstream box_candidates: sides over 2 px, aspect under 100, and over
        # 1% of the pre-affine canvas box's area (which absorbs s^2)
        w2, h2 = nb[..., 2] - nb[..., 0], nb[..., 3] - nb[..., 1]
        w1, h1 = cx2 - cx1, cy2 - cy1
        eps = 1e-16
        ar = torch.maximum(w2 / (h2 + eps), h2 / (w2 + eps))
        ok = valid[:, k] & (w2 > 2) & (h2 > 2) & (ar < 100) & (w2 * h2 / (w1 * h1 + eps) > 0.01)
        all_boxes.append(nb)
        all_valid.append(ok)
    if not cfg.mosaic:
        pad_n = boxes.shape[2] * 3
        all_boxes.append(torch.zeros((B, pad_n, 4), device=dev))
        all_valid.append(torch.zeros((B, pad_n), dtype=torch.bool, device=dev))
    out_boxes = torch.cat(all_boxes, 1)
    out_valid = torch.cat(all_valid, 1)

    # horizontal flip
    flip = (p.flip_u < cfg.fliplr)[:, None, None]
    img_out = torch.where(flip, img_out.flip(2), img_out)
    inst_out = torch.where(flip, inst_out.flip(2), inst_out)
    fb = torch.stack([S - out_boxes[..., 2], out_boxes[..., 1], S - out_boxes[..., 0],
                      out_boxes[..., 3]], -1)
    out_boxes = torch.where(flip, fb, out_boxes)

    # brightness (the grayscale form of the HSV value jitter)
    img_out = (img_out * p.gain[:, None, None]).clamp(0, 255)
    return img_out, inst_out.to(torch.uint8), out_boxes, out_valid


def proto_centers(imgsz: int, device=None):
    """The stride-4 nearest samples of the proto-resolution map: 4i + 1."""
    return (torch.arange(imgsz // 4, device=device) * 4 + 1.5).to(torch.long)


def make_batch(params: AugParams, dataset: dict, idx, cfg: AugConfig = AugConfig()) -> dict:
    """One augmented training batch on the dataset's device.

    dataset: images [M, H, W] uint8, instmaps [M, H, W] uint8, boxes
    [M, I, 4] float32, valid [M, I] bool; idx [B, 4] source-slice indices
    (4 a mosaic; with the mosaic off only column 0 is read). Returns images
    [B, S, S, 3] float32 in [0, 1], instmap [B, S, S] uint8, instmap_proto
    [B, S/4, S/4] uint8, boxes [B, 4I, 4], valid [B, 4I]."""
    dev = dataset["images"].device
    idx = torch.as_tensor(idx, device=dev).to(torch.long)
    if not cfg.mosaic:
        idx = idx[:, :1]
    img, inst, boxes, valid = apply_batch(
        params.to(dev), dataset["images"][idx], dataset["instmaps"][idx],
        dataset["boxes"][idx], dataset["valid"][idx], cfg)
    c = proto_centers(cfg.imgsz, dev)
    return {
        "images": (img / 255.0)[..., None].expand(-1, -1, -1, 3),
        "instmap": inst,
        "instmap_proto": inst[:, c][:, :, c],
        "boxes": boxes,
        "valid": valid,
    }
