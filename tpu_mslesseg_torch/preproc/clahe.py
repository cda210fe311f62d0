"""CLAHE's two kernels: the tile LUTs and the blend that applies them, each
a plain PyTorch version and the CUDA kernel's wrapper.

Tile LUTs: one LUT per (image, 8x8 tile) of an L-channel uint8 image, with
OpenCV's CLAHE algorithm: a 256-bin histogram of the tile's pixels (the
image extended by REFLECT_101 to a whole number of tiles), clipped at
``limit``, the clipped excess redistributed (a uniform share to every bin,
then one more count at every ``step``-th bin for the residual), and the
scaled CDF rounded half to even and clipped to [0, 255].
``tile_luts_ref`` is the plain version over ``[T, tile_area]`` tiles, as
``tpu_mslesseg/preproc/enhance.py::_clahe_core``'s ``tile_lut`` computes
it; ``clahe_tile_luts`` cuts an image batch into tiles for it on the CPU
and runs ``csrc/clahe_tile_lut.cu`` on a CUDA tensor, which replaces the
reference's Pallas ``_tile_lut_kernel`` (``preproc/clahe_pallas.py``).

Blend: each pixel the bilinear blend of its four nearest tiles' LUT
entries, rounded half to even, clipped, then mapped through a 256-entry
table (the backward LAB map), as ``_clahe_core`` and ``clahe_batch``
compute it after the LUTs. ``clahe_blend_ref`` is the plain version;
``clahe_blend`` runs the second kernel of ``csrc/clahe_tile_lut.cu`` on a
CUDA tensor.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from tpu_mslesseg_torch import _build

# kernel launches by `clahe_tile_luts` and by `clahe_blend` in this process
LAUNCHES = 0
BLEND_LAUNCHES = 0


def tile_geometry(h: int, w: int, clip_limit: float = 2.0, tiles_x: int = 8,
                  tiles_y: int = 8):
    """(tile height, tile width, tile area, clip limit) of an h x w image,
    as OpenCV sizes them."""
    tw = -(-w // tiles_x)
    th = -(-h // tiles_y)
    area = tw * th
    return th, tw, area, max(int(clip_limit * area / 256), 1)


def lut_scale(tile_area: int) -> torch.Tensor:
    """The reference's CDF scale: ``255.0 / tile_area`` taken in double,
    then rounded once to float32 (a Python float against an f32 array)."""
    return torch.tensor(np.float32(255.0 / tile_area))


def _reflect101(n: int, size: int, device) -> torch.Tensor:
    """Source indices of a REFLECT_101 extension of length n to `size`."""
    i = torch.arange(size, device=device)
    return torch.where(i < n, i, 2 * (n - 1) - i)


def image_tiles(l_imgs, tiles_x: int = 8, tiles_y: int = 8) -> torch.Tensor:
    """[N, H, W] -> [N * tiles_y * tiles_x, tile_area] int64 tile pixels
    (tile t = ty * tiles_x + tx, pixels row-major)."""
    n, h, w = l_imgs.shape
    th, tw, area, _ = tile_geometry(h, w, 2.0, tiles_x, tiles_y)
    dev = l_imgs.device
    ext = l_imgs.index_select(1, _reflect101(h, th * tiles_y, dev))
    ext = ext.index_select(2, _reflect101(w, tw * tiles_x, dev))
    tiles = ext.reshape(n, tiles_y, th, tiles_x, tw).permute(0, 1, 3, 2, 4)
    return tiles.reshape(n * tiles_y * tiles_x, area).long()


def tile_luts_ref(tiles, tile_area: int, limit: int) -> torch.Tensor:
    """Plain version: tile pixels [T, tile_area] int -> LUTs [T, 256] f32."""
    t = tiles.shape[0]
    dev = tiles.device
    hist = torch.zeros((t, 256), dtype=torch.long, device=dev)
    hist.scatter_add_(1, tiles.long(), torch.ones_like(tiles, dtype=torch.long))
    clipped = (hist - limit).clamp(min=0).sum(dim=1, keepdim=True)
    hist = hist.clamp(max=limit)
    rb = clipped // 256
    residual = clipped - rb * 256
    step = (256 // residual.clamp(min=1)).clamp(min=1)
    bins = torch.arange(256, device=dev)[None, :]
    bonus = ((bins % step == 0) & (bins // step < residual)).long()
    cdf = (hist + rb + bonus).cumsum(dim=1).to(torch.float32)
    return torch.round(cdf * lut_scale(tile_area).to(dev)).clamp(0, 255)


def clahe_tile_luts_ref(l_imgs, clip_limit: float = 2.0, tiles_x: int = 8,
                        tiles_y: int = 8) -> torch.Tensor:
    """Plain version over an image batch: [N, H, W] uint8 -> LUTs
    [N, tiles_y * tiles_x, 256] f32, on the images' device."""
    n, h, w = l_imgs.shape
    _, _, area, limit = tile_geometry(h, w, clip_limit, tiles_x, tiles_y)
    luts = tile_luts_ref(image_tiles(l_imgs, tiles_x, tiles_y), area, limit)
    return luts.reshape(n, tiles_y * tiles_x, 256)


def _fma_f32(a, b, c):
    """f32 ``a * b + c`` rounded once, as the reference's compiled program
    computes it (XLA contracts the multiply and the add into one FMA). Here
    the float64 product and sum are exact, so one rounding remains."""
    return (a.to(torch.float64) * b.to(torch.float64) + c).to(torch.float32)


def _recip(tile: int) -> np.float32:
    return np.float32(1.0 / tile)


def clahe_blend_ref(l_imgs, luts, out_map, tiles_x: int = 8, tiles_y: int = 8):
    """Plain version of the blend: L images [N, H, W] uint8 and their LUTs
    [N, tiles_y * tiles_x, 256] f32 -> [N, H, W] uint8, each pixel the
    four-LUT bilinear blend rounded half to even and clipped, then mapped
    through `out_map` [256] uint8.

    The float32 arithmetic is the reference's compiled program's:
    ``x / tile - 0.5`` is a multiply by the float32 reciprocal fused with
    the subtraction, and each ``a*u + b*v`` is ``fma(a, u, b*v)``."""
    n, H, W = l_imgs.shape
    th, tw, _, _ = tile_geometry(H, W, 2.0, tiles_x, tiles_y)
    dev = l_imgs.device

    def coords(size, tile, count):
        recip = torch.tensor(_recip(tile), device=dev)
        f = _fma_f32(torch.arange(size, dtype=torch.float32, device=dev), recip, -0.5)
        i = torch.floor(f).to(torch.long)
        return f - i, i.clamp(0, count - 1), (i + 1).clamp(0, count - 1)

    ya, ty1, ty2 = coords(H, th, tiles_y)
    xa, tx1, tx2 = coords(W, tw, tiles_x)
    ya, xa = ya[:, None], xa[None, :]
    v = l_imgs.long().reshape(n, -1)
    flat = luts.reshape(n, -1)

    def gather(ty, tx):  # luts[n, ty[y], tx[x], v[n, y, x]]
        at = ((ty[:, None] * tiles_x + tx[None, :]) * 256).reshape(1, -1)
        return flat.gather(1, at + v).reshape(n, H, W)

    top = _fma_f32(gather(ty1, tx1), 1 - xa, gather(ty1, tx2) * xa)
    bottom = _fma_f32(gather(ty2, tx1), 1 - xa, gather(ty2, tx2) * xa)
    res = _fma_f32(top, 1 - ya, bottom * ya)
    return out_map[torch.round(res).clamp(0, 255).long()]


def _fn(name: str, argtypes):
    fn = getattr(_build.load("clahe_tile_lut"), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _aligned(t):
    """`t` contiguous at a 16-byte aligned address (the kernels' vector
    loads), copied if it is not."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _check_images(what: str, l_imgs, tiles_x: int, tiles_y: int):
    if l_imgs.dtype != torch.uint8:
        raise TypeError(f"{what}: images must be uint8, got {l_imgs.dtype}")
    if l_imgs.ndim != 3:
        raise ValueError(f"{what}: images must be [N, H, W], got {tuple(l_imgs.shape)}")
    n, h, w = l_imgs.shape
    if not (tiles_x > 0 and tiles_y > 0 and h >= tiles_y and w >= tiles_x):
        raise ValueError(f"{what}: {h}x{w} image, {tiles_y}x{tiles_x} tiles")
    if not (0 < n <= 65535):
        raise ValueError(f"{what}: 1 to 65535 images per launch, got {n}")


def clahe_tile_luts(l_imgs, clip_limit: float = 2.0, tiles_x: int = 8,
                    tiles_y: int = 8) -> torch.Tensor:
    """CLAHE tile LUTs of an L-channel batch: [N, H, W] uint8 -> [N,
    tiles_y * tiles_x, 256] f32. A CPU tensor goes to the plain version; a
    CUDA tensor to the kernel, or this raises."""
    global LAUNCHES
    if l_imgs.device.type == "cpu":
        return clahe_tile_luts_ref(l_imgs, clip_limit, tiles_x, tiles_y)
    if l_imgs.device.type != "cuda":
        raise ValueError(f"CLAHE tile LUTs: no kernel for device {l_imgs.device}")
    _check_images("CLAHE tile LUTs", l_imgs, tiles_x, tiles_y)
    n, h, w = l_imgs.shape
    th, tw, area, limit = tile_geometry(h, w, clip_limit, tiles_x, tiles_y)
    # REFLECT_101 reaches back at most one tile: the extension must fit
    if th * tiles_y - h >= h or tw * tiles_x - w >= w:
        raise ValueError(f"CLAHE tile LUTs: {h}x{w} image too small for its tiles")
    imgs = _aligned(l_imgs)
    out = torch.empty((n, tiles_y * tiles_x, 256), dtype=torch.float32, device=imgs.device)
    fn = _fn("clahe_tile_luts", [_P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F, _P])
    with torch.cuda.device(imgs.device):
        err = fn(
            imgs.data_ptr(), out.data_ptr(), n, h, w, tiles_x, tiles_y, th, tw,
            limit, float(lut_scale(area)),
            torch.cuda.current_stream(imgs.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"CLAHE tile-LUT kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    return out


def clahe_blend(l_imgs, luts, out_map, tiles_x: int = 8, tiles_y: int = 8):
    """The blend of L images [N, H, W] uint8 with their LUTs [N, tiles_y *
    tiles_x, 256] f32 (as `clahe_tile_luts` makes them), each pixel mapped
    through `out_map` [256] uint8 -> [N, H, W] uint8. A CPU tensor goes to
    the plain version; a CUDA tensor to the kernel, or this raises."""
    global BLEND_LAUNCHES
    if l_imgs.device.type == "cpu":
        return clahe_blend_ref(l_imgs, luts, out_map, tiles_x, tiles_y)
    if l_imgs.device.type != "cuda":
        raise ValueError(f"CLAHE blend: no kernel for device {l_imgs.device}")
    _check_images("CLAHE blend", l_imgs, tiles_x, tiles_y)
    n, h, w = l_imgs.shape
    if luts.dtype != torch.float32 or tuple(luts.shape) != (n, tiles_y * tiles_x, 256):
        raise ValueError(f"CLAHE blend: LUTs must be f32 {(n, tiles_y * tiles_x, 256)}, "
                         f"got {luts.dtype} {tuple(luts.shape)}")
    if out_map.dtype != torch.uint8 or tuple(out_map.shape) != (256,):
        raise ValueError(f"CLAHE blend: the map must be uint8 [256], got {out_map.dtype} "
                         f"{tuple(out_map.shape)}")
    if luts.device != l_imgs.device or out_map.device != l_imgs.device:
        raise ValueError("CLAHE blend: images, LUTs and map must be on one device")
    th, tw, _, _ = tile_geometry(h, w, 2.0, tiles_x, tiles_y)
    imgs, luts, out_map = _aligned(l_imgs), _aligned(luts), out_map.contiguous()
    out = torch.empty_like(imgs)
    fn = _fn("clahe_blend", [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _F, _P])
    with torch.cuda.device(imgs.device):
        err = fn(
            imgs.data_ptr(), luts.data_ptr(), out_map.data_ptr(), out.data_ptr(), n, h, w,
            tiles_x, tiles_y, th, tw, float(_recip(th)), float(_recip(tw)),
            torch.cuda.current_stream(imgs.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"CLAHE blend kernel launch failed: CUDA error {err}")
    BLEND_LAUNCHES += 1
    return out
