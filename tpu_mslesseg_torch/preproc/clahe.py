"""CLAHE tile LUTs: plain PyTorch version and the CUDA kernel's wrapper.

One LUT per (image, 8x8 tile) of an L-channel uint8 image, with OpenCV's
CLAHE algorithm: a 256-bin histogram of the tile's pixels (the image
extended by REFLECT_101 to a whole number of tiles), clipped at ``limit``,
the clipped excess redistributed (a uniform share to every bin, then one
more count at every ``step``-th bin for the residual), and the scaled CDF
rounded half to even and clipped to [0, 255].

``tile_luts_ref`` is the plain version over ``[T, tile_area]`` tiles, as
``tpu_mslesseg/preproc/enhance.py::_clahe_core``'s ``tile_lut`` computes
it; ``clahe_tile_luts`` cuts an image batch into tiles for it on the CPU
and runs ``csrc/clahe_tile_lut.cu`` on a CUDA tensor, which replaces the
reference's Pallas ``_tile_lut_kernel`` (``preproc/clahe_pallas.py``).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from tpu_mslesseg_torch import _build

# kernel launches by `clahe_tile_luts` in this process
LAUNCHES = 0


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


def _lib():
    lib = _build.load("clahe_tile_lut")
    fn = lib.clahe_tile_luts
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, i, i, i, i, i, i, i, i, ctypes.c_float, p]
        fn.restype = ctypes.c_int
    return fn


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
    if l_imgs.dtype != torch.uint8:
        raise TypeError(f"CLAHE tile LUTs: images must be uint8, got {l_imgs.dtype}")
    if l_imgs.ndim != 3:
        raise ValueError(f"CLAHE tile LUTs: images must be [N, H, W], got {tuple(l_imgs.shape)}")
    n, h, w = l_imgs.shape
    if not (tiles_x > 0 and tiles_y > 0 and h >= tiles_y and w >= tiles_x):
        raise ValueError(f"CLAHE tile LUTs: {h}x{w} image, {tiles_y}x{tiles_x} tiles")
    th, tw, area, limit = tile_geometry(h, w, clip_limit, tiles_x, tiles_y)
    # REFLECT_101 reaches back at most one tile: the extension must fit
    if th * tiles_y - h >= h or tw * tiles_x - w >= w:
        raise ValueError(f"CLAHE tile LUTs: {h}x{w} image too small for its tiles")
    if not (0 < n <= 65535):
        raise ValueError(f"CLAHE tile LUTs: 1 to 65535 images per launch, got {n}")
    imgs = l_imgs.contiguous()
    out = torch.empty((n, tiles_y * tiles_x, 256), dtype=torch.float32, device=imgs.device)
    fn = _lib()
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
