"""PNG interop at the filesystem boundary, with a self-contained codec.

Port of ``tpu_mslesseg/io/png.py``. The pipeline's on-disk artifact schema
stores slices/masks/predictions as PNGs (reference
`extraer_dataset.py:192-197`, `generar_predicciones.py:153`). All compute
stays in volume-slice space; these helpers apply the PNG-space transform and
8-bit conversion only when crossing the file boundary.

Where the JAX package leans on PIL, this module carries its own codec on the
standard library (``zlib``, ``struct``), as ``io/nifti.py`` does for NIfTI;
`save_gray` and `save_gray_batch` go through the native writer
(``io/native.py``) where it builds, which writes the same bytes. The codec
covers exactly what the pipeline stores:

* write: 8-bit grayscale (colour type 0), not interlaced, filter 0 on every
  row;
* read: 8-bit grayscale, not interlaced, all five row filters (None, Sub,
  Up, Average, Paeth), so trees written by PIL or by the JAX package's
  native writer read back pixel for pixel. Any other PNG (16-bit, RGB,
  palette, alpha, interlaced) raises a ``ValueError`` naming the file; the
  JAX package's `load_gray` would convert it to grayscale.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np
import torch

from tpu_mslesseg_torch.core import geometry
from tpu_mslesseg_torch.io import native

_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (
        struct.pack(">I", len(data)) + kind + data
        + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF)
    )


def encode_gray(array2d) -> bytes:
    """A 2D uint8 array as the bytes of an 8-bit grayscale PNG."""
    arr = np.asarray(array2d, dtype=np.uint8)
    if arr.ndim != 2 or 0 in arr.shape:
        raise ValueError(f"PNG de grises: se esperaba [H, W] no vacío, no {arr.shape}.")
    h, w = arr.shape
    rows = np.zeros((h, w + 1), np.uint8)  # column 0: filter type 0 (None)
    rows[:, 1:] = arr
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0)
    return (
        _SIGNATURE + _chunk(b"IHDR", ihdr)
        + _chunk(b"IDAT", zlib.compress(rows.tobytes(), native.ZLIB_LEVEL))
        + _chunk(b"IEND", b"")
    )


def _paeth_row(filt, prior):
    out = bytearray(len(filt))
    a = c = 0  # left, upper-left
    for x, (f, b) in enumerate(zip(filt.tolist(), prior.tolist())):
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
        a = (f + pred) & 0xFF
        out[x] = a
        c = b
    return np.frombuffer(bytes(out), np.uint8)


def _average_row(filt, prior):
    out = bytearray(len(filt))
    a = 0
    for x, (f, b) in enumerate(zip(filt.tolist(), prior.tolist())):
        a = (f + ((a + b) >> 1)) & 0xFF
        out[x] = a
    return np.frombuffer(bytes(out), np.uint8)


def _unfilter(rows: np.ndarray, path) -> np.ndarray:
    """Undo the row filters of an 8-bit grayscale image. `rows`: [H, 1+W]
    uint8, the filter type in column 0. Sub and Up are whole-row numpy
    operations (uint8 arithmetic wraps modulo 256, as the format asks);
    Average and Paeth depend on the pixel to the left and run pixel by pixel."""
    types, filt = rows[:, 0], rows[:, 1:]
    if not types.any():
        return np.ascontiguousarray(filt)
    out = np.empty_like(filt)
    prior = np.zeros(filt.shape[1], np.uint8)
    for y, t in enumerate(types.tolist()):
        if t == 0:
            out[y] = filt[y]
        elif t == 1:
            out[y] = np.cumsum(filt[y], dtype=np.uint8)
        elif t == 2:
            out[y] = filt[y] + prior
        elif t == 3:
            out[y] = _average_row(filt[y], prior)
        elif t == 4:
            out[y] = _paeth_row(filt[y], prior)
        else:
            raise ValueError(f"PNG inválido (filtro de fila {t}): {path}")
        prior = out[y]
    return out


def decode_gray(raw: bytes, path="<bytes>") -> np.ndarray:
    """The pixels [H, W] uint8 of an 8-bit grayscale, non-interlaced PNG."""
    if raw[:8] != _SIGNATURE:
        raise ValueError(f"No es un PNG: {path}")
    pos, ihdr, idat = 8, None, []
    while pos + 8 <= len(raw):
        (length,) = struct.unpack_from(">I", raw, pos)
        kind = raw[pos + 4 : pos + 8]
        data = raw[pos + 8 : pos + 8 + length]
        (crc,) = struct.unpack_from(">I", raw, pos + 8 + length)
        if len(data) != length or zlib.crc32(kind + data) & 0xFFFFFFFF != crc:
            raise ValueError(f"PNG corrupto (CRC de {kind!r}): {path}")
        pos += 12 + length
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", data)
        elif kind == b"IDAT":
            idat.append(data)
        elif kind == b"IEND":
            break
    if ihdr is None or not idat:
        raise ValueError(f"PNG incompleto: {path}")
    w, h, depth, colour, compression, filter_method, interlace = ihdr
    if (depth, colour, compression, filter_method, interlace) != (8, 0, 0, 0, 0):
        raise ValueError(
            f"PNG no soportado (se leen solo grises de 8 bits sin entrelazar; "
            f"bits={depth}, color={colour}, entrelazado={interlace}): {path}"
        )
    flat = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if flat.size != h * (w + 1):
        raise ValueError(f"PNG corrupto (tamaño de datos): {path}")
    return _unfilter(flat.reshape(h, w + 1), path)


def save_gray(path, array2d):
    """Save a 2D uint8 array as a grayscale PNG (native encoder when the
    hostio library is available, `encode_gray` otherwise: the same bytes)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    arr = np.asarray(array2d, dtype=np.uint8)
    if native.write_gray_png(path, arr):
        return
    path.write_bytes(encode_gray(arr))


def save_gray_batch(paths, arrays):
    """Write a batch of grayscale PNGs (OpenMP-parallel native writer, with
    a serial `encode_gray` fallback that rewrites the batch and raises the
    error of a file that cannot be written). arrays: [N, H, W] uint8."""
    paths = [Path(p) for p in paths]
    for d in dict.fromkeys(p.parent for p in paths):
        d.mkdir(parents=True, exist_ok=True)
    arrays = np.asarray(arrays, dtype=np.uint8)
    if len(paths) and native.write_gray_png_batch(paths, arrays):
        return
    for p, a in zip(paths, arrays):
        p.write_bytes(encode_gray(a))


def load_gray(path) -> np.ndarray:
    """Load a PNG as grayscale uint8 (reference `cargar_png`,
    ``utils/utils.py:364-369``)."""
    return decode_gray(Path(path).read_bytes(), path)


def save_slice_png(path, slice2d):
    """Volume-space slice -> reference-format PNG (min-max 8-bit,
    transposed/flipped as `plt.imsave(corte.T, origin="lower")` does)."""
    png = geometry.to_png_space(torch.as_tensor(np.asarray(slice2d)))
    save_gray(path, geometry.minmax_to_uint8(png).numpy())


def save_mask_png(path, mask2d, binary_01=True):
    """Volume-space binary mask -> PNG with values {0,1} (reference
    normalizes masks to {0,1} before label conversion,
    ``utils/utils.py:387-393``)."""
    png = geometry.to_png_space(torch.as_tensor(np.asarray(mask2d))).numpy()
    vals = (png > 0).astype(np.uint8)
    save_gray(path, vals if binary_01 else vals * 255)


def save_pred_png(path, pred2d_volspace):
    """Volume-space binary prediction -> PNG {0,255} in *stored-pred*
    orientation. The reference stores `cv2.flip(pred.T, 1) * 255`
    (``generar_predicciones.py:136-153``) which equals the volume-space
    slice itself (the transforms cancel), so this writes the slice raw."""
    vals = (np.asarray(pred2d_volspace) > 0).astype(np.uint8) * 255
    save_gray(path, vals)


def load_pred_png(path) -> np.ndarray:
    """Stored prediction PNG -> volume-space binary slice (reference
    `reconstruir_volumen.py:136-151` loads channel 0 and binarizes; stored
    orientation already is volume-space)."""
    return (load_gray(path) > 0).astype(np.float32)


def load_slice_png_volspace(path) -> np.ndarray:
    """Image/GT PNG (stored in PNG space) -> volume-space float array."""
    vol = geometry.from_png_space(torch.from_numpy(load_gray(path)))
    return vol.numpy().astype(np.float32)
