"""ctypes bindings for the native host IO library (``csrc/hostio.cc``).

Port of ``tpu_mslesseg/io/native.py``. Builds the shared library on first
use (``g++ -O3 -shared -fPIC -fopenmp ... -lz``) into the package's
``_build/`` (git-ignored), rebuilding it when the source is newer, and
exposes:

* `write_gray_png(path, img)`         — single PNG
* `write_gray_png_batch(paths, imgs)` — OpenMP-parallel batch writer
* `gzip_bytes(data)`                  — gzip container compression

The PNG bytes are those of `io.png.encode_gray`: filter 0 on every row, zlib
level `ZLIB_LEVEL` (one constant for both writers), one IDAT chunk. Where
the library cannot be built or loaded, `available()` is False, one warning
carries the compiler's (or loader's) error, and `io.png` writes through
`encode_gray` instead (the JAX package falls back to PIL).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

from tpu_mslesseg_torch.pipeline.logging_setup import get_logger

logger = get_logger(__file__)

_PKG = Path(__file__).resolve().parents[1]
_SRC = _PKG / "csrc" / "hostio.cc"
_LIB = _PKG / "_build" / "libhostio.so"
CXX = "g++"
# the zlib level of every PNG the port writes, natively or through
# `io.png.encode_gray`: the two give the same bytes only at the same level
ZLIB_LEVEL = 6

_lock = threading.Lock()
_lib = None
_tried = False
# why the library is not available, for the record ("" while it is)
build_error = ""


def _build() -> str:
    """Compile `_SRC` into `_LIB`; the compiler's error, or "" on success.
    The library is written under a temporary name and moved into place, so a
    process that loads it never sees a half-written file."""
    _LIB.parent.mkdir(parents=True, exist_ok=True)
    tmp = _LIB.with_name(f"{_LIB.name}.{os.getpid()}.tmp")
    cmd = [CXX, "-O3", "-shared", "-fPIC", "-fopenmp", str(_SRC), "-lz", "-o", str(tmp)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True, timeout=120)
    except subprocess.CalledProcessError as e:
        return f"{' '.join(cmd)} (rc {e.returncode}): {e.stderr.strip()}"
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"{' '.join(cmd)}: {e}"
    os.replace(tmp, _LIB)
    return ""


def _load():
    global _lib, _tried, build_error
    with _lock:
        if _tried:
            return _lib
        _tried = True
        err = ""
        if not _LIB.exists() or _LIB.stat().st_mtime < _SRC.stat().st_mtime:
            err = _build()
        if not err:
            try:
                lib = ctypes.CDLL(str(_LIB))
            except OSError as e:
                err = f"{_LIB}: {e}"
        if err:
            build_error = err
            logger.warning(
                f"⚠️ hostio nativo no disponible; los PNG se escriben en Python: {err}"
            )
            return None
        lib.hostio_write_gray_png.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ]
        lib.hostio_write_gray_png.restype = ctypes.c_int
        lib.hostio_write_gray_png_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ]
        lib.hostio_write_gray_png_batch.restype = ctypes.c_int
        lib.hostio_gzip.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_long,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_long, ctypes.c_int,
        ]
        lib.hostio_gzip.restype = ctypes.c_long
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def write_gray_png(path, img: np.ndarray) -> bool:
    lib = _load()
    if lib is None:
        return False
    img = np.ascontiguousarray(img, dtype=np.uint8)
    if img.ndim != 2:
        raise ValueError(f"write_gray_png: se esperaba [H, W], no {img.shape}.")
    h, w = img.shape
    rc = lib.hostio_write_gray_png(
        str(path).encode(), img.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        h, w, ZLIB_LEVEL,
    )
    return rc == 0


def write_gray_png_batch(paths, imgs: np.ndarray) -> bool:
    """Write imgs[i] -> paths[i] in parallel, on OpenMP's default thread
    count. imgs: [N, H, W] uint8. False when the library is missing or any
    file failed (the others are written)."""
    lib = _load()
    if lib is None:
        return False
    imgs = np.ascontiguousarray(imgs, dtype=np.uint8)
    if imgs.ndim != 3 or imgs.shape[0] != len(paths):
        raise ValueError(
            f"write_gray_png_batch: {len(paths)} rutas para imágenes {imgs.shape}."
        )
    n, h, w = imgs.shape
    arr = (ctypes.c_char_p * n)(*[str(p).encode() for p in paths])
    failures = lib.hostio_write_gray_png_batch(
        arr, imgs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        n, h, w, ZLIB_LEVEL, 0,  # 0 threads: OpenMP's default
    )
    return failures == 0


def gzip_bytes(data: bytes, level: int = 1) -> bytes | None:
    lib = _load()
    if lib is None:
        return None
    src = np.frombuffer(data, dtype=np.uint8)
    cap = len(data) + (len(data) >> 9) + 64
    out = np.empty(cap, dtype=np.uint8)
    n = lib.hostio_gzip(
        src.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(data),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), cap, level,
    )
    if n < 0:
        return None
    return out[:n].tobytes()
