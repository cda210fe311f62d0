"""Builds the CUDA sources under ``csrc/`` on first use and loads them.

Each ``csrc/<name>.cu`` has a plain C interface. It is compiled by ``nvcc``
for Hopper (``sm_90a``) into a shared library under ``_build/`` (git
ignored), keyed by a hash of the source, and loaded with ``ctypes``.
Nothing is built at import, so importing the package needs no CUDA
toolkit.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_CSRC = Path(__file__).parent / "csrc"
_BUILD = Path(__file__).parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# name -> nvcc's stderr from the build in this process (ptxas register and
# shared-memory report), for the record
build_logs: dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for root in filter(None, (home, "/usr/local/cuda")):
        cand = Path(root) / "bin" / "nvcc"
        if cand.exists():
            return str(cand)
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda)")


def load(name: str) -> ctypes.CDLL:
    """The built library for ``csrc/<name>.cu``; builds it if needed."""
    with _lock:
        if name in _libs:
            return _libs[name]
        src = _CSRC / f"{name}.cu"
        digest = hashlib.sha256(
            src.read_bytes() + " ".join(NVCC_FLAGS).encode()
        ).hexdigest()[:16]
        lib_path = _BUILD / f"lib{name}-{digest}.so"
        if not lib_path.exists():
            _BUILD.mkdir(exist_ok=True)
            tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed for {src.name} (rc {proc.returncode}):\n"
                    f"{proc.stderr}"
                )
            os.replace(tmp, lib_path)
            build_logs[name] = proc.stderr
        lib = ctypes.CDLL(str(lib_path))
        _libs[name] = lib
        return lib
