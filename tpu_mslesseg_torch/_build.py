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


def _lib_path(name: str) -> Path:
    src = _CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return _BUILD / f"lib{name}-{digest}.so"


def load_all(names) -> dict[str, ctypes.CDLL]:
    """The built libraries for ``csrc/<name>.cu`` of each name; builds the
    missing ones with one ``nvcc`` each, all started together."""
    with _lock:
        todo = [n for n in dict.fromkeys(names) if n not in _libs]
        jobs = {}
        for name in todo:
            lib_path = _lib_path(name)
            if lib_path.exists():
                continue
            _BUILD.mkdir(exist_ok=True)
            tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_CSRC / f"{name}.cu")]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            jobs[name] = (proc, tmp, lib_path)
        failed = []
        for name, (proc, tmp, lib_path) in jobs.items():
            _, err = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"nvcc failed for {name}.cu (rc {proc.returncode}):\n{err}")
                continue
            os.replace(tmp, lib_path)
            build_logs[name] = err
        if failed:
            raise RuntimeError("\n".join(failed))
        for name in todo:
            _libs[name] = ctypes.CDLL(str(_lib_path(name)))
        return {n: _libs[n] for n in names}


def load(name: str) -> ctypes.CDLL:
    """The built library for ``csrc/<name>.cu``; builds it if needed."""
    return load_all([name])[name]
