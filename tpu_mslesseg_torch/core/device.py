"""The device gate of the entry points.

Every entry point that computes takes ``device="cuda"`` and runs there or
not at all: `exigir` raises before any work when the device cannot be used,
and on a CUDA device it builds and loads the kernels the stage will launch,
so a source that does not compile stops the stage before its first patient.
Inside a stage's per-patient warn-and-continue handling,
`es_fallo_de_dispositivo` tells a failure of the card or of a kernel (which
the next patient would meet again) from a patient's own data error: the
first is raised again, the second is warned about and skipped. Nothing
carries on on the CPU unasked: it is used only when the caller names it.
"""

from __future__ import annotations

import torch


class SinInstanciaDeKernel(RuntimeError):
    """A switched-on kernel holds no instance for the served model's shapes:
    a failure of the kernel (every patient would meet it), not of a patient."""


def exigir(device, kernels=()) -> torch.device:
    """`device` as a ``torch.device``, after one allocation on it and, on a
    CUDA device, with ``csrc/<name>.cu`` built and loaded for each name in
    `kernels`; raises ``RuntimeError`` when either fails."""
    dev = torch.device(device)
    try:
        torch.empty(1, device=dev)
    except (RuntimeError, AssertionError) as e:
        raise RuntimeError(f"Dispositivo '{dev}' no disponible: {e}") from e
    if dev.type == "cuda" and kernels:
        from tpu_mslesseg_torch import _build

        _build.load_all(tuple(kernels))
    return dev


def kernels_de(mejora, stem: bool = False, union: bool = False) -> tuple:
    """The CUDA sources a stage launches: CLAHE's under ``--mejora CLAHE``,
    the fused stem's when it is switched on, the mask union's when the stage
    predicts."""
    names = []
    if mejora == "CLAHE":
        names.append("clahe_tile_lut")
    if stem:
        names.append("stem")
    if union:
        names.append("mask_union")
    return tuple(names)


def es_fallo_de_dispositivo(e: BaseException) -> bool:
    """True for a failure of the card or of a kernel (a build that failed, a
    launch that failed, a CUDA error, device memory exhausted, a served
    model the switched-on fused stem holds no kernel instance for); False
    for anything else, such as a patient's unreadable file."""
    if isinstance(e, (torch.OutOfMemoryError, SinInstanciaDeKernel)):
        return True
    return isinstance(e, RuntimeError) and any(
        mark in str(e) for mark in ("CUDA", "nvcc", "kernel launch failed")
    )
