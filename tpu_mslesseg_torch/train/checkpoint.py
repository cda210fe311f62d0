"""Checkpoints: the read side, and a save for tests and smoke runs.

Port of ``tpu_mslesseg/train/checkpoint.py``'s read side. The port's
checkpoint is ``weights/best.pt``: a torch state_dict with the model's
(ultralytics) key names, the reference's own ``best.pt`` contract, where the
JAX package keeps an Orbax directory ``best.ckpt``. Weights trained by the
JAX package cross to a state_dict through ``model.bridge`` in a process
that has both packages; this package reads no Orbax. Saving during training
comes with the training slice.
"""

from __future__ import annotations

import os
from pathlib import Path

import torch


def save_checkpoint(path, state_dict) -> None:
    """Write `state_dict` (tensors, moved to the CPU) to `path`, crash-safe:
    a sibling temporary file, then an atomic rename, so a kill mid-save
    leaves the previous checkpoint whole."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    torch.save({k: v.detach().cpu() for k, v in state_dict.items()}, tmp)
    os.replace(tmp, path)


def load_checkpoint(path) -> dict:
    """The state_dict in `path`, on the CPU (tensors only: nothing else in
    the file is unpickled)."""
    return torch.load(Path(path), weights_only=True, map_location="cpu")


def checkpoint_exists(path) -> bool:
    return Path(path).is_file()
