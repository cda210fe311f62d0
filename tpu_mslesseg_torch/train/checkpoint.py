"""Checkpoints: best/last/epoch files, the fitness note, resume.

Port of ``tpu_mslesseg/train/checkpoint.py``. The port's checkpoints are
torch files, the reference's ``best.pt``/``last.pt`` contract, where the
JAX package keeps Orbax directories ``best.ckpt``/``last.ckpt``:

* ``weights/best.pt`` (and ``epoch<N>.pt``): a state_dict with the model's
  (ultralytics) key names, the EMA parameters with the BatchNorm
  statistics and a 3-channel stem — what ``SlicePredictor`` and ``rapido``
  serve;
* ``weights/last.pt``: a ``TrainState.state_dict()``, for resuming;
* ``weights/fitness.json``: the best fitness and its epoch.

Every file is written crash-safe and read with ``torch.load(weights_only=
True)``: nothing but tensors, numbers, strings and containers is unpickled.
Weights trained by the JAX package cross to a state_dict through
``model.bridge`` in a process that has both packages.
"""

from __future__ import annotations

import json
import os
from pathlib import Path

import torch


def _to_cpu(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


def save_checkpoint(path, state_dict) -> None:
    """Write `state_dict` (tensors moved to the CPU, nested containers
    allowed) to `path`, crash-safe: a sibling temporary file, then an atomic
    rename, so a kill mid-save leaves the previous checkpoint whole."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    torch.save(_to_cpu(state_dict), tmp)
    os.replace(tmp, path)


def load_checkpoint(path) -> dict:
    """The checkpoint in `path`, on the CPU (tensors, numbers, strings and
    containers only: nothing else in the file is unpickled)."""
    return torch.load(Path(path), weights_only=True, map_location="cpu")


def checkpoint_exists(path) -> bool:
    return Path(path).is_file()


def write_fitness(weights_dir, best_fit: float, best_epoch: int) -> None:
    Path(weights_dir, "fitness.json").write_text(
        json.dumps({"best_fitness": best_fit, "best_epoch": best_epoch}))


def load_stopper_state(weights_dir, start_epoch: int):
    """The resumed best fitness and early-stopping state, ``(best_fit,
    best_epoch)``, from ``<weights_dir>/fitness.json``. A ``best.pt`` without
    its note gets a floor of 1e-12, not 0.0: fitness is never negative and
    the improvement test is ``fit >= best``, so a 0.0 floor would let a
    zero-fitness epoch replace a good checkpoint and reset the patience."""
    weights = Path(weights_dir)
    best_fit, best_epoch = -1.0, start_epoch - 1
    if start_epoch > 1:
        ff = weights / "fitness.json"
        if ff.exists():
            try:
                note = json.loads(ff.read_text())
                best_fit = float(note["best_fitness"])
                best_epoch = int(note.get("best_epoch", best_epoch))
            except (ValueError, KeyError, TypeError):
                pass
        if best_fit < 0 and checkpoint_exists(weights / "best.pt"):
            best_fit = 1e-12
    return best_fit, best_epoch
