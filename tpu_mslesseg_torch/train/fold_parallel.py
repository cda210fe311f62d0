"""All cross-validation folds at once: one state a fold over one shared pool.

Port of ``tpu_mslesseg/train/fold_parallel.py``. The folds are independent,
so they train side by side: every fold draws its batches from its own
patients' rows of one slice pool on the device, and each micro-step
advances every fold. The JAX package stacks the folds' states on a leading
axis and maps one compiled step over them (``lax.map`` for the folds a
device holds, ``shard_map`` over the mesh's ``fold`` axis); here the form
is a list of per-fold ``TrainState``s, each advanced one micro-step in turn
(`fold_step`), and a fold slot of several ranks splits each fold's batch
over its data axis (``core.mesh``). The JAX package's one-dispatch epoch
(``fold_key_chain``, ``make_multi_fold_epoch_fn``) is a form for its TPU:
an epoch is a Python loop over micro-steps.

The draw is not the sequential engine's. Each micro-step draws ``batch x 4``
source rows *with replacement* from the fold's pool (``randint(0,
count)``), then the augmentation's parameters, both from the fold's own
generator (``TrainState.gen``, seeded ``seed + fold``), which its checkpoint
carries, so a resumed run draws what the uninterrupted one draws. Over a
data axis every rank draws the whole batch and takes its share of the rows
and of the parameters: each share is augmented apart (the reference folds
the data index into its augmentation key) and the ranks' generators stay
in step.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from tpu_mslesseg_torch.model.yolo11 import init_variables
from tpu_mslesseg_torch.train import augment, trainer
from tpu_mslesseg_torch.train.trainer import TrainConfig, TrainState


def plan_fold_mesh(n_devices: int, k_folds: int):
    """Factorize devices into a (fold, data) grid that never degenerates.

    Returns (fold_par, k_pad): fold-axis size and the padded fold count
    (a multiple of fold_par; folds beyond k_folds are dummies whose
    results are discarded). The fold axis is the smallest divisor of
    n_devices that covers every real fold; leftover devices become the
    data axis and shard each fold's batch. Examples:
      8 dev x 5 folds -> fold=8 (pad to 8), data=1
      8 dev x 4 folds -> fold=4, data=2
      4 dev x 5 folds -> fold=4 (pad to 8, 2 per device), data=1
      2 dev x 5 folds -> fold=2 (pad to 6, 3 per device), data=1
    """
    divisors = [d for d in range(1, n_devices + 1) if n_devices % d == 0]
    covering = [d for d in divisors if d >= k_folds]
    fold_par = min(covering) if covering else n_devices
    k_pad = -(-k_folds // fold_par) * fold_par
    return fold_par, k_pad


def build_fold_index_pools(meta, k_folds: int, calcular_fold_fn, k_pad: int | None = None):
    """Per-fold pools of slice indices into the shared dataset.

    meta: list of (patient_id, modality, slice_idx) per dataset row.
    k_pad: total fold rows to emit (>= k_folds); rows beyond k_folds are
    copies of fold 0's pool (grid padding, never trained here).
    Returns (pools [F, M] int32 padded by repetition, counts [F] int32)."""
    k_pad = k_pad or k_folds
    per_fold = [[] for _ in range(k_folds)]
    for i, (pid, _, _) in enumerate(meta):
        f = calcular_fold_fn(pid, k_folds) - 1
        for g in range(k_folds):
            if g != f:  # fold g trains on patients NOT in fold g
                per_fold[g].append(i)
    m = max(len(p) for p in per_fold)
    pools = np.zeros((k_pad, m), np.int32)
    counts = np.zeros((k_pad,), np.int32)
    for f, p in enumerate(per_fold):
        if not p:
            raise ValueError(f"Fold {f + 1} sin cortes de entrenamiento.")
        reps = -(-m // len(p))
        pools[f] = np.tile(np.asarray(p, np.int32), reps)[:m]
        counts[f] = len(p)
    for f in range(k_folds, k_pad):
        pools[f] = pools[0]
        counts[f] = counts[0]
    return torch.from_numpy(pools), torch.from_numpy(counts)


def init_fold_state(model, cfg: TrainConfig, steps_per_epoch: int, fold: int,
                    device="cuda") -> TrainState:
    """Fold `fold`'s (0-based) state: a copy of `model` with weights seeded
    ``cfg.seed + fold`` (then warm-started from ``cfg.pretrained``, as every
    fold is) and a generator seeded the same."""
    m = copy.deepcopy(model)
    state = trainer.init_train_state(m, cfg, steps_per_epoch,
                                     variables=init_variables(m, cfg.seed + fold), device=device)
    state.gen.manual_seed(cfg.seed + fold)
    return state


def init_multi_fold_state(model, cfg: TrainConfig, steps_per_epoch: int, folds,
                          device="cuda") -> dict:
    """{fold: its state} for the 0-based `folds` (independent inits)."""
    return {f: init_fold_state(model, cfg, steps_per_epoch, f, device) for f in folds}


def draw_rows(gen: torch.Generator, count: int, batch_size: int) -> torch.Tensor:
    """``[batch_size, 4]`` positions in a fold's pool, with replacement from
    its first `count` (the reference's ``randint(k_idx, (B, 4), 0, count)``)."""
    return torch.randint(0, int(count), (batch_size, 4), generator=gen)


def fold_batch(state: TrainState, pool, count, dataset: dict, acfg: augment.AugConfig,
               batch_size: int, axis=None) -> dict:
    """The fold's next augmented batch: `draw_rows` of `pool`, then the
    augmentation's parameters, from the fold's generator; with a data
    `axis`, this rank's share of both."""
    idx = pool[draw_rows(state.gen, count, batch_size)]
    params = augment.draw_params(state.gen, acfg, batch_size)
    if axis is not None:
        part = axis.local_slice(batch_size)
        idx, params = idx[part], params.rows(part)
    return augment.make_batch(params, dataset, idx, acfg)


def fold_step(state: TrainState, pool, count, dataset: dict, acfg: augment.AugConfig,
              axis=None) -> dict:
    """One micro-step of one fold (the reference's ``one_fold``): its batch,
    then ``trainer.train_step`` (over `axis` with averaged gradients, batch
    statistics and losses, as the reference's ``pmean``)."""
    batch = fold_batch(state, pool, count, dataset, acfg, state.cfg.batch_size, axis)
    return trainer.train_step(state, batch, axis)


def stack_states(states: dict) -> dict:
    """The stacked resume point: every fold's ``TrainState.state_dict()``,
    by 0-based fold."""
    return {"folds": {int(f): sd for f, sd in states.items()}}


def extract_fold_state(stacked: dict, fold: int) -> dict:
    """Fold `fold`'s state_dict out of a stacked resume point."""
    return stacked["folds"][fold]
