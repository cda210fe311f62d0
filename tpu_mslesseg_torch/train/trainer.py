"""The train step: schedule, optimizer cadence, AdamW groups, EMA, results.

Port of ``tpu_mslesseg/train/trainer.py``:

* AdamW (betas 0.9/0.999, eps 1e-8) at lr0 0.002 with a linear decay to
  ``lrf`` per epoch and a per-micro-step warmup; decoupled weight decay
  5e-4 on convolution kernels only, scaled by ``batch * accumulate / nbs``;
  biases (BatchNorm's too) form a group of their own without decay that
  warms from ``warmup_bias_lr``;
* gradients of micro-batches are summed (in ``.grad``) and the optimizer
  fires at upstream's cadence, whose gap ramps from 1 to
  ``round(nbs / batch)`` during warmup (`apply_cadence`); the learning rate
  of the c-th apply is the schedule at that apply's micro-step; the sum is
  clipped to a global norm of 10 first;
* an EMA of the parameters (not of the BatchNorm statistics), decay
  ``0.9999 * (1 - exp(-applies / 2000))``, updated once an apply;
* the model computes in the dtype it was created with (bf16 is the
  reference's ``amp``); parameters, optimizer state, BatchNorm statistics
  and the loss math stay float32.

The reference's step is one compiled program and its epoch a device-side
scan; here `train_step` is eager PyTorch and an epoch is a Python loop over
it. With a data axis (``core.mesh.DataAxis``) the step is one rank's part
of a data-parallel step, in either of the reference's two semantics (the
module docstring of ``core/mesh.py`` says which is which).
``torch.optim.AdamW`` multiplies the parameter by ``1 - lr * wd`` and then
subtracts ``lr * update``, where the reference adds ``wd * p`` to the
update before the learning rate: the same value but for float32 rounding.
"""

from __future__ import annotations

import csv
import functools
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from tpu_mslesseg_torch.core import distributed
from tpu_mslesseg_torch.core.device import exigir, precision_of
from tpu_mslesseg_torch.model.blocks import batch_norm_axis
from tpu_mslesseg_torch.model.yolo11 import init_variables
from tpu_mslesseg_torch.pipeline.logging_setup import get_logger
from tpu_mslesseg_torch.train.losses import LOSS_PARTS, LossConfig, segmentation_loss

logger = get_logger(__file__)

CLIP_NORM = 10.0


@dataclass(frozen=True)
class TrainConfig:
    """The train step's and the engine's options, with the reference's
    defaults. The compute dtype and the rematerialisation are the model's
    own: ``amp`` asks the stage for a bf16 model and ``remat`` for a
    rematerialising one (``create_model(dtype=..., remat=...)``)."""

    epochs: int = 50
    batch_size: int = 32
    lr0: float = 0.002
    lrf: float = 0.01
    warmup_epochs: float = 3.0
    # the bias group warms from this lr instead of 0
    warmup_bias_lr: float = 0.1
    weight_decay: float = 5e-4
    # nominal batch: gradients accumulate over round(nbs / batch) micro-batches
    # an optimizer step, and the weight decay scales by batch * accumulate / nbs
    nbs: int = 64
    ema_decay: float = 0.9999
    ema_tau: float = 2000.0
    # the last `close_mosaic` epochs train without the mosaic
    close_mosaic: int = 10
    # early stop after `patience` validated epochs without a better fitness
    patience: int = 100
    # > 0: weights/epoch<N>.pt every N epochs
    save_period: int = -1
    cos_lr: bool = False
    imgsz: int = 640
    seed: int = 0
    max_fg: int = 64
    # the training figures beside results.csv (train/plots.py)
    plots: bool = True
    # bf16 compute, float32 parameters, optimizer state, statistics and losses
    amp: bool = True
    # an ultralytics .pt to warm-start from ("" = the seeded initialisation)
    pretrained: str = ""
    # recompute the big blocks' activations in the backward instead of storing
    # them (the same results, less memory, so a larger batch -1); consumed
    # where stage 2 creates the model, as ``amp`` is
    remat: bool = True


def accumulate_steps(cfg: TrainConfig) -> int:
    """Micro-batches per optimizer step after warmup (Python ``round``: half
    to even)."""
    return max(round(cfg.nbs / max(cfg.batch_size, 1)), 1)


def apply_cadence(cfg: TrainConfig, steps_per_epoch: int, total_steps: int | None = None):
    """Upstream's optimizer-apply cadence over the whole run. During warmup
    ultralytics re-evaluates ``accumulate = max(1, round(interp(ni, [0, nw],
    [1, nbs / batch])))`` every micro-batch while ``ni <= nw`` and fires the
    optimizer when ``ni - last_opt_step >= accumulate``; with
    ``warmup_epochs <= 0`` the gap is fixed from the start. Returns read-only
    arrays: ``apply_mask`` (does the optimizer fire at micro-step ni),
    ``n_applies`` (applies up to and including ni) and ``apply_ni`` (the
    micro-step of the c-th apply)."""
    T = int(total_steps if total_steps is not None else steps_per_epoch * cfg.epochs)
    return _apply_cadence_cached(
        cfg.warmup_epochs, cfg.nbs, cfg.batch_size, steps_per_epoch, T, accumulate_steps(cfg)
    )


@functools.lru_cache(maxsize=64)
def _apply_cadence_cached(warmup_epochs, nbs, batch_size, steps_per_epoch, T, fixed):
    mask = np.zeros(max(T, 1), np.bool_)
    if warmup_epochs > 0:
        nw = max(round(warmup_epochs * steps_per_epoch), 100)
        tgt = nbs / max(batch_size, 1)
        last = -1
        acc = fixed
        for ni in range(mask.size):
            if ni <= nw:
                acc = max(1, round(float(np.interp(ni, [0, nw], [1.0, tgt]))))
            if ni - last >= acc:
                mask[ni] = True
                last = ni
    else:
        mask[fixed - 1 :: fixed] = True
    n_applies = np.cumsum(mask).astype(np.int32)
    apply_ni = np.nonzero(mask)[0].astype(np.int32)
    if apply_ni.size == 0:  # degenerate short runs: keep the table non-empty
        apply_ni = np.zeros(1, np.int32)
    for a in (mask, n_applies, apply_ni):  # cached arrays are shared by callers
        a.setflags(write=False)
    return mask, n_applies, apply_ni


def lr_schedule(cfg: TrainConfig, steps_per_epoch: int, start: float = 0.0):
    """Warmup into the per-epoch linear (or cosine) decay to ``lrf``: the
    warmup interpolates over ``nw = max(round(warmup_epochs *
    steps_per_epoch), 100)`` micro-steps from `start` to the current epoch's
    lr; with ``warmup_epochs <= 0`` there is none. Returns ``fn(step) ->
    numpy float32``, computed in float32 operation by operation as the
    reference computes it."""
    f32 = np.float32
    warm = max(round(cfg.warmup_epochs * steps_per_epoch), 100)

    def fn(step):
        step = f32(step)
        epoch = np.floor(step / f32(steps_per_epoch))
        if cfg.cos_lr:
            lf = ((f32(1.0) - np.cos(epoch * f32(np.pi) / f32(cfg.epochs))) / f32(2.0)) * f32(
                cfg.lrf - 1.0
            ) + f32(1.0)
        else:
            lf = (f32(1.0) - epoch / f32(cfg.epochs)) * f32(1.0 - cfg.lrf) + f32(cfg.lrf)
        if cfg.warmup_epochs <= 0:
            return f32(cfg.lr0) * lf
        frac = np.clip(step / f32(warm), f32(0.0), f32(1.0))
        return f32(start) * (f32(1.0) - frac) + f32(cfg.lr0) * lf * frac

    return fn


def param_groups(model) -> dict[str, list[str]]:
    """The names of `model`'s parameters in the reference's three groups:
    ``bias`` (everything named bias, BatchNorm's included), ``kernel``
    (convolution and transposed-convolution weights, the only decayed ones)
    and ``scale`` (BatchNorm weights)."""
    groups = {"bias": [], "kernel": [], "scale": []}
    for mod_name, mod in model.named_modules():
        for leaf, _ in mod.named_parameters(recurse=False):
            name = f"{mod_name}.{leaf}"
            if leaf == "bias":
                groups["bias"].append(name)
            elif isinstance(mod, torch.nn.BatchNorm2d):
                groups["scale"].append(name)
            else:
                groups["kernel"].append(name)
    return groups


def make_optimizer(model, cfg: TrainConfig):
    """``torch.optim.AdamW`` over `param_groups`; the learning rates are set
    by `train_step` before each step."""
    params = dict(model.named_parameters())
    wd_eff = cfg.weight_decay * cfg.batch_size * accumulate_steps(cfg) / cfg.nbs
    return torch.optim.AdamW(
        [
            {"name": name, "params": [params[n] for n in names],
             "weight_decay": wd_eff if name == "kernel" else 0.0}
            for name, names in param_groups(model).items()
        ],
        lr=0.0, betas=(0.9, 0.999), eps=1e-8,
    )


@dataclass
class TrainState:
    """What a run carries from step to step. The gradients accumulated since
    the last apply live in the parameters' ``.grad``; `gen` draws the
    epochs' source indices and the augmentation's parameters."""

    model: torch.nn.Module
    ema: dict[str, torch.Tensor]  # parameters only, float32
    optimizer: torch.optim.Optimizer
    cfg: TrainConfig
    steps_per_epoch: int
    step: int = 0  # micro-steps taken
    applies: int = 0  # optimizer steps taken
    lr: tuple[float, float] = (0.0, 0.0)  # (bias, weights) of the last apply
    gen: torch.Generator = field(default_factory=torch.Generator)

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    def state_dict(self) -> dict:
        """Everything a resumed run needs to go on as the uninterrupted run
        would: the model, the EMA, the optimizer, the counters, the
        accumulated gradients and the generator's state (tensors, numbers
        and strings only: ``torch.load(weights_only=True)`` reads it)."""
        return {
            "model": self.model.state_dict(),
            "ema": dict(self.ema),
            "optimizer": self.optimizer.state_dict(),
            "grads": {n: p.grad for n, p in self.model.named_parameters() if p.grad is not None},
            "step": self.step,
            "applies": self.applies,
            "lr": list(self.lr),
            "gen": self.gen.get_state(),
        }

    def load_state_dict(self, sd: dict) -> None:
        dev = self.device
        self.model.load_state_dict(sd["model"])
        with torch.no_grad():
            for k, v in sd["ema"].items():
                self.ema[k].copy_(v)
        self.optimizer.load_state_dict(sd["optimizer"])
        for n, p in self.model.named_parameters():
            g = sd["grads"].get(n)
            p.grad = None if g is None else g.to(dev, p.dtype).clone()
        self.step, self.applies = int(sd["step"]), int(sd["applies"])
        self.lr = tuple(float(v) for v in sd["lr"])
        self.gen.set_state(sd["gen"])

    def served_state_dict(self) -> dict:
        """The weights a predictor serves: the EMA parameters and the
        BatchNorm statistics (a 3-channel stem)."""
        return {**self.model.state_dict(), **self.ema}


def init_train_state(model, cfg: TrainConfig, steps_per_epoch: int, variables=None,
                     device="cuda") -> TrainState:
    """`model` with `variables` (a state_dict with a 3-channel stem; seeded
    from ``cfg.seed`` when None, then warm-started from ``cfg.pretrained``
    where it names a file) on `device`, its optimizer, its EMA and a
    generator seeded from ``cfg.seed``. Raises when `device` cannot be used;
    nothing falls back to the CPU."""
    device = exigir(device)
    sd = variables if variables is not None else init_variables(model, cfg.seed)
    if cfg.pretrained:
        from tpu_mslesseg_torch.model.import_pt import load_pretrained

        sd, report = load_pretrained(cfg.pretrained, sd)
        logger.info(
            f"🧬 Pretrained {cfg.pretrained}: {len(report['transferred'])}/"
            f"{report['total_ours']} transferidos ({len(report['mismatched'])} sin forma "
            "compatible)."
        )
    model.load_state_dict(sd)
    model.to(device)
    ema = {n: p.detach().clone() for n, p in model.named_parameters()}
    return TrainState(model, ema, make_optimizer(model, cfg), cfg, steps_per_epoch,
                      gen=torch.Generator().manual_seed(cfg.seed))


def cadence_at(cfg: TrainConfig, steps_per_epoch: int, step: int) -> tuple[bool, int]:
    """(does the optimizer fire at micro-step `step`, applies up to and
    including it). Past the precomputed horizon the fixed post-warmup
    cadence continues from the last precomputed apply."""
    mask, napp, apply_ni = apply_cadence(cfg, steps_per_epoch)
    if step < mask.size:
        return bool(mask[step]), int(napp[step])
    fixed = accumulate_steps(cfg)
    since = step - int(apply_ni[-1])
    return since > 0 and since % fixed == 0, int(napp[-1]) + since // fixed


def clip_by_global_norm(grads, max_norm: float = CLIP_NORM) -> torch.Tensor:
    """Scales `grads` in place by ``max_norm / norm`` when their global norm
    is at least `max_norm` (as ``g / norm * max_norm``), else leaves them;
    returns the norm. No host sync."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    small = norm < max_norm
    torch._foreach_div_(grads, torch.where(small, 1.0, norm))
    torch._foreach_mul_(grads, torch.where(small, 1.0, max_norm))
    return norm


def _apply(state: TrainState, n_applies: int) -> None:
    """One optimizer step on the accumulated gradients, then the EMA."""
    cfg, spe = state.cfg, state.steps_per_epoch
    names, params = zip(*state.model.named_parameters())
    missing = [n for n, p in zip(names, params) if p.grad is None]
    if missing:
        raise RuntimeError(f"parameters without a gradient at an apply: {missing[:5]}")
    clip_by_global_norm([p.grad for p in params])
    _, _, apply_ni = apply_cadence(cfg, spe)
    ni = int(apply_ni[min(state.applies, apply_ni.size - 1)])
    state.lr = (float(lr_schedule(cfg, spe, start=cfg.warmup_bias_lr)(ni)),
                float(lr_schedule(cfg, spe)(ni)))
    for group in state.optimizer.param_groups:
        group["lr"] = state.lr[0] if group["name"] == "bias" else state.lr[1]
    state.optimizer.step()
    state.optimizer.zero_grad(set_to_none=True)
    state.applies += 1
    # float32 operation by operation, as the reference's compiled step computes it
    d = float(np.float32(cfg.ema_decay) * (
        np.float32(1.0) - np.exp(-(np.float32(n_applies) / np.float32(cfg.ema_tau)))))
    with torch.no_grad():
        ema = [state.ema[n] for n in names]
        torch._foreach_mul_(ema, d)
        torch._foreach_add_(ema, [p.detach() for p in params], alpha=1.0 - d)


def optimizer_step(state: TrainState) -> bool:
    """The optimizer half of a micro-step, after the backward pass has
    added this micro-batch's gradients to ``.grad``: at the cadence's
    micro-steps clips the sum, steps AdamW at that apply's learning rates,
    clears the gradients and updates the EMA. Counts the micro-step and
    returns whether the optimizer fired."""
    do_apply, n_applies = cadence_at(state.cfg, state.steps_per_epoch, state.step)
    if do_apply:
        _apply(state, n_applies)
    state.step += 1
    return do_apply


def train_step(state: TrainState, batch, axis=None) -> dict:
    """One micro-step on `batch` (the augmentation's: ``images`` [B,S,S,3]
    float32 in [0,1], ``instmap_proto`` [B,S/4,S/4] uint8, ``boxes`` [B,M,4]
    xyxy pixels, ``valid`` [B,M] bool; tensors or arrays), on the state's
    device: forward in train mode, loss, backward into the accumulated
    gradients and `optimizer_step`; a float32 model's forward and backward
    convolve in full float32 (``core.device.precision_of``). Returns the
    loss and its gain-scaled parts as 0-d tensors on the device (no host
    sync) and whether the optimizer fired.

    With `axis` (a ``core.mesh.DataAxis``) `batch` is this rank's part and
    the micro-step's gradients are reduced over the axis before they join
    the accumulated ones: summed for one batch over the axis (whose
    BatchNorm statistics and loss normalisers are then the whole batch's),
    averaged otherwise, with the BatchNorm running statistics and the
    returned losses averaged too. Every rank of the axis ends the step with
    the same state."""
    cfg, dev = state.cfg, state.device
    batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
    whole = axis if axis is not None and axis.global_batch else None
    state.model.train()
    # a float32 model's backward convolutions run outside its forward's
    # scope: both run in full float32 here
    with precision_of(state.model.dtype):
        with batch_norm_axis(whole):
            out = state.model(batch["images"])
        labels = torch.zeros(batch["valid"].shape, dtype=torch.long, device=dev)
        total, parts = segmentation_loss(
            out, batch["boxes"], labels, batch["valid"], batch["instmap_proto"],
            LossConfig(imgsz=cfg.imgsz, max_fg=cfg.max_fg), axis=whole,
        )
        if axis is None:
            total.backward()
        else:
            _backward_over(state.model, total, axis)
    if axis is None:
        metrics = {"loss": total.detach(), **{k: parts[k] for k in LOSS_PARTS}}
    else:
        metrics = torch.stack([total.detach()] + [parts[k] for k in LOSS_PARTS])
        if axis.global_batch:  # the parts are the whole batch's already
            metrics[0] = axis.all_reduce(metrics[:1].clone())[0]
        else:
            metrics = axis.all_reduce(metrics) / axis.size
            _average_running_stats(state.model, axis)
        metrics = dict(zip(("loss",) + LOSS_PARTS, metrics.unbind(0)))
    return {**metrics, "applied": optimizer_step(state)}


def _backward_over(model, total, axis) -> None:
    """`total`'s gradients reduced over `axis` (summed for one batch over
    it, averaged otherwise) and added to the accumulated ones."""
    params = list(model.parameters())
    held = [p.grad for p in params]
    for p in params:
        p.grad = None
    total.backward()
    got = [p for p in params if p.grad is not None]
    flat = torch._utils._flatten_dense_tensors([p.grad for p in got])
    axis.all_reduce(flat)
    if not axis.global_batch:
        flat /= axis.size
    for p, g in zip(got, torch._utils._unflatten_dense_tensors(flat, [p.grad for p in got])):
        p.grad = g.clone()
    for p, h in zip(params, held):
        if h is not None:
            p.grad = h if p.grad is None else h + p.grad


def _average_running_stats(model, axis) -> None:
    """The BatchNorm running statistics averaged over `axis` (the
    reference's ``pmean`` of the updated ``batch_stats``)."""
    bufs = [b for n, b in model.named_buffers() if n.endswith(("running_mean", "running_var"))]
    flat = axis.all_reduce(torch._utils._flatten_dense_tensors(bufs)) / axis.size
    with torch.no_grad():
        for b, v in zip(bufs, torch._utils._unflatten_dense_tensors(flat, bufs)):
            b.copy_(v)


RESULTS_HEADER = [
    "epoch", "time",
    "train/box_loss", "train/seg_loss", "train/cls_loss", "train/dfl_loss",
    "metrics/precision(B)", "metrics/recall(B)", "metrics/mAP50(B)",
    "metrics/mAP50-95(B)", "metrics/precision(M)", "metrics/recall(M)",
    "metrics/mAP50(M)", "metrics/mAP50-95(M)",
    "val/box_loss", "val/seg_loss", "val/cls_loss", "val/dfl_loss",
    "lr/pg0", "lr/pg1", "lr/pg2",
]


class ResultsWriter:
    """Per-epoch ``results.csv`` in the reference's schema. Every rank runs
    the train loop; rank 0 owns the file."""

    def __init__(self, path, append: bool = False, from_epoch: int | None = None):
        self.path = Path(path)
        self.t0 = time.time()
        self.enabled = distributed.is_main_process()
        if not self.enabled:
            return
        self.path.parent.mkdir(parents=True, exist_ok=True)
        if append and self.path.exists():
            # resume: keep the rows before the resume point and continue the
            # wall-clock column
            try:
                with open(self.path) as f:
                    rows = list(csv.reader(f))
                kept = [rows[0]] + [
                    r for r in rows[1:] if from_epoch is None or int(r[0]) < from_epoch
                ]
                with open(self.path, "w", newline="") as f:
                    csv.writer(f).writerows(kept)
                if len(kept) > 1:
                    self.t0 = time.time() - float(kept[-1][1])
            except (IndexError, ValueError):
                pass
            return
        with open(self.path, "w", newline="") as f:
            csv.writer(f).writerow(RESULTS_HEADER)

    def write_epoch(self, epoch, train_losses, val_metrics, val_losses, lr):
        """`lr` is (bias_lr, weight_lr) or one float. The columns follow
        upstream's group order: pg0 the biases, pg1 the decayed weights, pg2
        the BatchNorm weights; pg1 and pg2 share the plain schedule."""
        if not self.enabled:
            return
        lr_b, lr_w = lr if isinstance(lr, (tuple, list)) else (lr, lr)
        row = [
            epoch,
            round(time.time() - self.t0, 4),
            *[round(float(train_losses.get(k, 0)), 5) for k in ("box", "seg", "cls", "dfl")],
            *[round(float(val_metrics.get(k, 0)), 5) for k in (
                "precision_b", "recall_b", "map50_b", "map_b",
                "precision_m", "recall_m", "map50_m", "map_m")],
            *[round(float(val_losses.get(k, 0)), 5) for k in ("box", "seg", "cls", "dfl")],
            *[f"{v:.6g}" for v in (lr_b, lr_w, lr_w)],
        ]
        with open(self.path, "a", newline="") as f:
            csv.writer(f).writerow(row)


def fitness(val_metrics: dict) -> float:
    """Ultralytics' segmentation fitness, which picks the best checkpoint:
    0.1 * mAP50 + 0.9 * mAP50-95 for boxes and for masks, summed."""
    return (
        0.1 * val_metrics.get("map50_b", 0.0)
        + 0.9 * val_metrics.get("map_b", 0.0)
        + 0.1 * val_metrics.get("map50_m", 0.0)
        + 0.9 * val_metrics.get("map_m", 0.0)
    )
