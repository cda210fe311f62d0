"""``batch=-1``: the largest train batch that fits the card's memory.

Port of ``tpu_mslesseg/train/autobatch.py``. The reference trains with
``batch=-1``, which ultralytics resolves by probing CUDA memory for about
60% use. The JAX package reads its peaks from an ahead-of-time compile; here
the probe runs the real thing on the card: one augmented micro-step (the
augmentation, the forward, the loss and the backward) at batches 8 and 16,
each peak read with ``torch.cuda.reset_peak_memory_stats`` and
``max_memory_allocated``. The line through the two peaks is solved for the
budget, ``DEFAULT_FRACTION`` of what ``torch.cuda.mem_get_info`` reports
free, and the answer is kept in a cache file keyed on the card, the model
and the dataset, so later folds and runs skip the probe.

Over a data axis of ``n_data`` ranks, each with its own card, the answer is
the batch one card holds times ``n_data`` (each rank takes its share of
it), as the reference scales its per-device batch. On the CPU (asked for by
name) the batch is ``DEFAULT_BATCH`` a rank, as the reference's is on a CPU
backend. On a CUDA card there is no fallback: a
probe that fails, or a line on which no batch fits, raises.
"""

from __future__ import annotations

import json
import os
from pathlib import Path

import torch

from tpu_mslesseg_torch.core.device import precision_of
from tpu_mslesseg_torch.pipeline.logging_setup import get_logger

logger = get_logger(__file__)

DEFAULT_BATCH = 32  # the CPU's batch
DEFAULT_FRACTION = float(os.environ.get("TPU_MSLESSEG_AUTOBATCH_FRACTION", "0.6"))
PROBES = (8, 16)


def cache_path() -> Path:
    return Path(os.environ.get("TPU_MSLESSEG_AUTOBATCH_CACHE",
                               Path.home() / ".cache" / "tpu_mslesseg" / "autobatch_torch.json"))


def solve_max_batch(b_lo: int, peak_lo: int, b_hi: int, peak_hi: int, budget: int,
                    max_batch: int = 128, multiple: int = 8) -> int | None:
    """Largest batch with fixed + per_image*B <= budget (the line through
    two probe points), rounded down to `multiple`. None when the probe data
    is unusable (non-increasing peaks) or nothing fits."""
    if b_hi <= b_lo or peak_hi <= peak_lo or peak_lo <= 0:
        return None
    per_image = (peak_hi - peak_lo) / (b_hi - b_lo)
    fixed = peak_lo - per_image * b_lo
    b = int((budget - fixed) // per_image)
    b = min(b, max_batch)
    if b >= multiple:
        b -= b % multiple
    if b < 1:
        return None
    return b


def _cache_load() -> dict:
    try:
        return json.loads(cache_path().read_text())
    except (OSError, ValueError):
        return {}


def _cache_store(key: str, value: int) -> None:
    try:
        cache = _cache_load()
        cache[key] = value
        cache_path().parent.mkdir(parents=True, exist_ok=True)
        cache_path().write_text(json.dumps(cache, indent=1, sort_keys=True))
    except OSError:
        pass  # the cache saves probes; it is never a failure


def cache_key(card: str, total: int, model, cfg, acfg, fraction: float, max_batch: int,
              train_bytes: int) -> str:
    """The cache entry of one resolution: the card and its memory, the model's
    scale and rematerialisation (the probe measures the model as built, and
    remat lowers its peak), the sizes that the peak grows with, the budget and
    the dataset that stays on the card."""
    return "|".join(str(v) for v in (
        card, total, model.cfg.scale, model.remat, cfg.imgsz, acfg.max_inst, cfg.max_fg,
        cfg.amp, fraction, max_batch, train_bytes))


def probe_peak(model, cfg, train_set, acfg, batch_size: int, device) -> int:
    """Peak bytes one augmented micro-step at `batch_size` (augmentation,
    forward in train mode, loss, backward) allocates on `device` above what
    was allocated before it, run on a copy of `model` that is dropped
    after."""
    import copy

    from tpu_mslesseg_torch.train import augment
    from tpu_mslesseg_torch.train.losses import LossConfig, segmentation_loss

    probe = copy.deepcopy(model).to(device).train()
    gen = torch.Generator().manual_seed(0)
    idx = torch.randint(0, len(train_set), (batch_size, 4), generator=gen)
    params = augment.draw_params(gen, acfg, batch_size)
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    base = torch.cuda.memory_allocated(device)
    try:
        batch = augment.make_batch(params, train_set.as_dict(), idx, acfg)
        with precision_of(probe.dtype):  # as `trainer.train_step` convolves
            out = probe(batch["images"])
            labels = torch.zeros(batch["valid"].shape, dtype=torch.long, device=device)
            total, _ = segmentation_loss(out, batch["boxes"], labels, batch["valid"],
                                         batch["instmap_proto"],
                                         LossConfig(imgsz=cfg.imgsz, max_fg=cfg.max_fg))
            total.backward()
        torch.cuda.synchronize(device)
        return int(torch.cuda.max_memory_allocated(device)) - base
    finally:
        del probe
        torch.cuda.empty_cache()


def auto_batch_size(model, cfg, train_set, acfg, n_data: int = 1,
                    fraction: float = DEFAULT_FRACTION, max_batch: int = 128,
                    device="cuda") -> int:
    """Resolve ``batch=-1`` for `model` training on `train_set` on `device`,
    for a batch split over `n_data` such devices."""
    dev = torch.device(device)
    if dev.type == "cpu":
        logger.info(f"🤖 batch=-1 en la CPU: batch={DEFAULT_BATCH} x {n_data}.")
        return DEFAULT_BATCH * n_data
    free, total = torch.cuda.mem_get_info(dev)
    key = cache_key(torch.cuda.get_device_name(dev), total, model, cfg, acfg, fraction,
                    max_batch, train_set.nbytes())
    cached = _cache_load().get(key)
    if cached is not None:
        logger.info(f"🤖 batch=-1 (cacheado): {cached} por GPU x {n_data}.")
        return int(cached) * n_data

    peaks = [probe_peak(model, cfg, train_set, acfg, b, dev) for b in PROBES]
    # the peaks are above what is already allocated, so the budget is a
    # share of what is free
    budget = int(free * fraction)
    b = solve_max_batch(PROBES[0], peaks[0], PROBES[1], peaks[1], budget, max_batch=max_batch)
    if b is None:
        raise ValueError(
            f"batch=-1: ningún batch cabe en {fraction:.0%} de {free / 2**30:.1f} GiB libres "
            f"(picos {peaks} @ {PROBES}); reduzca imgsz/escala o fije --batch.")
    per_image = (peaks[1] - peaks[0]) / (PROBES[1] - PROBES[0])
    logger.info(f"🤖 batch=-1: {free / 2**30:.1f} GiB libres x {fraction:.0%} -> batch {b} "
                f"por GPU ({per_image / 2**20:.0f} MiB/imagen) x {n_data}.")
    _cache_store(key, b)
    return b * n_data
