"""Stage timers: wall-clock every pipeline region, summarise at the end, and
trace a region's work on demand.

Port of ``tpu_mslesseg/core/profiling.py`` (`stage_timer`,
`timings_summary`, `reset_timings`). The times are the host's clock around a
region, so they include whatever the region waits for on the device.

With ``TPU_MSLESSEG_TRACE_DIR`` set, each region runs under
``torch.profiler``, as the JAX package's runs under ``jax.profiler.trace``:
the host's operators always, and the card's kernels, copies and fills once
CUDA is initialised. The region's trace lands in ``<dir>/<region>/`` as
``<host>_<pid>.<ns>.pt.trace.json.gz``, a Chrome trace that Perfetto
(ui.perfetto.dev) and TensorBoard's PyTorch profiler view (``--logdir
<dir>``, one run a region) open. The region is a span of its own,
``stage_timer.<region>``, inside it. A region that raises still writes its
trace, and records no time. Only one profiler can run at a time, so a
traced region opened inside another raises. With the variable unset nothing
is traced and nothing waits for the card.
"""

from __future__ import annotations

import logging
import os
import time
from contextlib import contextmanager

import torch

logger = logging.getLogger("profiling")

TRACE_ENV = "TPU_MSLESSEG_TRACE_DIR"

_TIMINGS: dict = {}
_TRACING: list = []  # the traced region that holds the profiler, if any


@contextmanager
def stage_timer(name: str):
    """Wall-clock a pipeline region (recorded only when it completes);
    under ``TPU_MSLESSEG_TRACE_DIR``, trace it too."""
    trace_dir = os.environ.get(TRACE_ENV)
    t0 = time.time()
    if trace_dir:
        with _traced(name, os.path.join(trace_dir, name)):
            yield
    else:
        yield
    dt = time.time() - t0
    _TIMINGS.setdefault(name, []).append(dt)
    logger.info(f"⏱️ {name}: {dt:.2f}s")


@contextmanager
def _traced(name: str, out_dir: str):
    """Profiles the block and writes its trace under `out_dir` when it ends,
    raised or not."""
    if _TRACING:
        raise RuntimeError(
            f"stage_timer({name!r}) dentro de stage_timer({_TRACING[0]!r}) con {TRACE_ENV}: "
            "solo un perfilador puede estar activo a la vez")
    cuda = torch.cuda.is_initialized()
    activities = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(
        activities=activities,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(out_dir, use_gzip=True))
    _TRACING.append(name)
    try:
        with prof:  # stops, and writes the trace, however the block ends
            with torch.profiler.record_function(f"stage_timer.{name}"):
                yield
                if cuda:  # the region's last kernels end inside its span
                    torch.cuda.synchronize()
    finally:
        _TRACING.pop()


def timings_summary() -> dict:
    """{stage: {"total_s", "calls", "mean_s"}} for everything timed."""
    return {
        k: {
            "total_s": round(sum(v), 3),
            "calls": len(v),
            "mean_s": round(sum(v) / len(v), 3),
        }
        for k, v in _TIMINGS.items()
    }


def reset_timings():
    _TIMINGS.clear()
