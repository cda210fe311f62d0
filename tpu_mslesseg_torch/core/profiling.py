"""Stage timers: wall-clock every pipeline region, summarise at the end.

Port of ``tpu_mslesseg/core/profiling.py``'s host side (`stage_timer`,
`timings_summary`, `reset_timings`). The times are the host's clock around a
region, so they include whatever the region waits for on the device. The
JAX package's optional device trace of a region is not carried over.
"""

from __future__ import annotations

import logging
import time
from contextlib import contextmanager

logger = logging.getLogger("profiling")

_TIMINGS: dict = {}


@contextmanager
def stage_timer(name: str):
    """Wall-clock a pipeline region (recorded only when it completes)."""
    t0 = time.time()
    yield
    dt = time.time() - t0
    _TIMINGS.setdefault(name, []).append(dt)
    logger.info(f"⏱️ {name}: {dt:.2f}s")


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
