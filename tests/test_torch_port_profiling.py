"""The port's per-region device trace (``core/profiling.stage_timer`` under
``TPU_MSLESSEG_TRACE_DIR``) against the JAX package's.

Both packages write one trace a region into ``<dir>/<region>/``: the JAX
package through ``jax.profiler.trace`` (``plugins/profile/<ts>/``), the port
through ``torch.profiler`` (``<host>_<pid>.<ns>.pt.trace.json.gz``). The
region directories must be the same for the same names. A region that
raises writes its trace and records no time in either; a traced region
inside another raises in either, and the outer region's trace is still
written. With the switch unset the port builds no profiler and waits on
nothing. Here on the CPU the trace holds the host's operators; on the card
``chip_smoke.py`` phase 21 reads the kernels from it.
"""

import gzip
import json
import os

import jax.numpy as jnp
import pytest
import torch

from tpu_mslesseg.core import profiling as jprof
from tpu_mslesseg_torch.core import profiling as tprof

REGIONS = ("setup", "extraer_dataset", "rapido_fold1", "eval_consenso_fold2")


def _regions(root):
    return sorted(os.listdir(root)) if os.path.isdir(root) else []


def _port_traces(region_dir):
    return sorted(f for f in os.listdir(region_dir) if f.endswith(".pt.trace.json.gz"))


def _events(path):
    with gzip.open(path, "rt") as f:
        return json.load(f)["traceEvents"]


@pytest.fixture
def timings():
    """Both packages' timers emptied before and after the test."""
    for m in (tprof, jprof):
        m.reset_timings()
    yield
    for m in (tprof, jprof):
        m.reset_timings()


def test_the_region_directories_are_the_references(tmp_path, monkeypatch, timings):
    x = torch.ones(8, 8)
    monkeypatch.setenv(tprof.TRACE_ENV, str(tmp_path / "port"))
    for name in REGIONS:
        with tprof.stage_timer(name):
            (x @ x).sum()
    with tprof.stage_timer(REGIONS[2]):  # a region run twice: a trace each run
        (x @ x).sum()
    monkeypatch.setenv(tprof.TRACE_ENV, str(tmp_path / "jax"))
    for name in REGIONS:
        with jprof.stage_timer(name):
            jnp.ones(3).sum().block_until_ready()

    assert _regions(tmp_path / "port") == _regions(tmp_path / "jax") == sorted(REGIONS)
    for name in REGIONS:
        traces = _port_traces(tmp_path / "port" / name)
        assert len(traces) == (2 if name == REGIONS[2] else 1)
        assert os.listdir(tmp_path / "jax" / name) == ["plugins"]
        events = _events(tmp_path / "port" / name / traces[0])
        spans = [e for e in events if e.get("name") == f"stage_timer.{name}"]
        assert len(spans) == 1 and spans[0]["ph"] == "X"
        t0, t1 = spans[0]["ts"], spans[0]["ts"] + spans[0]["dur"]
        ops = [e for e in events if e.get("cat") == "cpu_op" and e["name"] == "aten::mm"]
        assert ops and all(t0 <= e["ts"] <= t1 for e in ops)
    got, want = tprof.timings_summary(), jprof.timings_summary()
    assert set(got) == set(want) == set(REGIONS)
    assert got[REGIONS[2]]["calls"] == 2 and want[REGIONS[2]]["calls"] == 1


def test_a_raising_region_writes_its_trace_and_records_no_time(tmp_path, monkeypatch,
                                                               timings):
    for m, d in ((tprof, "port"), (jprof, "jax")):
        monkeypatch.setenv(tprof.TRACE_ENV, str(tmp_path / d))
        with pytest.raises(ValueError, match="boom"):
            with m.stage_timer("eval_fold1"):
                torch.ones(4).sum()
                raise ValueError("boom")
        assert _regions(tmp_path / d) == ["eval_fold1"]
        assert m.timings_summary() == {}
    traces = _port_traces(tmp_path / "port" / "eval_fold1")
    assert len(traces) == 1
    assert any(e.get("name") == "stage_timer.eval_fold1"
               for e in _events(tmp_path / "port" / "eval_fold1" / traces[0]))
    assert tprof._TRACING == []  # the next region may trace


def test_a_nested_traced_region_fails_and_the_outer_trace_is_kept(tmp_path, monkeypatch,
                                                                  timings):
    for m, d in ((tprof, "port"), (jprof, "jax")):
        monkeypatch.setenv(tprof.TRACE_ENV, str(tmp_path / d))
        with pytest.raises(RuntimeError):
            with m.stage_timer("train_paralelo"):
                with m.stage_timer("train_fold1"):
                    pass
        assert _regions(tmp_path / d) == ["train_paralelo"]
        assert m.timings_summary() == {}
    assert len(_port_traces(tmp_path / "port" / "train_paralelo")) == 1
    assert tprof._TRACING == []
    monkeypatch.setenv(tprof.TRACE_ENV, str(tmp_path / "port"))
    with tprof.stage_timer("setup"):  # the profiler was given back
        pass
    assert _regions(tmp_path / "port") == ["setup", "train_paralelo"]


def test_without_the_switch_nothing_is_traced_or_synchronised(tmp_path, monkeypatch,
                                                              timings):
    def refused(*args, **kwargs):
        raise AssertionError("traced or synchronised with the switch unset")

    monkeypatch.delenv(tprof.TRACE_ENV, raising=False)
    monkeypatch.chdir(tmp_path)
    for name in ("profile", "record_function", "tensorboard_trace_handler"):
        monkeypatch.setattr(torch.profiler, name, refused)
    monkeypatch.setattr(torch.cuda, "synchronize", refused)
    with tprof.stage_timer("setup"):
        torch.ones(4).sum()
    monkeypatch.setenv(tprof.TRACE_ENV, "")  # empty is unset, as in the reference
    with tprof.stage_timer("setup"):
        pass
    assert tprof.timings_summary()["setup"]["calls"] == 2
    assert os.listdir(tmp_path) == []
