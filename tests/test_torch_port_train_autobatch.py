"""The port's ``batch=-1`` (``train/autobatch.py``) and stopper state
(``train/checkpoint.load_stopper_state``) against the JAX package's.

``solve_max_batch`` is the reference's line through two probe points,
copied as it is: equal on a grid of probes and budgets. On the CPU, asked
for by name, the batch is the reference's CPU default (32). The stopper
state resumes best fitness and its epoch from ``fitness.json`` as the
reference does, with its 1e-12 floor for a best checkpoint without a note.
The card's probe itself runs in ``chip_smoke.py`` phase 15.
"""

import itertools
import json

import pytest
import torch

from tpu_mslesseg.train import autobatch as jab
from tpu_mslesseg.train import checkpoint as jckpt
from tpu_mslesseg_torch.train import autobatch as tab
from tpu_mslesseg_torch.train import checkpoint as tckpt


def test_solve_max_batch_equals_jax():
    peaks = (0, 1 << 30, 3 << 30, 5 << 30)
    budgets = (1 << 30, 10 << 30, 45 << 30, 200 << 30)
    for (lo, hi), budget, cap in itertools.product(
            itertools.product(peaks, repeat=2), budgets, (16, 128)):
        assert tab.solve_max_batch(8, lo, 16, hi, budget, max_batch=cap) == \
            jab.solve_max_batch(8, lo, 16, hi, budget, max_batch=cap)
    assert tab.solve_max_batch(8, 2829128704, 16, 5642371072, 45940329676) == 128
    assert tab.DEFAULT_FRACTION == jab.DEFAULT_FRACTION and tab.PROBES == (8, 16)


def test_the_cpu_takes_the_references_cpu_batch():
    assert tab.auto_batch_size(None, None, None, None, device="cpu") == jab.DEFAULT_BATCH == 32


@pytest.mark.parametrize("note", ["none", "good", "malformed", "best_without_note"])
def test_stopper_state_equals_jax(tmp_path, note):
    tw, jw = tmp_path / "port", tmp_path / "jax"
    for w in (tw, jw):
        w.mkdir()
    if note == "good":
        for w in (tw, jw):
            (w / "fitness.json").write_text(json.dumps({"best_fitness": 0.25, "best_epoch": 7}))
    if note == "malformed":
        for w in (tw, jw):
            (w / "fitness.json").write_text("{not json")
    if note in ("malformed", "best_without_note"):
        tckpt.save_checkpoint(tw / "best.pt", {"w": torch.zeros(1)})
        (jw / "best.ckpt").mkdir()
        (jw / "best.ckpt" / "d").write_text("x")
    for start in (1, 12):
        got = tckpt.load_stopper_state(tw, start)
        assert got == jckpt.load_stopper_state(jw, start)
        if start > 1 and note in ("malformed", "best_without_note"):
            assert got[0] == 1e-12
