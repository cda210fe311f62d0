"""The port's ``batch=-1`` (``train/autobatch.py``) and stopper state
(``train/checkpoint.load_stopper_state``) against the JAX package's.

``solve_max_batch`` is the reference's line through two probe points,
copied as it is: equal on a grid of probes and budgets. On the CPU, asked
for by name, the batch is the reference's CPU default (32). The stopper
state resumes best fitness and its epoch from ``fitness.json`` as the
reference does, with its 1e-12 floor for a best checkpoint without a note.
The card's probe itself runs in ``chip_smoke.py`` phase 15. Under
``TPU_MSLESSEG_HBM_BYTES`` (the card and its probes faked by monkeypatching)
the budget is the default fraction of the override less what the process
holds, never more than is free; the override keys the cache, and a value
that is not an integer raises, as the reference's ``int(env)`` does.
"""

import itertools
import json
import types

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


# ---------------------------------------------------------------------------
# TPU_MSLESSEG_HBM_BYTES: the card's usable bytes, set by the user
# ---------------------------------------------------------------------------

GIB = 1 << 30
FREE, TOTAL, HELD = 70 * GIB, 80 * GIB, 2 * GIB
PEAKS = {8: 3 * GIB, 16: 5 * GIB}  # 0.25 GiB an image above 1 GiB


@pytest.fixture
def fake_card(monkeypatch, tmp_path):
    """A card with `FREE` of `TOTAL` bytes free and `HELD` allocated by the
    process, whose probes peak at `PEAKS`; returns the batches probed."""
    from tpu_mslesseg_torch.model.yolo11 import create_model
    from tpu_mslesseg_torch.train import augment
    from tpu_mslesseg_torch.train.trainer import TrainConfig

    monkeypatch.delenv(tab.HBM_ENV, raising=False)
    monkeypatch.setenv("TPU_MSLESSEG_AUTOBATCH_CACHE", str(tmp_path / "autobatch.json"))
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda dev=None: (FREE, TOTAL))
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda dev=None: "NVIDIA H100 80GB HBM3")
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda dev=None: HELD)
    probed = []

    def probe(model, cfg, train_set, acfg, batch_size, device):
        probed.append(batch_size)
        return PEAKS[batch_size]

    monkeypatch.setattr(tab, "probe_peak", probe)
    args = (create_model(scale="n")[0], TrainConfig(imgsz=64),
            types.SimpleNamespace(nbytes=lambda: 12345),
            augment.AugConfig(imgsz=64, max_inst=8, mosaic=True))
    return probed, lambda **kw: tab.auto_batch_size(*args, device="cuda", **kw)


def _solved(budget):
    return tab.solve_max_batch(8, PEAKS[8], 16, PEAKS[16], budget)


def test_the_override_sets_the_budget_and_keys_the_cache(fake_card, monkeypatch):
    probed, resolve = fake_card
    held_reads = []
    monkeypatch.setattr(torch.cuda, "memory_allocated",
                        lambda dev=None: held_reads.append(dev) or HELD)
    assert resolve() == _solved(int(FREE * tab.DEFAULT_FRACTION)) == 128  # the card's free
    assert probed == [8, 16] and held_reads == []  # no override: what is held goes unread
    override = 12 * GIB
    monkeypatch.setenv(tab.HBM_ENV, str(override))
    want = _solved(int(override * tab.DEFAULT_FRACTION) - HELD)
    assert want == 16  # (7.2 - 2 - 1) GiB at 0.25 GiB an image, to a multiple of 8
    assert resolve(n_data=2) == 2 * want
    assert probed == [8, 16] * 2  # another override misses the cache
    assert resolve() == want and probed == [8, 16] * 2  # the same one hits it
    monkeypatch.setenv(tab.HBM_ENV, str(override + 8 * GIB))
    assert resolve() == _solved(int((override + 8 * GIB) * tab.DEFAULT_FRACTION) - HELD) == 32
    assert probed == [8, 16] * 3
    monkeypatch.delenv(tab.HBM_ENV)
    assert resolve() == 128 and probed == [8, 16] * 3  # the card's entry is kept


def test_a_valid_override_leaves_the_cpu_batch(monkeypatch):
    """The CPU has no peak to read, so it keeps its batch under an override
    (the reference solves its compile's peaks against it): a narrowing."""
    monkeypatch.setenv(tab.HBM_ENV, str(12 * GIB))
    assert jab.device_hbm_bytes() == 12 * GIB
    assert tab.auto_batch_size(None, None, None, None, device="cpu") == tab.DEFAULT_BATCH == 32


def test_the_override_never_budgets_more_than_is_free(fake_card, monkeypatch):
    _, resolve = fake_card
    monkeypatch.setenv(tab.HBM_ENV, str(1 << 50))
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda dev=None: (10 * GIB, TOTAL))
    assert resolve(max_batch=4096) == _solved(10 * GIB) // 8 * 8 == 32


@pytest.mark.parametrize("value", ["80GB", "1.5e9", "0x10"])
def test_an_override_that_is_not_an_integer_raises(fake_card, monkeypatch, value):
    _, resolve = fake_card
    monkeypatch.setenv(tab.HBM_ENV, value)
    with pytest.raises(ValueError):
        jab.device_hbm_bytes()  # the reference's int(env)
    with pytest.raises(ValueError):
        resolve()
    with pytest.raises(ValueError):
        tab.auto_batch_size(None, None, None, None, device="cpu")


def test_an_override_below_what_the_process_holds_refuses(fake_card, monkeypatch):
    probed, resolve = fake_card
    monkeypatch.setenv(tab.HBM_ENV, str(3 * GIB))  # 60% of it is less than HELD
    with pytest.raises(ValueError, match="ningún batch cabe"):
        resolve()
    assert probed == [8, 16]
    assert tab._cache_load() == {}  # a refusal is not cached
