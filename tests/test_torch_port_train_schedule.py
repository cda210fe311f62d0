"""The port's optimizer cadence and learning-rate schedule against the
reference's, exactly.

``apply_cadence`` is numpy and Python ``round`` on both sides, so its three
arrays are equal element by element. ``lr_schedule`` is float32 arithmetic
on both sides, operation by operation in the same order (jax.numpy run
eagerly on the CPU against numpy), so the linear schedule's values are
equal bit for bit; the cosine variant goes through two libraries' float32
``cos``, one ulp apart at some arguments, and is held at rtol 1e-6.
"""

import numpy as np
import pytest

from tpu_mslesseg.train import trainer as jtr
from tpu_mslesseg_torch.train import trainer as ttr

# (batch, nbs, warmup_epochs, steps_per_epoch, epochs)
CASES = [
    (16, 64, 3.0, 8, 50),     # the smoke run's: the gap ramps 1 -> 4 over 100 micro-steps
    (32, 64, 3.0, 40, 50),    # the default batch: nw = 120
    (2, 64, 3.0, 2, 2),       # the tiny train-step test: a horizon of 4 micro-steps
    (8, 64, 0.0, 10, 5),      # no warmup: a fixed gap of 8 from the start
    (24, 64, 1.5, 30, 4),     # nbs / batch = 2.67: rounds to 3
    (128, 64, 3.0, 12, 6),    # a batch above the nominal one: every micro-step applies
    (26, 64, 2.0, 7, 9),      # nbs / batch = 2.46: rounds to 2
    (5, 64, 0.5, 300, 2),     # a gap of 13 reached at nw = 150
]
IDS = [f"b{b}-nbs{n}-w{w}-spe{s}-e{e}" for b, n, w, s, e in CASES]


def _cfgs(batch, nbs, warmup, epochs, **kw):
    common = dict(batch_size=batch, nbs=nbs, warmup_epochs=warmup, epochs=epochs, **kw)
    return jtr.TrainConfig(**common), ttr.TrainConfig(**common)


@pytest.mark.parametrize("batch,nbs,warmup,spe,epochs", CASES, ids=IDS)
def test_accumulate_steps_and_apply_cadence_equal_the_reference(batch, nbs, warmup, spe, epochs):
    jcfg, tcfg = _cfgs(batch, nbs, warmup, epochs)
    assert ttr.accumulate_steps(tcfg) == jtr.accumulate_steps(jcfg)
    for total in (None, 3 * spe + 1):
        want = jtr.apply_cadence(jcfg, spe, total)
        got = ttr.apply_cadence(tcfg, spe, total)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    mask, n_applies, apply_ni = ttr.apply_cadence(tcfg, spe)
    assert mask.sum() == n_applies[-1] and (mask.sum() == 0 or mask[apply_ni].all())


@pytest.mark.parametrize("cos_lr", [False, True], ids=["linear", "cosine"])
@pytest.mark.parametrize("batch,nbs,warmup,spe,epochs", CASES, ids=IDS)
def test_lr_schedule_equals_the_reference(batch, nbs, warmup, spe, epochs, cos_lr):
    jcfg, tcfg = _cfgs(batch, nbs, warmup, epochs, cos_lr=cos_lr)
    steps = sorted({0, 1, 2, 17, 99, 100, 101, spe - 1, spe, spe * epochs // 2,
                    spe * epochs - 1, spe * epochs + 5})
    for start in (0.0, jcfg.warmup_bias_lr):
        want_fn = jtr.lr_schedule(jcfg, spe, start=start)
        got_fn = ttr.lr_schedule(tcfg, spe, start=start)
        for step in steps:
            want = np.asarray(want_fn(step))
            got = got_fn(step)
            assert got.dtype == np.float32 and want.dtype == np.float32
            if cos_lr:
                np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
            else:
                assert got.tobytes() == want.tobytes(), (step, start, float(got), float(want))


@pytest.mark.parametrize("batch,nbs,warmup,spe,epochs", CASES, ids=IDS)
def test_cadence_past_the_horizon_continues_the_fixed_gap(batch, nbs, warmup, spe, epochs):
    """`cadence_at` is the table inside the precomputed horizon and the
    reference's rule past it (``make_update_fn``: the fixed gap counted from
    the last precomputed apply)."""
    _, tcfg = _cfgs(batch, nbs, warmup, epochs)
    mask, n_applies, apply_ni = ttr.apply_cadence(tcfg, spe)
    fixed = ttr.accumulate_steps(tcfg)
    for step in range(mask.size):
        assert ttr.cadence_at(tcfg, spe, step) == (bool(mask[step]), int(n_applies[step]))
    last = int(apply_ni[-1])
    for step in range(mask.size, mask.size + 3 * fixed + 2):
        since = step - last
        assert ttr.cadence_at(tcfg, spe, step) == (
            since > 0 and since % fixed == 0, int(n_applies[-1]) + since // fixed)
