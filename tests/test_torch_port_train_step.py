"""The port's train step against the reference's, as a whole slice.

Float32 on the CPU at the size of the reference's own entry check (imgsz
64, batch 2, ``max_fg`` 8, four instance slots), the same seeded weights
(bridged through ``model/bridge.py``) and the same seeded batches.

What can be compared, and how closely. At this size the deep blocks
normalise over 8 values a channel, so float32 rounding moves the gradients
of the two frameworks apart by up to 1% of a leaf's largest gradient, and
AdamW's first steps move every element by the learning rate times the
*sign* of its gradient. Three BatchNorm biases in the C2PSA block
(``attn.pe``, ``attn.proj``, ``ffn.1``: shifts that the train-mode
BatchNorm of the 1x1 ``cv2`` behind them removes) have a gradient that is
zero analytically and rounding noise numerically, so their updates have a
random sign in either framework. With the reference's ``warmup_bias_lr``
of 0.1 those signs move biases by 0.1 a step and the two runs part ways
after the first apply (8% in the loss at the second micro-step). So:

* the optimizer half (cadence, clipping, AdamW's groups and decay, both
  learning rates, EMA) runs at the reference's hyperparameters on the real
  parameter tree with *injected* seeded gradients, against the reference's
  ``make_update_fn``: parameters and EMA at rtol 1e-4, atol 1e-6 (what
  ``tests/test_optimizer_torch_parity.py`` accepts between optax and
  ``torch.optim.AdamW``), over 8 micro-steps, past the precomputed horizon;
* the whole step (model in train mode, losses, backward, optimizer, EMA)
  runs 5 micro-steps, past the third apply, with ``warmup_bias_lr`` 0 so
  that every update is a few 1e-5 and the runs stay together: loss parts at
  rtol 1e-3 at every step, BatchNorm statistics at atol 2e-4, accumulated
  gradients within 1% of each leaf's largest, parameters and EMA at atol
  1e-4, and their *updates* within 10% of the leaf's largest update on at
  least 99% of a leaf's elements (the rest are sign flips of gradients
  near zero), the three biases above left out;
* the same whole step with the port's ``remat`` on (stage 2's default):
  bit for bit the plain step, and so at the same tolerances against the
  reference; and one reference micro-step built as stage 2 builds it
  (``remat=True``, from the reference's state before the third micro-step)
  against the port's rematerialised third micro-step, at the same
  tolerances.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_mslesseg.model.yolo11 import create_model as j_create
from tpu_mslesseg.train import trainer as jtr
from tpu_mslesseg_torch.model import bridge
from tpu_mslesseg_torch.model.yolo11 import create_model as t_create
from tpu_mslesseg_torch.train import trainer as ttr

S, B, M, SPE = 64, 2, 4, 2
BASE = dict(epochs=2, batch_size=B, imgsz=S, max_fg=8)
NOISE_LEAVES = ("model.10.m.0.attn.pe.bn.bias", "model.10.m.0.attn.proj.bn.bias",
                "model.10.m.0.ffn.1.bn.bias")
PARTS = ("loss", "box", "seg", "cls", "dfl")


def _batch(seed):
    """One or two bright rectangles of 20 to 44 pixels an image."""
    rng = np.random.default_rng(seed)
    images = rng.uniform(0, 1, (B, S, S, 3)).astype(np.float32)
    inst = np.zeros((B, S // 4, S // 4), np.uint8)
    boxes = np.zeros((B, M, 4), np.float32)
    valid = np.zeros((B, M), bool)
    for b in range(B):
        for i in range(rng.integers(1, 3)):
            w, h = rng.uniform(20, 44, 2)
            cx, cy = rng.uniform(w / 2, S - w / 2), rng.uniform(h / 2, S - h / 2)
            boxes[b, i] = [cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2]
            valid[b, i] = True
            x1, y1, x2, y2 = (boxes[b, i] / 4).round().astype(int)
            inst[b, y1:y2, x1:x2] = i + 1
            images[b, 4 * y1:4 * y2, 4 * x1:4 * x2] += 0.5
    return {"images": np.clip(images, 0, 1), "instmap_proto": inst, "boxes": boxes,
            "valid": valid}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def seeded():
    """The reference's model and its seeded variables as numpy trees."""
    jmodel, _ = j_create(nc=1, scale="n")
    state = jtr.init_train_state(jmodel, jtr.TrainConfig(**BASE), SPE)
    return jmodel, _np({"params": state.params, "batch_stats": state.batch_stats})


def _port_state(variables, remat=False, **kw):
    tmodel, _ = t_create(nc=1, scale="n", remat=remat)
    sd = bridge.state_dict_from_reference(variables, tmodel)
    return ttr.init_train_state(tmodel, ttr.TrainConfig(**BASE, remat=remat, **kw), SPE,
                                variables=sd, device="cpu"), sd


# ---------------------------------------------------------------------------
# the optimizer half, at the reference's hyperparameters
# ---------------------------------------------------------------------------

N_UPDATE = 8


@pytest.fixture(scope="module")
def update_runs(seeded):
    _, variables = seeded
    jcfg = jtr.TrainConfig(**BASE)
    tx, update = jtr.make_update_fn(jcfg, SPE)
    update = jax.jit(update)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    ema = jax.tree_util.tree_map(jnp.copy, params)
    opt, accum = tx.init(params), jax.tree_util.tree_map(jnp.zeros_like, params)
    state, _ = _port_state(variables)
    named = dict(state.model.named_parameters())
    rng = np.random.default_rng(3)
    leaves, treedef = jax.tree_util.tree_flatten(variables["params"])
    fired = {"jax": [], "torch": []}
    lrs = []
    for i in range(N_UPDATE):
        # a norm of about 1.7 (left alone) and of about 170 (clipped) in turns
        scale = 1e-3 if i % 2 else 1e-1
        grads = jax.tree_util.tree_unflatten(
            treedef, [rng.normal(0, scale, x.shape).astype(np.float32) for x in leaves])
        accum, opt, params, ema = update(jnp.int32(i), grads, accum, opt, params, ema)
        fired["jax"].append(not any(bool(x.any()) for x in jax.tree_util.tree_leaves(accum)))
        for name, g in bridge.tensors_from_reference(grads).items():
            p = named[name]
            p.grad = g if p.grad is None else p.grad + g
        fired["torch"].append(ttr.optimizer_step(state))
        lrs.append(state.lr)
    return {"fired": fired, "lrs": lrs, "state": state, "params": _np(params), "ema": _np(ema),
            "variables": variables}


def test_update_half_fires_at_the_reference_cadence(update_runs):
    fired = update_runs["fired"]
    assert fired["torch"] == fired["jax"]
    # the table's horizon is 4 micro-steps; past it the fixed gap of 32 continues
    assert fired["torch"] == [True, True, False, True] + [False] * (N_UPDATE - 4)
    assert update_runs["state"].applies == 3 and update_runs["state"].step == N_UPDATE


def test_update_half_learning_rates(update_runs):
    """The c-th apply takes the schedule at the c-th apply's micro-step:
    the bias group warms from 0.1, the others from 0."""
    jcfg = jtr.TrainConfig(**BASE)
    _, _, apply_ni = jtr.apply_cadence(jcfg, SPE)
    assert apply_ni.tolist() == [0, 1, 3]
    bias = jtr.lr_schedule(jcfg, SPE, start=jcfg.warmup_bias_lr)
    rest = jtr.lr_schedule(jcfg, SPE)
    got = [update_runs["lrs"][i] for i in (0, 1, 3)]
    want = [(float(bias(ni)), float(rest(ni))) for ni in apply_ni]
    assert got == want
    assert got[0] == (pytest.approx(0.1), 0.0) and got[1][1] == pytest.approx(0.002 / 100)
    groups = {g["name"]: g for g in update_runs["state"].optimizer.param_groups}
    assert groups["bias"]["lr"] == got[2][0] and groups["kernel"]["lr"] == got[2][1]
    assert groups["scale"]["lr"] == got[2][1]
    assert groups["kernel"]["weight_decay"] == pytest.approx(5e-4 * B * 32 / 64)
    assert groups["bias"]["weight_decay"] == groups["scale"]["weight_decay"] == 0.0


@pytest.mark.parametrize("what", ["params", "ema"])
def test_update_half_matches_reference(update_runs, what):
    state = update_runs["state"]
    got = dict(state.model.named_parameters()) if what == "params" else state.ema
    back = bridge.reference_from_state_dict(got, update_runs["variables"])["params"]
    flat_got = jax.tree_util.tree_leaves_with_path(back)
    flat_want = jax.tree_util.tree_leaves_with_path(update_runs[what])
    flat_init = jax.tree_util.tree_leaves(update_runs["variables"]["params"])
    assert len(flat_got) == len(flat_want) > 200
    moved = 0
    for (path, a), (_, b), init in zip(flat_got, flat_want, flat_init):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6, err_msg=str(path))
        moved += int(np.abs(b - init).max() > 1e-6)
    assert moved == len(flat_want)


def test_parameter_groups_follow_the_reference_names():
    tmodel, _ = t_create(nc=1, scale="n")
    groups = ttr.param_groups(tmodel)
    named = dict(tmodel.named_parameters())
    assert sorted(sum(groups.values(), [])) == sorted(named)
    assert all(n.endswith(".bias") for n in groups["bias"])
    assert all(n.endswith(".bn.weight") for n in groups["scale"])
    assert all(named[n].ndim == 4 for n in groups["kernel"])  # conv and transposed conv
    assert any("upsample" in n for n in groups["kernel"])
    assert any(".bn.bias" in n for n in groups["bias"]) and any(
        ".bn." not in n for n in groups["bias"])


def test_clip_by_global_norm_is_the_reference_form():
    """Scaled by 10 / norm at and above 10, untouched below: not torch's
    ``clip_grad_norm_``, which divides by ``norm + 1e-6``."""
    g = [torch.full((4,), 3.0), torch.full((9,), -1.0)]  # norm sqrt(45) < 10
    want = [x.clone() for x in g]
    norm = ttr.clip_by_global_norm(g)
    assert float(norm) == pytest.approx(45 ** 0.5) and all(
        torch.equal(a, b) for a, b in zip(g, want))
    g = [torch.full((4,), 30.0), torch.full((9,), -10.0)]
    ttr.clip_by_global_norm(g)
    total = float(torch.sqrt(sum((x * x).sum() for x in g)))
    assert total == pytest.approx(10.0, rel=1e-6)
    assert float(g[0][0]) == pytest.approx(30.0 / (4500 ** 0.5) * 10.0, rel=1e-6)


# ---------------------------------------------------------------------------
# the whole step
# ---------------------------------------------------------------------------

N_STEPS = 5
GRAD_STEP = 2  # a micro-step without an apply: the sum since the last apply is one gradient


@pytest.fixture(scope="module")
def step_runs(seeded):
    """The reference's step and the port's, with ``remat`` off (``torch``)
    and on (``torch_remat``), from the same weights on the same batches;
    then one reference micro-step built as stage 2 builds it (``remat``,
    the configuration's default) from the reference's state before
    `GRAD_STEP`, on that step's batch (``jax_remat``)."""
    jmodel, variables = seeded
    quiet = dict(warmup_bias_lr=0.0)
    jcfg = jtr.TrainConfig(**BASE, **quiet)
    jstate = jtr.init_train_state(jmodel, jcfg, SPE)
    step = jtr.make_train_step(jmodel, jcfg, SPE)
    ports = ("torch", "torch_remat")
    built = {name: _port_state(variables, remat=name == "torch_remat", **quiet)
             for name in ports}
    tstates, init_sd = {name: b[0] for name, b in built.items()}, built["torch"][1]
    rows = {"jax": [], "torch": [], "torch_remat": []}
    grads, stats = {}, {}
    for i in range(N_STEPS):
        batch = {k: jnp.asarray(v) for k, v in _batch(i).items()}
        if i == GRAD_STEP:
            before = jax.tree_util.tree_map(jnp.copy, jstate)  # the step donates its state
        jstate, jm = step(jstate, batch)
        rows["jax"].append({k: float(jm[k]) for k in PARTS})
        for name, tstate in tstates.items():
            tm = ttr.train_step(tstate, _batch(i))
            rows[name].append({**{k: float(tm[k]) for k in PARTS}, "applied": tm["applied"]})
            if i == GRAD_STEP:
                grads[name] = {n: p.grad.clone() for n, p in tstate.model.named_parameters()}
                stats[name] = {k: v.clone() for k, v in tstate.model.state_dict().items()
                               if "running_" in k}
        if i == GRAD_STEP:
            grads["jax"] = bridge.tensors_from_reference(_np(jstate.grad_accum))
            jremat, _ = j_create(nc=1, scale="n", remat=jcfg.remat)
            rstate, rm = jtr.make_train_step(jremat, jcfg, SPE)(before, batch)
            jax_remat = {"parts": {k: float(rm[k]) for k in PARTS},
                         "grads": bridge.tensors_from_reference(_np(rstate.grad_accum)),
                         "batch_stats": bridge.tensors_from_reference(_np(rstate.batch_stats),
                                                                      "batch_stats")}
    return {"rows": rows, "grads": grads, "stats": stats, "tstate": tstates, "init": init_sd,
            "jax": _np({"params": jstate.params, "ema": jstate.ema_params,
                        "batch_stats": jstate.batch_stats}), "jax_remat": jax_remat,
            "variables": variables}


def _hold_loss_parts(step_runs, port):
    rows = step_runs["rows"]
    for i, (got, want) in enumerate(zip(rows[port], rows["jax"])):
        for k in PARTS:
            assert want[k] > 0.1
            np.testing.assert_allclose(got[k], want[k], rtol=1e-3, err_msg=f"step {i}, {k}")
    assert [r["applied"] for r in rows[port]] == [True, True, False, True, False]
    assert step_runs["tstate"][port].applies == 3


def test_whole_step_loss_parts(step_runs):
    _hold_loss_parts(step_runs, "torch")


def _hold_gradients(want, got):
    """`got` within 1% of each leaf's largest gradient in `want`."""
    assert set(want) == set(got)
    alive = 0
    for name in want:
        top = float(want[name].abs().max())
        alive += int(top > 1e-4)
        err = float((got[name] - want[name]).abs().max())
        assert err <= 1e-2 * top + 1e-6, (name, err, top)
    assert alive > 150
    for name in NOISE_LEAVES:  # a gradient of rounding noise, in both frameworks
        assert float(want[name].abs().max()) < 1e-5 and float(got[name].abs().max()) < 1e-5


def test_whole_step_accumulated_gradients(step_runs):
    _hold_gradients(step_runs["grads"]["jax"], step_runs["grads"]["torch"])


def _hold_batchnorm(sd, want, init):
    """The running statistics `sd` within 2e-4 of `want`, all moved from `init`."""
    assert len(want) > 150
    for key, w in want.items():
        np.testing.assert_allclose(sd[key].numpy(), w.numpy(), atol=2e-4, rtol=0, err_msg=key)
        assert not torch.equal(sd[key], init[key])


def test_whole_step_batchnorm_statistics(step_runs):
    _hold_batchnorm(step_runs["tstate"]["torch"].model.state_dict(),
                    bridge.tensors_from_reference(step_runs["jax"]["batch_stats"], "batch_stats"),
                    step_runs["init"])


@pytest.mark.parametrize("what", ["params", "ema"])
def test_whole_step_parameters_and_ema(step_runs, what):
    _hold_parameters(step_runs, "torch", what)


def _hold_parameters(step_runs, port, what):
    tstate, init = step_runs["tstate"][port], step_runs["init"]
    got = dict(tstate.model.named_parameters()) if what == "params" else tstate.ema
    want = bridge.tensors_from_reference(step_runs["jax"][what])
    assert set(want) == set(got)
    for key, w in want.items():
        g = got[key].detach()
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-4, rtol=0, err_msg=key)
        if key in NOISE_LEAVES:
            continue
        dw, dg = w - init[key], g - init[key]
        top = float(dw.abs().max())
        if top < 1e-6:  # a level without foreground: decay alone, below float32's step
            continue
        share = float(((dg - dw).abs() > 0.1 * top).float().mean())
        assert share <= 0.01, (key, share, top)


def test_whole_step_with_remat_against_the_reference(step_runs):
    """The port's rematerialised step, as stage 2 trains, against the same
    reference run at the same tolerances."""
    port = "torch_remat"
    _hold_loss_parts(step_runs, port)
    _hold_gradients(step_runs["grads"]["jax"], step_runs["grads"][port])
    _hold_batchnorm(step_runs["tstate"][port].model.state_dict(),
                    bridge.tensors_from_reference(step_runs["jax"]["batch_stats"], "batch_stats"),
                    step_runs["init"])
    for what in ("params", "ema"):
        _hold_parameters(step_runs, port, what)


def test_whole_step_with_remat_equals_the_plain_step_bit_for_bit(step_runs):
    rows, grads, stats = step_runs["rows"], step_runs["grads"], step_runs["stats"]
    assert rows["torch_remat"] == rows["torch"]
    for a, b in ((grads["torch"], grads["torch_remat"]), (stats["torch"], stats["torch_remat"])):
        assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    a, b = (step_runs["tstate"][p].state_dict() for p in ("torch", "torch_remat"))
    for part in ("model", "ema"):
        assert all(torch.equal(a[part][k], b[part][k]) for k in a[part])


def test_a_stage_two_reference_step_against_the_ports(step_runs):
    """The reference's micro-step built as stage 2 builds it (``remat``)
    from its state before `GRAD_STEP`, against the port's rematerialised
    `GRAD_STEP`: loss parts at rtol 1e-3, gradients within 1% of each
    leaf's largest, running statistics within 2e-4."""
    assert jtr.TrainConfig().remat is ttr.TrainConfig().remat is True
    want, port = step_runs["jax_remat"], "torch_remat"
    got = step_runs["rows"][port][GRAD_STEP]
    for k in PARTS:
        assert want["parts"][k] > 0.1
        np.testing.assert_allclose(got[k], want["parts"][k], rtol=1e-3, err_msg=k)
    _hold_gradients(want["grads"], step_runs["grads"][port])
    _hold_batchnorm(step_runs["stats"][port], want["batch_stats"], step_runs["init"])


def test_train_state_runs_on_the_card_unless_the_caller_names_a_device():
    import inspect

    assert inspect.signature(ttr.init_train_state).parameters["device"].default == "cuda"
    tmodel, _ = t_create(nc=1, scale="n")
    assert not tmodel.training  # built to serve; the trainer switches modes
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no disponible"):
            ttr.init_train_state(tmodel, ttr.TrainConfig(**BASE), SPE)
    state = ttr.init_train_state(tmodel, ttr.TrainConfig(**BASE), SPE, device="cpu")
    assert state.device.type == "cpu" and state.step == 0 and state.applies == 0
    assert set(state.ema) == {n for n, _ in tmodel.named_parameters()}
    ttr.train_step(state, _batch(0))
    assert tmodel.training and state.step == 1


def test_results_writer_and_fitness(tmp_path):
    """The per-epoch CSV in the reference's schema, resumed as the
    reference resumes it."""
    import csv

    path = tmp_path / "run" / "results.csv"
    w = ttr.ResultsWriter(path)
    losses = {"box": 1.234567, "seg": 2.0, "cls": 0.5, "dfl": 0.25}
    val = {"map50_b": 0.5, "map_b": 0.25, "map50_m": 0.4, "map_m": 0.2}
    for epoch in (1, 2, 3):
        w.write_epoch(epoch, losses, val, {"box": 1.0}, (0.05, 0.001))
    rows = list(csv.reader(open(path)))
    assert rows[0] == ttr.RESULTS_HEADER == jtr.RESULTS_HEADER and len(rows) == 4
    assert rows[1][0] == "1" and rows[1][2] == "1.23457" and rows[1][-3:] == ["0.05", "0.001", "0.001"]
    ttr.ResultsWriter(path, append=True, from_epoch=3)
    rows = list(csv.reader(open(path)))
    assert [r[0] for r in rows[1:]] == ["1", "2"]
    assert ttr.fitness(val) == pytest.approx(jtr.fitness(val)) == pytest.approx(
        0.1 * 0.5 + 0.9 * 0.25 + 0.1 * 0.4 + 0.9 * 0.2)


def test_amp_computes_in_bf16_and_keeps_state_and_losses_in_float32():
    """The reference's ``amp`` is a model created with a bf16 compute dtype
    (``TrainConfig.amp``, on by default as the reference's, is read where
    stage 2 creates the model; the step computes in the model's dtype):
    parameters, their gradients, the optimizer's moments, the EMA, the
    BatchNorm statistics and every loss part stay float32."""
    assert ttr.TrainConfig().amp is jtr.TrainConfig().amp is True
    from tpu_mslesseg_torch.pipeline.stages import train as stage

    assert stage._compute_dtype(ttr.TrainConfig()) is torch.bfloat16
    assert stage._compute_dtype(ttr.TrainConfig(amp=False)) is torch.float32
    tmodel, _ = t_create(nc=1, scale="n", dtype=torch.bfloat16)
    state = ttr.init_train_state(tmodel, ttr.TrainConfig(**BASE), SPE, device="cpu")
    seen = []
    hook = tmodel.model[2].register_forward_hook(lambda m, i, o: seen.append((i[0].dtype, o.dtype)))
    metrics = ttr.train_step(state, _batch(0))
    hook.remove()
    assert seen == [(torch.bfloat16, torch.bfloat16)]
    assert all(v.dtype == torch.float32 and bool(torch.isfinite(v))
               for k, v in metrics.items() if k != "applied")
    assert metrics["applied"] is True
    assert all(v.dtype == torch.float32 for k, v in tmodel.state_dict().items()
               if "num_batches" not in k)
    assert all(v.dtype == torch.float32 for v in state.ema.values())
    for group in state.optimizer.param_groups:
        for p in group["params"]:
            st = state.optimizer.state[p]
            assert st["exp_avg"].dtype == st["exp_avg_sq"].dtype == torch.float32
            assert p.grad is None  # cleared by the apply
