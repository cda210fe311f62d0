"""Rematerialised training (``create_model(remat=True)``, the JAX package's
``remat`` switch) against the stored step, torch only, on the CPU.

YOLO11n-seg at imgsz 64, batch 2, seeded weights and batches
(``tools/train_batches.synthetic_batch``), torch on one thread. ``nbs`` 6
with no warmup makes the optimizer fire every third micro-step, so three
micro-steps accumulate gradients twice and apply once. From the same weights and batches, remat on
and remat off agree bit for bit, in float32 and in bf16: every loss part,
every accumulated gradient (read as the optimizer half starts), every
BatchNorm running statistic after each micro-step, and the parameters, EMA
and AdamW moments after the apply.

The rematerialised blocks are exactly the reference's: every ``C3k2``, the
``SPPF`` and the ``C2PSA`` run their forward twice in a train step (once in
the backward), every other layer once; in eval, or with autograd off, all
once, and an eval forward with remat set equals one without.

Two controls show that the checks see the two hazards of a naive
checkpoint: a plain ``torch.utils.checkpoint`` moves the running
statistics twice and fails the statistics check (its gradients still
agree), and a recompute that loses the forward's BatchNorm axis (the step
leaves `batch_norm_axis` before its backward) fails the gradient check
under an axis whose statistics differ from the rank's own. The two-rank
step under remat is ``tests/test_torch_port_distributed.py``'s.
"""

import functools

import pytest
import torch
from torch.utils.checkpoint import checkpoint

from tpu_mslesseg_torch.model import blocks
from tpu_mslesseg_torch.model.blocks import C2PSA, C3k2, SPPF
from tpu_mslesseg_torch.model.yolo11 import create_model, init_variables
from tpu_mslesseg_torch.tools.train_batches import synthetic_batch
from tpu_mslesseg_torch.train import autobatch, augment, trainer
from tpu_mslesseg_torch.train.trainer import TrainConfig

S, B, STEPS, APPLY_AT = 64, 2, 3, 2
CFG = dict(epochs=1, batch_size=B, nbs=3 * B, warmup_epochs=0.0, imgsz=S, max_fg=8)
PARTS = ("loss", "box", "seg", "cls", "dfl")
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
REMAT_TYPES = (C3k2, SPPF, C2PSA)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Torch on one thread here: the suite runs several test processes at
    once, and each torch process's own thread pool would contend for the
    same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(seed):
    return synthetic_batch(seed, B, S, slots=4, max_valid=3, size=(0.2, 0.5))


def _stats(model):
    return {n: b.clone() for n, b in model.named_buffers() if "running_" in n}


def _run(remat, dtype, steps=STEPS):
    """`steps` micro-steps from seed 0's weights; per micro-step the loss
    parts, whether it applied, the accumulated gradients as the optimizer
    half began and the running statistics after it; then the state."""
    model, _ = create_model(nc=1, scale="n", dtype=dtype, remat=remat)
    state = trainer.init_train_state(model, TrainConfig(**CFG), STEPS,
                                     variables=init_variables(model, 0), device="cpu")
    grads = []
    real = trainer.optimizer_step

    def read_grads(st):
        grads.append({n: p.grad.clone() for n, p in st.model.named_parameters()})
        return real(st)

    rows = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(trainer, "optimizer_step", read_grads)
        for i in range(steps):
            m = trainer.train_step(state, _batch(i))
            rows.append({"parts": {k: m[k].clone() for k in PARTS}, "applied": m["applied"],
                         "grads": grads[-1], "stats": _stats(model)})
    return {"rows": rows, "state": state.state_dict(), "init": init_variables(model, 0)}


@pytest.fixture(scope="module", params=list(DTYPES))
def runs(request):
    dtype = DTYPES[request.param]
    return {"plain": _run(False, dtype), "remat": _run(True, dtype)}


def _differing(a: dict, b: dict) -> list:
    assert set(a) == set(b)
    return [k for k in a if not torch.equal(a[k], b[k])]


def test_the_optimizer_fires_once_at_the_third_micro_step(runs):
    for run in runs.values():
        assert [r["applied"] for r in run["rows"]] == [i == APPLY_AT for i in range(STEPS)]


def test_loss_parts_equal_bit_for_bit(runs):
    for i, (a, b) in enumerate(zip(runs["plain"]["rows"], runs["remat"]["rows"])):
        assert _differing(a["parts"], b["parts"]) == [], i
        assert all(bool(torch.isfinite(v)) and float(v) > 0 for v in a["parts"].values())


def test_accumulated_gradients_equal_bit_for_bit(runs):
    for i, (a, b) in enumerate(zip(runs["plain"]["rows"], runs["remat"]["rows"])):
        assert _differing(a["grads"], b["grads"]) == [], i
        alive = sum(int(float(g.abs().max()) > 0) for g in a["grads"].values())
        assert alive > 150, alive


def test_running_statistics_move_once_and_equal_bit_for_bit(runs):
    init = {k: v for k, v in runs["plain"]["init"].items() if "running_" in k}
    for i, (a, b) in enumerate(zip(runs["plain"]["rows"], runs["remat"]["rows"])):
        assert _differing(a["stats"], b["stats"]) == [], i
    assert len(_differing(init, runs["remat"]["rows"][0]["stats"])) == len(init) > 150


@pytest.mark.parametrize("part", ["model", "ema"])
def test_parameters_and_ema_after_the_apply_equal_bit_for_bit(runs, part):
    a, b = runs["plain"]["state"], runs["remat"]["state"]
    assert _differing(a[part], b[part]) == []
    init = runs["plain"]["init"]
    moved = [k for k, v in a[part].items() if k in init and "running_" not in k
             and "num_batches" not in k and not torch.equal(v, init[k])]
    assert len(moved) > 150


def test_adamw_moments_after_the_apply_equal_bit_for_bit(runs):
    a, b = runs["plain"]["state"]["optimizer"], runs["remat"]["state"]["optimizer"]
    assert a["state"].keys() == b["state"].keys() and len(a["state"]) > 150
    for i, st in a["state"].items():
        assert _differing(st, b["state"][i]) == [], i


# --------------------------------------------------------------------------
# which blocks are rematerialised, and when
# --------------------------------------------------------------------------

def _forward_calls(model, train: bool, grad: bool) -> dict:
    """How many times each of ``model.model``'s layers began a forward in
    one forward (and, with autograd on, one backward)."""
    calls = dict.fromkeys(range(len(model.model)), 0)
    hooks = [layer.register_forward_pre_hook(
        lambda mod, args, i=i: calls.__setitem__(i, calls[i] + 1))
        for i, layer in enumerate(model.model)]
    model.train(train)
    x = torch.from_numpy(_batch(0)["images"])
    try:
        with torch.set_grad_enabled(grad):
            out = model(x)
            if grad:
                sum(t.float().square().mean() for v in out.values()
                    for t in (v if isinstance(v, list) else [v])).backward()
    finally:
        for h in hooks:
            h.remove()
        model.eval()
    return calls


def test_remat_recomputes_exactly_the_reference_blocks():
    model, _ = create_model(nc=1, scale="n", remat=True)
    remat = [i for i, layer in enumerate(model.model) if isinstance(layer, REMAT_TYPES)]
    assert remat == list(model.REMAT_LAYERS) == [2, 4, 6, 8, 9, 10, 13, 16, 19, 22]
    calls = _forward_calls(model, train=True, grad=True)
    assert calls == {i: 2 if i in remat else 1 for i in calls}
    for train, grad in ((True, False), (False, True), (False, False)):
        assert set(_forward_calls(model, train, grad).values()) == {1}, (train, grad)
    plain, _ = create_model(nc=1, scale="n")
    assert plain.remat is False and set(_forward_calls(plain, True, True).values()) == {1}


@pytest.mark.parametrize("grad", [False, True])
def test_an_eval_forward_with_remat_equals_one_without(grad):
    a, _ = create_model(nc=1, scale="n", remat=True)
    b, _ = create_model(nc=1, scale="n")
    sd = init_variables(a, 1)
    a.load_state_dict(sd)
    b.load_state_dict(sd)
    x = torch.from_numpy(_batch(1)["images"])
    with torch.set_grad_enabled(grad):
        ya, yb = a(x), b(x)
    flat = lambda y: [t for v in y.values() for t in (v if isinstance(v, list) else [v])]
    assert all(torch.equal(p, q) for p, q in zip(flat(ya), flat(yb)))
    assert not a.training and _differing(_stats(a), _stats(b)) == []


# --------------------------------------------------------------------------
# the BatchNorm axis in the recompute, and the two controls
# --------------------------------------------------------------------------

class MirrorAxis:
    """A stand-in data axis of two ranks whose other rank's per-channel
    means are this rank's in reverse channel order: the whole batch's
    statistics differ from this rank's own."""

    size = 2

    def all_reduce_grad(self, t):
        return t + t.detach().flip(-1)


def _axis_step(remat: bool, axis):
    """The train step's order on one model: the forward under
    `batch_norm_axis`, the backward after leaving it. Returns the gradients
    and the running statistics."""
    model, _ = create_model(nc=1, scale="n", remat=remat)
    model.load_state_dict(init_variables(model, 2))
    model.train()
    with blocks.batch_norm_axis(axis):
        out = model(torch.from_numpy(_batch(2)["images"]))
    sum(t.square().mean() for v in out.values()
        for t in (v if isinstance(v, list) else [v])).backward()
    return {n: p.grad.clone() for n, p in model.named_parameters()}, _stats(model)


@pytest.fixture(scope="module")
def axis_plain():
    return _axis_step(False, MirrorAxis())


def test_the_recompute_normalises_over_the_forwards_axis(axis_plain):
    grads, stats = _axis_step(True, MirrorAxis())
    assert _differing(axis_plain[0], grads) == []
    assert _differing(axis_plain[1], stats) == []
    # the axis matters: without it the same step gives other gradients
    assert _differing(axis_plain[0], _axis_step(False, None)[0])


def test_control_a_plain_checkpoint_moves_the_statistics_twice(monkeypatch):
    plain = _run(False, torch.float32, steps=1)["rows"][0]
    monkeypatch.setattr(blocks, "rematerialise", lambda block, x: checkpoint(
        block, x, use_reentrant=False))
    naive = _run(True, torch.float32, steps=1)["rows"][0]
    assert _differing(plain["parts"], naive["parts"]) == []
    assert _differing(plain["grads"], naive["grads"]) == []  # the gradients do not see it
    moved_twice = _differing(plain["stats"], naive["stats"])
    prefixes = tuple(f"model.{i}." for i in (2, 4, 6, 8, 9, 10, 13, 16, 19, 22))
    assert moved_twice and all(k.startswith(prefixes) for k in moved_twice)


def test_control_a_recompute_that_loses_the_axis_fails_the_gradient_check(
        monkeypatch, axis_plain):
    monkeypatch.setattr(blocks, "_remat_contexts", lambda: (
        blocks.contextlib.nullcontext(), blocks._recompute(None)))
    grads, stats = _axis_step(True, MirrorAxis())
    assert _differing(axis_plain[1], stats) == []  # the forward's statistics are right
    lost = _differing(axis_plain[0], grads)
    assert len(lost) > 10


# --------------------------------------------------------------------------
# the configuration and the auto-batch cache
# --------------------------------------------------------------------------

def test_remat_is_on_by_default_in_training_and_off_in_a_model():
    assert TrainConfig().remat is True
    assert create_model()[0].remat is False


def test_the_autobatch_key_differs_with_remat():
    acfg = augment.AugConfig(imgsz=S, max_inst=8, mosaic=True)
    key = functools.partial(autobatch.cache_key, "NVIDIA H100 80GB HBM3", 85 * 2**30,
                            acfg=acfg, fraction=0.6, max_batch=128, train_bytes=12345)
    keys = {remat: key(model=create_model(scale="s", remat=remat)[0],
                       cfg=TrainConfig(imgsz=S, remat=remat)) for remat in (False, True)}
    assert keys[False] != keys[True]
    assert keys[False].replace("|False|", "|True|", 1) == keys[True]
    # the same model and configuration give the same key
    assert key(model=create_model(scale="s", remat=True)[0],
               cfg=TrainConfig(imgsz=S, remat=True)) == keys[True]
