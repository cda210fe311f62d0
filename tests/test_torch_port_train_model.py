"""The port's blocks and model in train mode against the flax reference.

All float32 on the CPU, inputs and weights from a seed with numpy, the
weights bridged through ``model/bridge.py``.

Tolerances. One block's outputs atol 2e-4 (the eval tolerance of
``tests/test_torch_pt.py``). The whole model's outputs in train mode atol
2e-3 against flax and 2e-4 against the port's own float64 run: every block
divides by its batch's standard deviation, at the deep levels over 16
values a channel, and about 25 blocks in sequence amplify float32 rounding.
Held against float64 the port's float32 outputs are within 6e-5 and the
reference's within 4e-4 to 9e-4 at these shapes, so the distance between the
two is the reference's own rounding, not a difference of function. Updated
running statistics of one block atol 1e-5: both sides compute
``E[x^2] - E[x]^2`` in float32, sums in another order, and the update
scales the difference by 0.03. In the whole model a deep block's statistics
are taken over activations that already differ as above, so atol 5e-5
there (0.03 of the activations' tolerance, rounded down).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_mslesseg.model.blocks import Conv as JConv
from tpu_mslesseg.model.yolo11 import create_model as j_create
from tpu_mslesseg_torch.model import bridge
from tpu_mslesseg_torch.model.blocks import Conv as TConv
from tpu_mslesseg_torch.model.yolo11 import create_model as t_create
from torch_threads import one_torch_thread  # noqa: F401


def _conv_case(seed, c1, c2, k, s, n, hw, act=True):
    """A flax Conv's variables (BN away from identity) and an input."""
    rng = np.random.default_rng(seed)
    variables = {
        "params": {
            "conv": {"kernel": rng.normal(0, 0.4, (k, k, c1, c2)).astype(np.float32)},
            "bn": {"scale": rng.uniform(0.5, 1.5, c2).astype(np.float32),
                   "bias": rng.normal(0, 0.3, c2).astype(np.float32)},
        },
        "batch_stats": {"bn": {"mean": rng.normal(0, 0.5, c2).astype(np.float32),
                               "var": rng.uniform(0.5, 2.0, c2).astype(np.float32)}},
    }
    x = rng.normal(0.2, 1.0, (n, hw, hw, c1)).astype(np.float32)
    jmod = JConv(c2, k, s, act=act)
    tmod = TConv(c1, c2, k, s, act=act)
    with torch.no_grad():
        tmod.conv.weight.copy_(torch.from_numpy(
            variables["params"]["conv"]["kernel"].transpose(3, 2, 0, 1).copy()))
        tmod.bn.weight.copy_(torch.from_numpy(variables["params"]["bn"]["scale"]))
        tmod.bn.bias.copy_(torch.from_numpy(variables["params"]["bn"]["bias"]))
        tmod.bn.running_mean.copy_(torch.from_numpy(variables["batch_stats"]["bn"]["mean"]))
        tmod.bn.running_var.copy_(torch.from_numpy(variables["batch_stats"]["bn"]["var"]))
    return jmod, tmod, variables, x


@pytest.mark.parametrize(
    "c1,c2,k,s,n,hw,act",
    [(3, 8, 3, 2, 2, 8, True), (8, 16, 1, 1, 3, 5, True), (4, 4, 3, 1, 2, 6, False),
     (5, 7, 3, 2, 1, 4, True)],  # the last: 4 values a channel
)
def test_conv_train_mode_matches_flax(c1, c2, k, s, n, hw, act):
    jmod, tmod, variables, x = _conv_case(c1 * c2 + k, c1, c2, k, s, n, hw, act)
    want, mutated = jmod.apply(variables, jnp.asarray(x), True, mutable=["batch_stats"])
    tmod.train()
    got = tmod(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.detach().permute(0, 2, 3, 1).numpy(), np.asarray(want),
                               atol=2e-4, rtol=0)
    stats = mutated["batch_stats"]["bn"]
    np.testing.assert_allclose(tmod.bn.running_mean.numpy(), np.asarray(stats["mean"]), atol=1e-5)
    np.testing.assert_allclose(tmod.bn.running_var.numpy(), np.asarray(stats["var"]), atol=1e-5)


def test_running_variance_takes_the_biased_batch_variance():
    """Eight values a channel (batch 2 of 2 x 2): the unbiased variance is
    8/7 of the biased one, which torch's own train-mode update would take."""
    jmod, tmod, variables, x = _conv_case(3, 4, 6, 1, 1, 2, 2)
    x *= 6.0  # a batch variance of tens, so that the two updates differ by far more than 1e-5
    _, mutated = jmod.apply(variables, jnp.asarray(x), True, mutable=["batch_stats"])
    want = np.array(mutated["batch_stats"]["bn"]["var"])
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    tmod.train()
    tmod(xt)
    np.testing.assert_allclose(tmod.bn.running_var.numpy(), want, atol=1e-5, rtol=1e-6)
    # what F.batch_norm(training=True) would have left there
    y = tmod.conv(xt).detach()
    old = torch.from_numpy(variables["batch_stats"]["bn"]["var"])
    unbiased = 0.97 * old + 0.03 * y.var(dim=(0, 2, 3), unbiased=True)
    assert float((unbiased - torch.from_numpy(want)).abs().min()) > 1e-3  # 100 x the tolerance
    biased = 0.97 * old + 0.03 * y.var(dim=(0, 2, 3), unbiased=False)
    np.testing.assert_allclose(biased.numpy(), want, atol=1e-4, rtol=1e-5)


def test_eval_mode_is_untouched_by_a_train_pass():
    """Eval normalises with the running statistics, as before the train mode
    existed, and a train pass changes them and nothing else."""
    _, tmod, _, x = _conv_case(9, 3, 8, 3, 2, 2, 8)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    tmod.eval()
    bn = tmod.bn
    want = torch.nn.functional.silu(torch.nn.functional.batch_norm(
        tmod.conv(xt), bn.running_mean, bn.running_var, bn.weight, bn.bias, False, 0.0, bn.eps))
    assert torch.equal(tmod(xt), want)
    before = {k: v.clone() for k, v in tmod.state_dict().items()}
    tmod.train()
    tmod(xt)
    after = tmod.state_dict()
    changed = {k for k in before if not torch.equal(before[k], after[k])}
    assert changed == {"bn.running_mean", "bn.running_var"}


@pytest.fixture(scope="module")
def reference():
    """The flax model, its seeded variables as numpy trees and its compiled
    train-mode apply."""
    model, _ = j_create(nc=1, scale="n")
    init = jax.jit(lambda k: model.init(k, jnp.zeros((1, 64, 64, 3)), train=False))
    variables = jax.tree_util.tree_map(np.asarray, init(jax.random.PRNGKey(2)))
    apply = jax.jit(lambda v, x: model.apply(v, x, train=True, mutable=["batch_stats"]))
    return model, variables, apply


def test_model_train_mode_matches_flax(reference):
    _, variables, apply = reference
    x = np.random.default_rng(11).uniform(0, 1, (4, 64, 64, 3)).astype(np.float32)
    want, mutated = apply(variables, jnp.asarray(x))
    tmodel, _ = t_create(nc=1, scale="n")
    tmodel.load_state_dict(bridge.state_dict_from_reference(variables, tmodel))
    tmodel.train()
    got = tmodel(torch.from_numpy(x))
    exact, _ = t_create(nc=1, scale="n", dtype=torch.float64)
    exact.load_state_dict(bridge.state_dict_from_reference(variables, exact))
    exact.double().train()
    got64 = exact(torch.from_numpy(x).double())
    for key in ("box", "cls", "mcoef"):
        for a, b, c in zip(got[key], want[key], got64[key]):
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), atol=2e-3, rtol=0)
            np.testing.assert_allclose(a.detach().numpy(), c.detach().numpy(), atol=2e-4, rtol=0)
    np.testing.assert_allclose(got["proto"].detach().numpy(), np.asarray(want["proto"]),
                               atol=2e-3, rtol=0)
    np.testing.assert_allclose(got["proto"].detach().numpy(), got64["proto"].detach().numpy(),
                               atol=2e-4, rtol=0)
    # every block's running statistics, leaf by leaf
    stats = bridge.reference_from_state_dict(
        {k: v for k, v in tmodel.state_dict().items() if "running_" in k},
        {"batch_stats": variables["batch_stats"]})["batch_stats"]
    want_stats = jax.tree_util.tree_map(np.asarray, mutated["batch_stats"])
    flat_got = jax.tree_util.tree_leaves_with_path(stats)
    flat_want = jax.tree_util.tree_leaves_with_path(want_stats)
    assert [p for p, _ in flat_got] == [p for p, _ in flat_want] and len(flat_got) > 150
    moved = 0
    for (path, a), (_, b) in zip(flat_got, flat_want):
        np.testing.assert_allclose(a, b, atol=5e-5, rtol=0, err_msg=str(path))
        moved += int(np.abs(a - (0.0 if "mean" in str(path[-1]) else 1.0)).max() > 1e-4)
    assert moved > 150  # the statistics left their initial 0 and 1


def test_bridge_round_trip(reference):
    """state_dict -> reference trees -> state_dict is the identity, and a
    reference-shaped gradient tree lands on the parameters' keys and shapes."""
    _, variables, _ = reference
    tmodel, _ = t_create(nc=1, scale="n")
    sd = bridge.state_dict_from_reference(variables, tmodel)
    back = bridge.reference_from_state_dict(sd, variables)
    for col in ("params", "batch_stats"):
        a = jax.tree_util.tree_leaves_with_path(back[col])
        b = jax.tree_util.tree_leaves_with_path(variables[col])
        assert [p for p, _ in a] == [p for p, _ in b]
        for (path, x), (_, y) in zip(a, b):
            np.testing.assert_array_equal(x, y, err_msg=str(path))
    grads = bridge.tensors_from_reference(variables["params"])
    named = dict(tmodel.named_parameters())
    assert set(grads) == set(named)
    assert all(grads[k].shape == named[k].shape for k in named)
    only_params = bridge.reference_from_state_dict(grads, variables)
    assert set(only_params) == {"params"}
