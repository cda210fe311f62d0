"""The eval epilogue of the port's ``Conv`` block (``model/bn_act.py``) on
the CPU, where ``bn_act`` takes its plain version ``bn_act_ref``.

``bn_act_ref`` must be the block's eval expression, bit for bit: the kernel
(``csrc/bn_act.cu``, held against ``bn_act_ref`` on the card by
``tests/test_torch_port_cuda.py``) copies that expression's roundings. The
block against the JAX package's ``Conv`` in float32: atol and rtol 2e-5
(the two convolutions sum in different orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tpu_mslesseg.model import blocks as jblocks
from tpu_mslesseg_torch.bench import cells
from tpu_mslesseg_torch.model import blocks, bn_act

DTYPES = (torch.float32, torch.bfloat16)


def _bn(c, seed):
    """A BatchNorm2d (eps 1e-3) whose statistics and affine terms are away
    from their init."""
    rng = np.random.default_rng(seed)
    bn = torch.nn.BatchNorm2d(c, eps=1e-3).eval()
    with torch.no_grad():
        bn.running_mean.copy_(torch.from_numpy(rng.normal(0.2, 1.0, c).astype(np.float32)))
        bn.running_var.copy_(torch.from_numpy(rng.uniform(1e-4, 3.0, c).astype(np.float32)))
        bn.weight.copy_(torch.from_numpy(rng.normal(1.0, 0.3, c).astype(np.float32)))
        bn.bias.copy_(torch.from_numpy(rng.normal(0.0, 0.5, c).astype(np.float32)))
    return bn


def _activation(shape, dtype, fmt, seed):
    rng = np.random.default_rng(seed)
    y = torch.from_numpy((rng.standard_normal(shape) * 3).astype(np.float32)).to(dtype)
    return y.contiguous(memory_format=torch.channels_last) if fmt == "channels_last" else y


def _eval_expression(y, bn, act):
    """The block's eval epilogue as it was written before the kernel."""
    z = F.batch_norm(y.float(), bn.running_mean, bn.running_var, bn.weight, bn.bias,
                     False, 0.0, bn.eps)
    if act:
        z = F.silu(z)
    return z.to(y.dtype)


@pytest.mark.parametrize("act", [True, False])
@pytest.mark.parametrize("fmt", ["channels_last", "nchw"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_plain_version_is_the_blocks_eval_expression(dtype, fmt, act):
    y = _activation((2, 16, 9, 7), dtype, fmt, 1)
    bn = _bn(16, 2)
    want = _eval_expression(y, bn, act)
    got = bn_act.bn_act_ref(y, bn, act)
    assert got.dtype == dtype and torch.equal(got, want)
    before = bn_act.LAUNCHES
    assert torch.equal(bn_act.bn_act(y, bn, act), want)  # a CPU tensor: the plain version
    assert bn_act.LAUNCHES == before


def _conv(c1, c2, k, s, dtype, act, seed):
    conv = blocks.Conv(c1, c2, k, s, act=act)
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        conv.conv.weight.copy_(torch.from_numpy(
            rng.standard_normal(conv.conv.weight.shape).astype(np.float32) / np.sqrt(c1 * k * k)))
    conv.bn = _bn(c2, seed + 1)
    x = _activation((2, c1, 12, 10), dtype, "channels_last", seed + 2)
    return conv, x


@pytest.mark.parametrize("grad", [True, False])
@pytest.mark.parametrize("dtype", DTYPES)
def test_conv_eval_on_the_cpu_launches_nothing(dtype, grad):
    conv, x = _conv(8, 16, 3, 1, dtype, True, 3)
    assert not conv.training
    before = bn_act.LAUNCHES
    with torch.set_grad_enabled(grad):
        got = conv(x)
    assert bn_act.LAUNCHES == before
    y = conv.conv._conv_forward(x, conv.conv.weight.to(dtype), None)
    assert got.dtype == dtype and torch.equal(got.detach(), _eval_expression(y, conv.bn, True))
    assert got.requires_grad == grad  # with autograd on, the plain version, differentiable


def test_the_bf16_epilogue_control_still_reaches_the_epilogue():
    conv, x = _conv(8, 16, 3, 1, torch.bfloat16, True, 4)
    with torch.inference_mode():
        sound = conv(x)
        with cells.CONTROLS["bf16-epilogue"]():
            control = conv(x)
        again = conv(x)
    assert torch.equal(sound, again)
    assert not torch.equal(sound, control)


@pytest.mark.parametrize("act", [True, False])
def test_conv_matches_the_jax_block(act):
    conv, x = _conv(8, 16, 3, 2, torch.float32, act, 5)
    jconv = jblocks.Conv(c2=16, k=3, s=2, act=act)
    x_np = x.permute(0, 2, 3, 1).numpy()
    variables = jax.tree_util.tree_map(np.asarray, jconv.init(jax.random.PRNGKey(0), x_np))
    variables["params"]["conv"]["kernel"] = conv.conv.weight.detach().permute(2, 3, 1, 0).numpy()
    variables["params"]["bn"] = {"scale": conv.bn.weight.detach().numpy(),
                                 "bias": conv.bn.bias.detach().numpy()}
    variables["batch_stats"]["bn"] = {"mean": conv.bn.running_mean.numpy(),
                                      "var": conv.bn.running_var.numpy()}
    want = np.asarray(jconv.apply(variables, jnp.asarray(x_np)))
    with torch.inference_mode():
        got = conv(x).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)


def test_layouts_the_kernel_takes():
    y = torch.zeros((2, 16, 5, 4))
    assert bn_act.layout(y) == "nchw"
    assert bn_act.layout(y.contiguous(memory_format=torch.channels_last)) == "channels_last"
    # strides that fit both layouts read as NCHW, as the batch norm reads them
    assert bn_act.layout(torch.zeros((2, 1, 1, 16)).permute(0, 3, 1, 2)) == "nchw"
    assert bn_act.layout(y[:, :, :, :2]) is None
    assert bn_act.layout(y.transpose(2, 3)) is None


def test_a_meta_tensor_takes_the_plain_version():
    """An operation count runs the model on the meta device (``bench/flops.py``)."""
    y = torch.zeros((1, 4, 2, 2), device="meta", dtype=torch.bfloat16)
    before = bn_act.LAUNCHES
    got = bn_act.bn_act(y, _bn(4, 6).to("meta"), True)
    assert got.device.type == "meta" and got.shape == y.shape and got.dtype == y.dtype
    assert bn_act.LAUNCHES == before
