"""YOLO11 building blocks as ``nn.Module``s (NCHW inside).

Port of ``tpu_mslesseg/model/blocks.py``. Attribute names follow
ultralytics (``conv``/``bn``, ``cv1``/``cv2``/``cv3``, ``m``, ``attn``,
``ffn``, ``upsample``), so a state_dict has the keys of a real
``yolo11*-seg.pt``.

Dtype rules are the reference's, not torch autocast's. Parameters are
kept in float32 and cast to the compute dtype at each convolution (flax's
``promote_dtype``). BatchNorm (eps 1e-3) and SiLU run in float32, and the
block output is cast back to the compute dtype (in eval with autograd off
in one pass, ``model/bn_act.py``: a fused kernel on the card). The
attention softmax runs in float32 and is cast back. Residual adds and
concats therefore run in the compute dtype.

In train mode (``module.train()``) a block normalises with the batch's own
statistics and updates the running ones, both as the reference's flax
``BatchNorm`` does and not as ``F.batch_norm(training=True)`` does: the
variance is ``E[x^2] - E[x]^2`` in float32 (clamped at 0), and the running
variance takes that *biased* value (torch's takes the unbiased one). A
block is built in eval mode, and so is the model (``nn.Module`` builds in
train mode): serving code never has to ask for it, and only the trainer
switches to train mode.

Under `batch_norm_axis` (a data-parallel step over one batch split across
ranks, ``core.mesh.DataAxis`` with ``global_batch``) the batch statistics
are the whole batch's: each rank's per-channel means of ``x`` and ``x^2``
are averaged over the axis, with a gradient, as the JAX package's BatchNorm
reduces over a batch that XLA shards.

`rematerialise` runs a block under ``torch.utils.checkpoint`` (the JAX
package's ``nn.remat``): its activations are dropped after the forward and
recomputed in the backward. The recompute normalises with the batch
statistics over the axis the forward saw (the backward runs after the step
has left `batch_norm_axis`) and leaves the running statistics alone, so
they move once a forward and every result equals the stored step's, bit for
bit.
"""

from __future__ import annotations

import contextlib
import contextvars
import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from tpu_mslesseg_torch.model import bn_act

_BN_AXIS = contextvars.ContextVar("batch_norm_axis", default=None)
# set while a rematerialised block recomputes its forward in the backward
_RECOMPUTING = contextvars.ContextVar("batch_norm_recomputing", default=False)


@contextlib.contextmanager
def batch_norm_axis(axis):
    """Train-mode BatchNorm inside the block normalises with the statistics
    of the batch split over `axis` (a ``core.mesh.DataAxis``; None: this
    rank's own batch)."""
    token = _BN_AXIS.set(axis)
    try:
        yield
    finally:
        _BN_AXIS.reset(token)


@contextlib.contextmanager
def _recompute(axis):
    """The backward's recompute of a rematerialised block: its BatchNorms
    normalise over the forward's `axis` and leave the running statistics
    alone."""
    axis_token, flag_token = _BN_AXIS.set(axis), _RECOMPUTING.set(True)
    try:
        yield
    finally:
        _RECOMPUTING.reset(flag_token)
        _BN_AXIS.reset(axis_token)


def _remat_contexts():
    """``checkpoint``'s contexts, taken at the forward: none for the
    forward, `_recompute` over the forward's axis for the recompute."""
    return contextlib.nullcontext(), _recompute(_BN_AXIS.get())


def rematerialise(block, x):
    """``block(x)`` whose activations are recomputed in the backward instead
    of stored. The blocks draw no random number, so the RNG state is not
    saved for the recompute."""
    return checkpoint(block, x, use_reentrant=False, context_fn=_remat_contexts,
                      preserve_rng_state=False)


class Conv(nn.Module):
    """Conv2d(no bias) + BatchNorm + SiLU."""

    def __init__(self, c1, c2, k=1, s=1, g=1, act=True):
        super().__init__()
        self.conv = nn.Conv2d(c1, c2, k, s, k // 2, groups=g, bias=False)
        self.bn = nn.BatchNorm2d(c2, eps=1e-3, momentum=0.03)
        self.act = act
        self.eval()  # a block serves unless a trainer calls ``.train()``

    def forward(self, x):
        """In eval mode with autograd off (serving, validation) the epilogue
        is ``bn_act.bn_act``: the fused kernel on a CUDA tensor, the plain
        version on the CPU. An eval call with autograd on takes the plain
        version ``bn_act.bn_act_ref``, which autograd can differentiate: the
        kernel has no backward."""
        y = self.conv._conv_forward(x, self.conv.weight.to(x.dtype), None)
        if not self.training:
            epilogue = bn_act.bn_act_ref if torch.is_grad_enabled() else bn_act.bn_act
            return epilogue(y, self.bn, self.act)
        y = self._batch_norm_train(y.float())
        if self.act:
            y = F.silu(y)
        return y.to(x.dtype)

    def _batch_norm_train(self, y):
        """Batch norm of float32 `y` with its batch statistics; moves the
        running statistics by ``bn.momentum`` towards them (in place), but
        not in a rematerialised block's recompute."""
        bn = self.bn
        mean, sq = y.mean(dim=(0, 2, 3)), (y * y).mean(dim=(0, 2, 3))
        axis = _BN_AXIS.get()
        if axis is not None:
            # every rank's batch is the same size: the mean of the means
            mean, sq = (axis.all_reduce_grad(torch.stack([mean, sq])) / axis.size).unbind(0)
        var = (sq - mean * mean).clamp_min(0.0)
        if not _RECOMPUTING.get():
            with torch.no_grad():
                keep = 1.0 - bn.momentum
                bn.running_mean.mul_(keep).add_(mean, alpha=bn.momentum)
                bn.running_var.mul_(keep).add_(var, alpha=bn.momentum)
        mul = torch.rsqrt(var + bn.eps) * bn.weight
        return (y - mean[:, None, None]) * mul[:, None, None] + bn.bias[:, None, None]


class DWConv(Conv):
    """Depthwise Conv (groups == gcd of the channel counts)."""

    def __init__(self, c1, c2, k=3, s=1, act=True):
        super().__init__(c1, c2, k, s, g=math.gcd(c1, c2), act=act)


class CastConv2d(nn.Conv2d):
    """Conv2d with bias whose parameters are cast to the input's dtype."""

    def forward(self, x):
        return self._conv_forward(
            x, self.weight.to(x.dtype), self.bias.to(x.dtype)
        )


class CastConvTranspose2d(nn.ConvTranspose2d):
    """ConvTranspose2d whose parameters are cast to the input's dtype."""

    def forward(self, x):
        return F.conv_transpose2d(
            x, self.weight.to(x.dtype), self.bias.to(x.dtype),
            self.stride, self.padding, self.output_padding, self.groups,
            self.dilation,
        )


class Bottleneck(nn.Module):
    def __init__(self, c1, c2, shortcut=True, g=1, k=(3, 3), e=0.5):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = Conv(c1, c_, k[0], 1)
        self.cv2 = Conv(c_, c2, k[1], 1, g=g)
        self.add = shortcut and c1 == c2

    def forward(self, x):
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class C3k(nn.Module):
    """CSP bottleneck with 3 convs and kernel-k inner bottlenecks."""

    def __init__(self, c1, c2, n=1, shortcut=True, g=1, e=0.5, k=3):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = Conv(c1, c_, 1, 1)
        self.cv2 = Conv(c1, c_, 1, 1)
        self.cv3 = Conv(2 * c_, c2, 1)
        self.m = nn.Sequential(
            *(Bottleneck(c_, c_, shortcut, g, k=(k, k), e=1.0) for _ in range(n))
        )

    def forward(self, x):
        return self.cv3(torch.cat((self.m(self.cv1(x)), self.cv2(x)), 1))


class C3k2(nn.Module):
    """C2f-style split block whose inner module is C3k or Bottleneck."""

    def __init__(self, c1, c2, n=1, c3k=False, e=0.5, g=1, shortcut=True):
        super().__init__()
        self.c = int(c2 * e)
        self.cv1 = Conv(c1, 2 * self.c, 1, 1)
        self.cv2 = Conv((2 + n) * self.c, c2, 1)
        self.m = nn.ModuleList(
            C3k(self.c, self.c, 2, shortcut, g) if c3k
            else Bottleneck(self.c, self.c, shortcut, g, k=(3, 3), e=0.5)
            for _ in range(n)
        )

    def forward(self, x):
        y = list(self.cv1(x).split((self.c, self.c), 1))
        y.extend(m(y[-1]) for m in self.m)
        return self.cv2(torch.cat(y, 1))


class SPPF(nn.Module):
    """Spatial pyramid pooling (fast): 3 chained stride-1 max-pools."""

    def __init__(self, c1, c2, k=5):
        super().__init__()
        c_ = c1 // 2
        self.cv1 = Conv(c1, c_, 1, 1)
        self.cv2 = Conv(c_ * 4, c2, 1, 1)
        self.m = nn.MaxPool2d(kernel_size=k, stride=1, padding=k // 2)

    def forward(self, x):
        y = [self.cv1(x)]
        y.extend(self.m(y[-1]) for _ in range(3))
        return self.cv2(torch.cat(y, 1))


class Attention(nn.Module):
    """Multi-head attention over H*W tokens with a depthwise positional
    encoding (as used inside C2PSA)."""

    def __init__(self, dim, num_heads=8, attn_ratio=0.5):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        self.key_dim = int(self.head_dim * attn_ratio)
        self.scale = self.key_dim**-0.5
        h = dim + self.key_dim * num_heads * 2
        self.qkv = Conv(dim, h, 1, act=False)
        self.proj = Conv(dim, dim, 1, act=False)
        self.pe = Conv(dim, dim, 3, 1, g=dim, act=False)

    def forward(self, x):
        B, C, H, W = x.shape
        N = H * W
        qkv = self.qkv(x).reshape(
            B, self.num_heads, self.key_dim * 2 + self.head_dim, N
        )
        q, k, v = qkv.split([self.key_dim, self.key_dim, self.head_dim], dim=2)
        attn = (q.transpose(-2, -1) @ k) * self.scale
        attn = attn.float().softmax(dim=-1).to(v.dtype)
        out = (v @ attn.transpose(-2, -1)).reshape(B, C, H, W)
        return self.proj(out + self.pe(v.reshape(B, C, H, W)))


class PSABlock(nn.Module):
    def __init__(self, c, attn_ratio=0.5, num_heads=4, shortcut=True):
        super().__init__()
        self.attn = Attention(c, num_heads=num_heads, attn_ratio=attn_ratio)
        self.ffn = nn.Sequential(Conv(c, c * 2, 1), Conv(c * 2, c, 1, act=False))
        self.add = shortcut

    def forward(self, x):
        x = x + self.attn(x) if self.add else self.attn(x)
        return x + self.ffn(x) if self.add else self.ffn(x)


class C2PSA(nn.Module):
    def __init__(self, c1, c2, n=1, e=0.5):
        super().__init__()
        self.c = int(c1 * e)
        self.cv1 = Conv(c1, 2 * self.c, 1, 1)
        self.cv2 = Conv(2 * self.c, c1, 1)
        self.m = nn.Sequential(
            *(PSABlock(self.c, attn_ratio=0.5, num_heads=max(self.c // 64, 1))
              for _ in range(n))
        )

    def forward(self, x):
        a, b = self.cv1(x).split((self.c, self.c), dim=1)
        return self.cv2(torch.cat((a, self.m(b)), 1))


class Proto(nn.Module):
    """Prototype-mask head: conv -> 2x deconv -> conv -> 1x1 to nm masks."""

    def __init__(self, c1, c_=256, c2=32):
        super().__init__()
        self.cv1 = Conv(c1, c_, k=3)
        self.upsample = CastConvTranspose2d(c_, c_, 2, 2, 0, bias=True)
        self.cv2 = Conv(c_, c_, k=3)
        self.cv3 = Conv(c_, c2)

    def forward(self, x):
        return self.cv3(self.cv2(self.upsample(self.cv1(x))))


class Concat(nn.Module):
    def forward(self, xs):
        return torch.cat(xs, 1)


def upsample2x():
    """Exact 2x nearest-neighbour upsample (a repeat, not a resize)."""
    return nn.Upsample(scale_factor=2, mode="nearest")
