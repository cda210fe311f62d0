"""The eval epilogue of a ``Conv`` block: BatchNorm with the running
statistics, then SiLU, in float32, cast back to the activation's type.

``bn_act_ref`` is the plain version, the four PyTorch passes the block ran
(``y.float()``, ``F.batch_norm``, ``F.silu``, ``.to(y.dtype)``). ``bn_act``
runs ``csrc/bn_act.cu`` on a CUDA tensor: one pass that reads the conv
output once and writes the result once (in place in the model), with the
plain version's float32 arithmetic, rounding for rounding. That arithmetic
depends on the kernel PyTorch picks for the batch norm: cuDNN's for a
channels-last input (``_cudnn_batch_norm`` says when), ATen's own
otherwise; the wrapper tells the kernel which. It replaces no TPU kernel: the JAX package leaves BN and
SiLU to XLA, which fuses them; in the port they were four passes through
device memory, 28 bytes an element in bf16 against the kernel's 4.

The kernel reads the BN module's four vectors on every launch and keeps
nothing: the EMA, the weight bridge and training update them in place.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from tpu_mslesseg_torch import _build

# kernel launches by `bn_act` in this process
LAUNCHES = 0
MAX_CHANNELS = 2048  # the kernel's shared-memory table of per-channel terms

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_fn_cache = []


def bn_act_ref(y, bn, act: bool):
    """Plain version: ``act(BN(y))`` of a conv output `y` [N, C, H, W] with
    ``bn``'s running statistics, in float32, cast back to ``y.dtype``."""
    z = F.batch_norm(
        y.float(), bn.running_mean, bn.running_var, bn.weight, bn.bias, False, 0.0, bn.eps,
    )
    if act:
        z = F.silu(z)
    return z.to(y.dtype)


def _fn():
    if not _fn_cache:
        fn = _build.load("bn_act").bn_act
        fn.argtypes = [_P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _F, _I, _L, _L, _P]
        fn.restype = ctypes.c_int
        _fn_cache.append(fn)
    return _fn_cache[0]


def layout(y) -> str | None:
    """"nchw" or "channels_last" where the kernel takes `y`'s strides, else
    None. Strides that fit both (one channel, or a 1x1 map) read as NCHW:
    there the plain version's batch norm computes as on an NCHW input."""
    if y.is_contiguous():
        return "nchw"
    if y.is_contiguous(memory_format=torch.channels_last):
        return "channels_last"
    return None


def _cudnn_batch_norm(y, kind: str, eps: float) -> bool:
    """Whether the plain version's batch norm of `y` (once float32) runs
    cuDNN's NHWC kernel, whose arithmetic differs from ATen's: PyTorch takes
    cuDNN for a channels-last float32 input in eval when it is on, for at
    most 65535 images, fewer than 2^31 - 1 elements and eps of at least
    1e-5."""
    return (kind == "channels_last" and torch.backends.cudnn.enabled
            and torch.backends.cudnn.is_available() and y.shape[0] <= 65535
            and y.numel() < 2**31 - 1 and eps >= 1e-5)


def bn_act(y, bn, act: bool, out=None):
    """``act(BN(y))`` of a conv output `y` [N, C, H, W] (bf16 or f32,
    channels-last or NCHW-contiguous) with ``bn``'s running statistics.
    A CPU (or meta) tensor goes to the plain version, its result copied
    into `out` where one is given. A CUDA tensor goes to the kernel, which
    writes into `out` (a tensor like `y`: same shape, type and strides) and
    returns it, or overwrites `y` without one; else this raises."""
    global LAUNCHES
    if y.device.type in ("cpu", "meta"):  # meta: shapes only, as an operation count runs it
        z = bn_act_ref(y, bn, act)
        return z if out is None else out.copy_(z)
    if y.device.type != "cuda":
        raise ValueError(f"bn_act: no kernel for device {y.device}")
    if y.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"bn_act: y must be bf16 or f32, got {y.dtype}")
    if y.ndim != 4:
        raise ValueError(f"bn_act: y must be [N, C, H, W], got {tuple(y.shape)}")
    kind = layout(y)
    if kind is None:
        raise ValueError(f"bn_act: y must be channels-last or NCHW-contiguous, got strides "
                         f"{y.stride()}")
    n, c, h, w = y.shape
    if not 0 < c <= MAX_CHANNELS:
        raise ValueError(f"bn_act: 1 to {MAX_CHANNELS} channels, got {c}")
    terms = (bn.running_mean, bn.running_var, bn.weight, bn.bias)
    for t in terms:
        if (t.device != y.device or t.dtype != torch.float32 or not t.is_contiguous()
                or tuple(t.shape) != (c,)):
            raise ValueError(f"bn_act: BN terms must be contiguous f32 [{c}] on {y.device}")
    if out is None:
        out = y
    elif (out.device != y.device or out.dtype != y.dtype or out.shape != y.shape
          or out.stride() != y.stride() or (out.data_ptr() - y.data_ptr()) % 16):
        raise ValueError("bn_act: out must be like y: device, type, shape, strides and "
                         "alignment modulo 16 bytes")
    if y.numel() == 0:
        return out
    with torch.cuda.device(y.device):
        err = _fn()(
            y.data_ptr(), out.data_ptr(), int(y.dtype == torch.bfloat16),
            int(kind == "channels_last"), int(_cudnn_batch_norm(y, kind, bn.eps)),
            int(bool(act)), *(t.data_ptr() for t in terms), float(bn.eps), c, h * w,
            y.numel(), torch.cuda.current_stream(y.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"bn_act kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    return out
