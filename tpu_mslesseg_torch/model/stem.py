"""Fused YOLO11 stem (``model.0`` + ``model.1``): plain version and the CUDA
kernel's wrapper.

Port of ``tpu_mslesseg/model/stem_pallas.py``. The stem is the first two
stride-2 Conv blocks of the network on grayscale input (after
``fold_gray_stem``): conv 3x3/s2 1->16 + BN + SiLU, cast to the compute
dtype, then conv 3x3/s2 16->32 + BN + SiLU, cast. They run at the widest
activations of the network (at 640: 320x320x16 and 160x160x32 per image).

``stem_reference`` is the plain version, the model's own ``model.0`` and
``model.1`` blocks. ``stem_apply`` runs ``csrc/stem.cu`` on a CUDA tensor,
which replaces the reference's Pallas ``_stem_kernel``: one pass that keeps
the b0 output on chip and writes only the P2 map, NHWC, which is the memory
of the channels-last ``[M, c1, S/4, S/4]`` tensor ``model.2`` takes. In
bf16 the kernel computes ``model.1``'s convolution on the tensor cores; in
f32 on the FMA pipe (the source note says why). The source holds one kernel
instance for each published scale's channel counts (``INSTANCES``), picked
from the two weight shapes, as the reference reads ``c0`` and ``c1`` from
its weights.

As in the reference, the fused stem is opt-in: ``TPU_MSLESSEG_PALLAS_STEM=1``
turns it on (the same variable, default "0"), and ``maybe_build`` is the one
gate the predictors share.
"""

from __future__ import annotations

import ctypes
import os

import torch

from tpu_mslesseg_torch import _build
from tpu_mslesseg_torch.core.device import SinInstanciaDeKernel

ENABLED = os.environ.get("TPU_MSLESSEG_PALLAS_STEM", "0") == "1"

# kernel launches by `stem_apply` in this process
LAUNCHES = 0

BN_EPS = 1e-3
# (c0, c1) of ``model.0`` and ``model.1`` -> the scales the kernel instance serves
INSTANCES = {(16, 32): "n", (32, 64): "s", (64, 128): "m, l", (96, 192): "x"}
_BLOCKS = ("model.0", "model.1")
_LEAVES = ("conv.weight", "bn.weight", "bn.bias", "bn.running_mean", "bn.running_var")


def stem_weights(variables) -> dict:
    """The stem's tensors of a served state_dict (stem folded for grayscale
    input), under the keys the model holds them."""
    return {f"{b}.{leaf}": variables[f"{b}.{leaf}"] for b in _BLOCKS for leaf in _LEAVES}


def instance_of(weights) -> tuple[int, int]:
    """(c0, c1) of the kernel instance that serves the stem `weights` (a
    folded stem: ``[c0,1,3,3]`` and ``[c1,c0,3,3]``); raises
    ``SinInstanciaDeKernel`` (a ``RuntimeError``) when the source holds none
    for these shapes."""
    s0 = tuple(weights["model.0.conv.weight"].shape)
    s1 = tuple(weights["model.1.conv.weight"].shape)
    key = (s0[0], s1[0])
    if key not in INSTANCES or s0 != (key[0], 1, 3, 3) or s1 != (key[1], key[0], 3, 3):
        served = ", ".join(f"{k} (scale {v})" for k, v in INSTANCES.items())
        raise SinInstanciaDeKernel(
            f"fused stem: no kernel instance for stem weights {s0} and {s1} "
            f"(TPU_MSLESSEG_SCALE={os.environ.get('TPU_MSLESSEG_SCALE', 'n')}); csrc/stem.cu "
            f"serves the grayscale-folded (c0, c1) = {served}. Unset "
            f"TPU_MSLESSEG_PALLAS_STEM to serve this model through the plain blocks"
        )
    return key


def maybe_build(variables, device, imgsz: int):
    """The one gate for the opt-in fused stem, shared by the predictors:
    the stem's weights when ``TPU_MSLESSEG_PALLAS_STEM=1``, the device is
    CUDA and ``imgsz % 4 == 0``; else None. `variables` is one served
    state_dict or {plane: state_dict}. Raises ``SinInstanciaDeKernel`` when the
    switch is on and the stem's shapes have no kernel instance, so that a
    predictor fails when it is built and not at its first patient."""
    if not (ENABLED and torch.device(device).type == "cuda" and imgsz % 4 == 0):
        return None
    if "model.0.conv.weight" not in variables:
        built = {p: stem_weights(v) for p, v in variables.items()}
        for w in built.values():
            instance_of(w)
        return built
    built = stem_weights(variables)
    instance_of(built)
    return built


def stem_reference(model, weights, x):
    """Plain version: ``model.0`` then ``model.1`` of `model` with
    `weights`, on grayscale x [M, S, S] -> P2 [M, c1, S/4, S/4] in the
    compute dtype (in the memory format the convolutions return)."""
    seq = torch.nn.Sequential(model.model[0], model.model[1])
    params = {k.removeprefix("model."): v for k, v in weights.items()}
    x = x.to(model.dtype)[:, None].contiguous(memory_format=torch.channels_last)
    return torch.func.functional_call(seq, params, (x,))


def bf16_error_bound(model, weights, x, p2):
    """Per-element bound on |kernel - plain| for the bf16 stem, where `p2`
    is the plain version's output on x: one bf16 ulp of b1's conv sum (of
    at least 1.0), carried through BN (x |scale|) and SiLU (slope at most
    1.1), plus one ulp of the output's own rounding. The kernel and cuDNN
    sum in different orders, so a conv sum may round to bf16 one ulp apart;
    where BN's running mean cancels most of a sum, that ulp is larger than
    the output's."""
    inner = {k.removeprefix("model.0."): v for k, v in weights.items() if k.startswith("model.0.")}
    x = x.to(model.dtype)[:, None].contiguous(memory_format=torch.channels_last)
    p1 = torch.func.functional_call(model.model[0], inner, (x,))
    acc = torch.nn.functional.conv2d(
        p1, weights["model.1.conv.weight"].to(p1.dtype), None, 2, 1
    ).float()
    var = weights["model.1.bn.running_var"]
    scale = (weights["model.1.bn.weight"] / torch.sqrt(var + BN_EPS)).abs()
    ulp = lambda t: torch.exp2(torch.floor(torch.log2(t.abs().clamp(min=1.0))) - 7)
    return 1.1 * scale[None, :, None, None] * ulp(acc) + ulp(p2.float())


def scratch_bytes(c0: int, c1: int, bf16: bool) -> int:
    """Bytes of the scratch where a wider instance lays out its weights
    once a launch: in f32 w1 as [c0, 3, 3, c1]; in bf16 w1 and w0 as the
    kernel's tensor-core fragments, 9 c0 c1 and 16 c0 bf16, then both
    blocks' BN terms, 4 c0 + 4 c1 f32."""
    return 18 * c0 * c1 + 4 * (12 * c0 + 4 * c1) if bf16 else 36 * c0 * c1


def _lib():
    lib = _build.load("stem")
    fn = lib.stem_forward
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, i, p, p, p, p, p, p, p, p, p, p, i, i, p, p, i, i, i,
                       ctypes.c_float, p]
        fn.restype = ctypes.c_int
    return fn


def bf16_activation_mismatches(device) -> int:
    """The f32 inputs, of all 2^32, on which the bf16 wide kernel's
    branch-free SiLU differs, bit for bit, from the plain ``y / (1 +
    expf(-y))``, counted on the CUDA `device`; 0 when it is exact."""
    fn = _build.load("stem").stem_bf16_activation_check
    fn.argtypes, fn.restype = [ctypes.c_void_p, ctypes.c_void_p], ctypes.c_int
    bad = torch.zeros(1, dtype=torch.int64, device=device)
    with torch.cuda.device(bad.device):
        err = fn(bad.data_ptr(), torch.cuda.current_stream(bad.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"stem activation check launch failed: CUDA error {err}")
    return int(bad.item())


def stem_apply(model, weights, x):
    """Fused stem on grayscale x [M, S, S] (compute dtype) -> P2 [M, c1,
    S/4, S/4] channels-last in the compute dtype. A CPU tensor goes to the
    plain version; a CUDA tensor to the kernel instance of the weights'
    (c0, c1), or this raises."""
    global LAUNCHES
    if x.device.type == "cpu":
        return stem_reference(model, weights, x)
    if x.device.type != "cuda":
        raise ValueError(f"stem: no kernel for device {x.device}")
    if x.dtype != model.dtype or x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"stem: input must be the model's bf16 or f32, got {x.dtype}")
    if x.ndim != 3 or x.shape[1] % 4 or x.shape[2] % 4 or x.shape[0] < 1:
        raise ValueError(f"stem: input must be [M, S, S] with S % 4 == 0, got {tuple(x.shape)}")
    m, h, w = x.shape
    if m > 65535:
        raise ValueError(f"stem: at most 65535 images per launch, got {m}")
    c0, c1 = instance_of(weights)
    terms = [weights[f"{b}.{leaf}"] for b in _BLOCKS for leaf in _LEAVES]
    for t in terms:
        if t.device != x.device or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError("stem: weights must be contiguous f32 on the input's device")
    x = x.contiguous()
    if x.data_ptr() % 16:  # the kernel reads bf16 pairs and 16-byte rows
        x = x.clone()
    out = torch.empty((m, h // 4, w // 4, c1), dtype=x.dtype, device=x.device)
    bf16 = x.dtype == torch.bfloat16
    wfrag = (torch.empty(scratch_bytes(c0, c1, bf16), dtype=torch.uint8, device=x.device)
             if (c0, c1) != (16, 32) else None)
    fn = _lib()
    with torch.cuda.device(x.device):
        err = fn(
            x.data_ptr(), int(bf16), *(t.data_ptr() for t in terms), c0, c1,
            None if wfrag is None else wfrag.data_ptr(), out.data_ptr(), m, h, w, BN_EPS,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"stem kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    return out.permute(0, 3, 1, 2)
