"""Proto-mask union: plain PyTorch version and the CUDA kernel's wrapper.

The union of instance masks (Ultralytics ``process_mask`` semantics:
``coef @ proto`` cropped to each detection's box, kept in logit space and
max-reduced over the kept detections) at proto resolution.
``mask_union_logits_ref`` is the plain version (einsum + crop + max, as in
``tpu_mslesseg/infer/mask_union_pallas.py::mask_union_logits_ref``);
``mask_union_logits_batch`` runs ``csrc/mask_union.cu`` on a CUDA tensor,
which replaces the reference's Pallas ``_union_kernel``.

The kernel's source note says what bounds it on the H100 and what its
design does about that. In short: it never materialises the
``[N, K, mh, mw]`` per-detection logits (18 GB in f32 at N=600, K=300,
160x160), stages per pixel tile only the kept detections whose box meets
the tile, and stops at the image's highest kept slot. With bf16 proto and
bf16 coefficients (the bf16 model's serving path) the dot products run on
the tensor cores; with f32 coefficients on the FMA pipe.
"""

from __future__ import annotations

import ctypes

import torch

from tpu_mslesseg_torch import _build

_NEG = -1e4  # large-negative instead of -inf: survives bilinear sampling
# bound on the [n, K, mh, mw] f32 logits the plain version holds at once
_REF_CHUNK_ELEMS = 1 << 28

# kernel launches by `mask_union_logits_batch` in this process
LAUNCHES = 0


def _cropped_max(proto, mcoef, boxes_lb, keep, proto_stride, fill):
    """max over the kept detections whose box holds each pixel of
    ``mcoef . proto`` (in f32), `fill` where none does: [N, mh, mw]. Images
    go in chunks so the per-detection values stay under
    ``_REF_CHUNK_ELEMS`` elements."""
    n, mh, mw, _ = proto.shape
    k = mcoef.shape[1]
    dev = proto.device
    rows = torch.arange(mh, dtype=torch.float32, device=dev)[None, None, :, None]
    cols = torch.arange(mw, dtype=torch.float32, device=dev)[None, None, None, :]
    step = max(1, _REF_CHUNK_ELEMS // max(1, k * mh * mw))
    outs = []
    for s in range(0, n, step):
        logits = torch.einsum(
            "nkc,nhwc->nkhw",
            mcoef[s : s + step].to(torch.float32),
            proto[s : s + step].to(torch.float32),
        )
        b = boxes_lb[s : s + step].to(torch.float32) / proto_stride
        x1, y1, x2, y2 = (b[..., i, None, None] for i in range(4))
        inside = (cols >= x1) & (cols < x2) & (rows >= y1) & (rows < y2)
        ok = inside & keep[s : s + step, :, None, None]
        outs.append(torch.where(ok, logits, fill).amax(dim=1))
    return torch.cat(outs, 0)


def mask_union_logits_ref(proto, mcoef, boxes_lb, keep, proto_stride: int = 4):
    """Plain version: union of cropped per-instance mask logits.

    proto [N, mh, mw, nm]; mcoef [N, K, nm]; boxes_lb [N, K, 4] letterbox
    px; keep [N, K] bool -> [N, mh, mw] f32."""
    return _cropped_max(proto, mcoef, boxes_lb, keep, proto_stride, _NEG)


def union_error_bound(proto, mcoef, boxes_lb, keep, proto_stride: int = 4):
    """Per-pixel bound on |kernel - plain| for the union: the max, over the
    kept detections whose box holds the pixel, of 2 * 32 * 2**-24 *
    sum_i |c_i| |p_i|; 0 where no kept box holds the pixel (both give
    exactly -1e4 there). For bf16 proto and coefficients, the tensor-core
    path, each of the 32 products is exact in f32, so an f32 sum of them
    rounded to nearest is within 32 * 2**-24 * sum_i |c_i p_i| of the exact
    dot product whatever its order, so two such sums are within twice that.
    And |max a - max b| <= max |a - b|. The tensor cores do not document
    how they round their f32 sums; the card's checks hold them to this
    bound."""
    return _cropped_max(
        proto.to(torch.float32).abs(), mcoef.to(torch.float32).abs(), boxes_lb, keep,
        proto_stride, 0.0,
    ) * (2 * 32 * 2.0**-24)


def _lib():
    lib = _build.load("mask_union")
    fn = lib.mask_union_logits
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, i, p, i, p, p, p, p, i, i, i, i, i, ctypes.c_float, p]
        fn.restype = ctypes.c_int
    return fn


def kernel_inputs(proto, mcoef, boxes_lb, keep):
    """What the kernel takes, on any device: (route, coef, boxes, keep,
    n_active). route "mma" (the tensor-core kernel) for bf16 proto and bf16
    coefficients, with coef kept in bf16; else "fma", with coef in f32
    (bf16 -> f32 is exact). boxes are f32; n_active [N] int32 is each
    image's highest kept slot + 1 (0 with none kept), computed without
    leaving the device."""
    mma = proto.dtype == torch.bfloat16 and mcoef.dtype == torch.bfloat16
    coef = (mcoef if mma else mcoef.to(torch.float32)).contiguous()
    boxes = boxes_lb.to(torch.float32).contiguous()
    keep = keep.contiguous()
    k = keep.shape[1]
    slot = torch.arange(1, k + 1, dtype=torch.int32, device=keep.device)
    n_active = (keep.to(torch.int32) * slot).amax(dim=1).to(torch.int32)
    return ("mma" if mma else "fma"), coef, boxes, keep, n_active


def mask_union_logits_batch(proto, mcoef, boxes_lb, keep, proto_stride: int = 4):
    """Batched union of cropped instance-mask logits.

    proto [N, mh, mw, 32] bf16 or f32, contiguous; mcoef [N, K, 32];
    boxes_lb [N, K, 4]; keep [N, K] bool -> [N, mh, mw] f32. A CPU tensor
    goes to the plain version; a CUDA tensor to the kernel, or this
    raises."""
    global LAUNCHES
    if proto.device.type == "cpu":
        return mask_union_logits_ref(proto, mcoef, boxes_lb, keep, proto_stride)
    if proto.device.type != "cuda":
        raise ValueError(f"mask union: no kernel for device {proto.device}")
    if proto.ndim != 4:
        raise ValueError(f"mask union: proto must be [N, mh, mw, nm], got {tuple(proto.shape)}")
    n, mh, mw, nm = proto.shape
    k = mcoef.shape[1] if mcoef.ndim == 3 else -1
    if nm != 32 or tuple(mcoef.shape) != (n, k, nm) or k < 1:
        raise ValueError(
            f"mask union: need proto [N,mh,mw,32] and mcoef [N,K,32], got "
            f"{tuple(proto.shape)} and {tuple(mcoef.shape)}"
        )
    if tuple(boxes_lb.shape) != (n, k, 4) or tuple(keep.shape) != (n, k):
        raise ValueError(
            f"mask union: need boxes [N,K,4] and keep [N,K], got "
            f"{tuple(boxes_lb.shape)} and {tuple(keep.shape)}"
        )
    for name, t in (("mcoef", mcoef), ("boxes_lb", boxes_lb), ("keep", keep)):
        if t.device != proto.device:
            raise ValueError(f"mask union: {name} on {t.device}, proto on {proto.device}")
    if proto.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"mask union: proto must be bf16 or f32, got {proto.dtype}")
    if not (mcoef.is_floating_point() and boxes_lb.is_floating_point()):
        raise TypeError("mask union: mcoef and boxes_lb must be floating point")
    if keep.dtype != torch.bool:
        raise TypeError(f"mask union: keep must be bool, got {keep.dtype}")
    if not proto.is_contiguous() or proto.data_ptr() % 16:
        raise ValueError("mask union: proto must be contiguous and 16-byte aligned")
    if n > 65535:
        raise ValueError(f"mask union: at most 65535 images per launch, got {n}")

    route, coef, boxes, keep, n_active = kernel_inputs(proto, mcoef, boxes_lb, keep)
    # the kernel reads coefficients and boxes 16 bytes at a time; a fresh
    # allocation is aligned
    coef, boxes = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (coef, boxes))
    out = torch.empty((n, mh, mw), dtype=torch.float32, device=proto.device)
    fn = _lib()
    with torch.cuda.device(proto.device):
        err = fn(
            proto.data_ptr(), int(proto.dtype == torch.bfloat16),
            coef.data_ptr(), int(route == "mma"), boxes.data_ptr(), keep.data_ptr(),
            n_active.data_ptr(), out.data_ptr(),
            n, mh, mw, k, nm, float(proto_stride),
            torch.cuda.current_stream(proto.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"mask union kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    return out
