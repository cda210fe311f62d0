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
160x160), tests each pixel against a detection's box before the 32-term
dot product, and stops at the image's highest kept slot.
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


def mask_union_logits_ref(proto, mcoef, boxes_lb, keep, proto_stride: int = 4):
    """Plain version: union of cropped per-instance mask logits.

    proto [N, mh, mw, nm]; mcoef [N, K, nm]; boxes_lb [N, K, 4] letterbox
    px; keep [N, K] bool -> [N, mh, mw] f32. Images go in chunks so the
    per-detection logits stay under ``_REF_CHUNK_ELEMS`` elements."""
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
        outs.append(torch.where(ok, logits, _NEG).amax(dim=1))
    return torch.cat(outs, 0)


def _lib():
    lib = _build.load("mask_union")
    fn = lib.mask_union_logits
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, i, p, p, p, p, p, i, i, i, i, i, ctypes.c_float, p]
        fn.restype = ctypes.c_int
    return fn


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

    coef = mcoef.to(torch.float32).contiguous()  # bf16 -> f32 is exact
    boxes = boxes_lb.to(torch.float32).contiguous()
    keep = keep.contiguous()
    # live-slot bound per image: highest kept slot + 1, on the device
    slot = torch.arange(1, k + 1, dtype=torch.int32, device=proto.device)
    n_active = (keep.to(torch.int32) * slot).amax(dim=1).to(torch.int32)
    out = torch.empty((n, mh, mw), dtype=torch.float32, device=proto.device)
    fn = _lib()
    with torch.cuda.device(proto.device):
        err = fn(
            proto.data_ptr(), int(proto.dtype == torch.bfloat16),
            coef.data_ptr(), boxes.data_ptr(), keep.data_ptr(),
            n_active.data_ptr(), out.data_ptr(),
            n, mh * mw, mw, k, nm, float(proto_stride),
            torch.cuda.current_stream(proto.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"mask union kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    return out
