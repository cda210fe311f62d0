"""Padded fixed-shape NMS over a batch of images.

Port of ``tpu_mslesseg/infer/nms.py``: take the top `max_det` candidates by
score and return a validity mask instead of a ragged result. Suppression
keeps ``keep_i = valid_i and no higher-scored kept j overlaps i`` (IoU >
iou_thres): the exact greedy result.

Ties: the reference's ``lax.top_k`` puts the lower index first among equal
scores, and sigmoids of bf16 logits tie often; ``torch.topk`` promises no
order, so candidates come from a stable descending sort.

The suppression goes through ``suppress``. On a CPU tensor it runs the plain
version, ``suppress_ref``: the reference's fixpoint, iterated from keep =
valid as one batched ``S @ keep`` per step until no image changes, with one
bool read back to the host a step. On a CUDA tensor it launches
``csrc/nms.cu``, which computes the same keep on the card in one kernel (the
greedy scan over the same IoU bits, rounded as ``box_iou_matrix`` rounds
them) and reads nothing back: the counterpart of the reference's
``lax.while_loop``, which keeps its loop on the device.
"""

from __future__ import annotations

import ctypes

import torch

from tpu_mslesseg_torch import _build

# kernel launches by `suppress` in this process
LAUNCHES = 0
MAX_K = 1024  # candidates an image: the kernel's bits live in shared memory

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_fn_cache = []


def box_iou_matrix(boxes):
    """[..., K, 4] xyxy -> [..., K, K] pairwise IoU."""
    area = (boxes[..., 2] - boxes[..., 0]).clamp(min=0) * (
        boxes[..., 3] - boxes[..., 1]
    ).clamp(min=0)
    lt = torch.maximum(boxes[..., :, None, :2], boxes[..., None, :, :2])
    rb = torch.minimum(boxes[..., :, None, 2:], boxes[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = area[..., :, None] + area[..., None, :] - inter
    return inter / union.clamp(min=1e-7)


def suppress_ref_steps(top_boxes, valid, iou_thres: float):
    """Plain version of ``suppress``, and the fixpoint steps it took (the
    last one finding no change): -> (keep [B, K] bool, steps)."""
    k = valid.shape[-1]
    tri = torch.ones((k, k), dtype=torch.bool, device=valid.device).tril(-1)
    # S[n, i, j] = 1 when the higher-scored candidate j can suppress i
    s = ((box_iou_matrix(top_boxes) > iou_thres) & tri).to(torch.float32)
    keep = valid
    for step in range(1, k + 1):
        suppressed = (s @ keep.to(torch.float32)[..., None])[..., 0] > 0.0
        new = valid & ~suppressed
        if torch.equal(new, keep):
            return keep, step
        keep = new
    return keep, k


def suppress_ref(top_boxes, valid, iou_thres: float):
    """Plain version: the greedy keep mask [B, K] of candidates `top_boxes`
    [B, K, 4] (each image's in descending score order) where `valid` [B, K]:
    the fixpoint of ``keep_i = valid_i and not any_j<i (IoU(i, j) >
    iou_thres and keep_j)`` from keep = valid."""
    return suppress_ref_steps(top_boxes, valid, iou_thres)[0]


def _fn():
    if not _fn_cache:
        fn = _build.load("nms").nms_suppress
        fn.argtypes = [_P, _P, _P, _I, _I, _F, _P]
        fn.restype = ctypes.c_int
        _fn_cache.append(fn)
    return _fn_cache[0]


def suppress(top_boxes, valid, iou_thres: float):
    """The greedy keep mask [B, K] bool of `top_boxes` [B, K, 4] float32
    xyxy (each image's candidates in descending score order) where `valid`
    [B, K] bool, K at most ``MAX_K``. A CPU tensor goes to the plain version,
    a CUDA tensor to the kernel (no host sync); any other device raises."""
    global LAUNCHES
    if top_boxes.dtype != torch.float32 or valid.dtype != torch.bool:
        raise TypeError(f"suppress: boxes must be float32 and valid bool, got "
                        f"{top_boxes.dtype} and {valid.dtype}")
    if top_boxes.ndim != 3 or top_boxes.shape[-1] != 4 or tuple(valid.shape) != tuple(
            top_boxes.shape[:2]):
        raise ValueError(f"suppress: boxes [B, K, 4] and valid [B, K], got "
                         f"{tuple(top_boxes.shape)} and {tuple(valid.shape)}")
    b, k = valid.shape
    if k > MAX_K:
        raise ValueError(f"suppress: at most {MAX_K} candidates an image, got {k}")
    if valid.device != top_boxes.device:
        raise ValueError(f"suppress: boxes on {top_boxes.device}, valid on {valid.device}")
    if top_boxes.device.type == "cpu":
        return suppress_ref(top_boxes, valid, iou_thres)
    if top_boxes.device.type != "cuda":
        raise ValueError(f"suppress: no kernel for device {top_boxes.device}")
    boxes = top_boxes.detach().contiguous()
    if boxes.data_ptr() % 16:
        boxes = boxes.clone()
    valid = valid.contiguous()
    keep = torch.empty((b, k), dtype=torch.bool, device=boxes.device)
    if keep.numel() == 0:
        return keep
    with torch.cuda.device(boxes.device):
        err = _fn()(boxes.data_ptr(), valid.data_ptr(), keep.data_ptr(), b, k,
                    float(iou_thres), torch.cuda.current_stream(boxes.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"nms kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    return keep


def nms_batch(boxes, scores, conf_thres: float = 0.25, iou_thres: float = 0.7,
              max_det: int = 300):
    """Greedy NMS on each image of a batch.

    boxes [B,A,4] xyxy, scores [B,A] (already sigmoid'd, single class).
    Returns (boxes [B,max_det,4], scores [B,max_det], keep [B,max_det]
    bool, indices [B,max_det] into the A anchors); slots past A are
    zero-padded and not kept.
    """
    b, a = scores.shape
    k = min(max_det, a)
    sorted_scores, order = torch.sort(scores, dim=1, descending=True, stable=True)
    top_scores, top_idx = sorted_scores[:, :k], order[:, :k]
    top_boxes = torch.gather(boxes, 1, top_idx[..., None].expand(b, k, 4))

    valid = top_scores > conf_thres
    keep = suppress(top_boxes, valid, iou_thres)

    if k < max_det:
        pad = max_det - k
        top_boxes = torch.nn.functional.pad(top_boxes, (0, 0, 0, pad))
        top_scores = torch.nn.functional.pad(top_scores, (0, pad))
        keep = torch.nn.functional.pad(keep, (0, pad))
        top_idx = torch.nn.functional.pad(top_idx, (0, pad))
    return top_boxes, top_scores, keep, top_idx
