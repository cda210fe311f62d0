"""YOLO11-seg training losses: CIoU box + DFL + BCE cls + proto-mask BCE.

Port of ``tpu_mslesseg/train/losses.py`` (gains box 7.5 / cls 0.5 / dfl
1.5):

* TAL assignment in input-pixel space, on detached predictions;
* box CIoU + DFL on foreground anchors, weighted by the soft target scores
  and normalised by their sum;
* class BCE over all anchors against the assigner's soft scores;
* mask loss: for every foreground anchor (at most ``M * 10``, taken in
  chunks of ``max_fg`` to bound memory, not to cap the count), the BCE
  between ``coeffs @ proto`` and the instance's ground-truth mask at proto
  resolution, cropped to the target box and divided by its area.

Ground-truth masks arrive as one labelled instance map an image
([B, mh, mw] uint8 of instance ids, 0 the background), so an anchor's
mask is ``instmap == assigned_gt + 1``.

All loss math runs in float32 whatever the model's compute dtype. The
reference's one-hot bin selection in the DFL is a gather here.

With a data axis over one batch split across ranks (``axis``, a
``core.mesh.DataAxis``), the normalisers are the whole batch's (the target
scores' sum and the foreground count, summed over the axis) and so is the
batch size the total is scaled by: each rank's total is its share of the
whole batch's loss, whose gradients the ranks then sum, and the returned
parts are summed over the axis into the whole batch's.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from tpu_mslesseg_torch.infer import decode as dec
from tpu_mslesseg_torch.train import assigner


LOSS_PARTS = ("box", "seg", "cls", "dfl")  # the gain-scaled parts a loss returns


class LossConfig(NamedTuple):
    box_gain: float = 7.5
    cls_gain: float = 0.5
    dfl_gain: float = 1.5
    reg_max: int = 16
    nc: int = 1
    max_fg: int = 64  # chunk size of the mask loss (a memory bound, not a cap)
    imgsz: int = 640


def df_loss(pred_dist, target, reg_max: int = 16):
    """Distribution focal loss: cross-entropy against the two integer bins
    that bracket the continuous ltrb target. pred_dist [..., 4, reg_max],
    target [..., 4] -> [...] (the mean over the four sides)."""
    tl = target.floor().long()
    tr = tl + 1
    wl = tr.to(torch.float32) - target
    wr = 1.0 - wl
    logp = F.log_softmax(
        pred_dist.to(torch.promote_types(pred_dist.dtype, torch.float32)), dim=-1
    )
    pick = lambda idx: logp.gather(-1, idx[..., None]).squeeze(-1)
    ce_l = -pick(tl)
    ce_r = -pick(tr.clamp(0, reg_max - 1))
    return (ce_l * wl + ce_r * wr).mean(dim=-1)


def sigmoid_bce(logits, labels):
    """Numerically stable BCE with logits, elementwise."""
    return logits.clamp(min=0) - logits * labels + torch.log1p(torch.exp(-logits.abs()))


def bce_logits(logits, targets):
    return sigmoid_bce(logits.to(torch.float32), targets.to(torch.float32))


def _chunk_seg_loss(coef_c, gt_c, box_c, valid_c, proto_f32, gt_instmap, scale: float):
    """Mask loss of one chunk of selected anchors ([B, chunk, ...]), summed:
    straight masked math, so an all-padding chunk gives exactly 0."""
    mh, mw = proto_f32.shape[1], proto_f32.shape[2]
    rows = torch.arange(mh, dtype=torch.float32, device=proto_f32.device)[None, None, :, None]
    cols = torch.arange(mw, dtype=torch.float32, device=proto_f32.device)[None, None, None, :]
    pred = torch.einsum("bkc,bhwc->bkhw", coef_c.to(torch.float32), proto_f32)
    ids = (gt_c + 1).to(torch.int32)
    gt_masks = (gt_instmap[:, None, :, :].to(torch.int32) == ids[:, :, None, None]).to(
        torch.float32
    )
    bx = box_c * scale  # the target box at proto resolution
    in_box = (
        (cols >= bx[..., 0][..., None, None])
        & (cols < bx[..., 2][..., None, None])
        & (rows >= bx[..., 1][..., None, None])
        & (rows < bx[..., 3][..., None, None])
    ).to(torch.float32)
    bce = sigmoid_bce(pred, gt_masks) * in_box
    # the cropped BCE's sum over the box's area in proto pixels, unclamped;
    # padded slots get an area of 1 so that the masked division is finite
    area = (bx[..., 2] - bx[..., 0]) * (bx[..., 3] - bx[..., 1])
    area = torch.where(valid_c, area, 1.0)
    return (bce.sum(dim=(2, 3)) / area * valid_c).sum()


def segmentation_loss(
    outputs,  # model output dict (box/cls/mcoef lists + proto)
    gt_boxes,  # [B, M, 4] xyxy in input pixels (zero rows for padding)
    gt_labels,  # [B, M] int
    gt_valid,  # [B, M] bool
    gt_instmap,  # [B, mh, mw] uint8 instance-id map (0 = background)
    cfg: LossConfig = LossConfig(),
    axis=None,  # a core.mesh.DataAxis the batch is split over, or None
):
    """Returns (total, parts). The parts are gain-scaled and carry no
    gradient history of their own use; the total is their sum times the
    batch size, the value to back-propagate."""
    reg_max = cfg.reg_max
    box_d, cls_l, mcoef = dec.flatten_level_outputs(outputs, reg_max)
    B, A, _ = box_d.shape
    proto = outputs["proto"]  # [B, mh, mw, nm]
    mw = proto.shape[2]

    anchors, strides = dec.make_anchors(cfg.imgsz, cfg.imgsz, device=box_d.device)
    ltrb = dec.dfl_expectation(box_d, reg_max)  # grid units
    pd_boxes_grid = dec.dist2bbox(ltrb, anchors[None])
    pd_boxes_px = pd_boxes_grid * strides[None]
    pd_scores = torch.sigmoid(cls_l.to(torch.float32))

    tgt = assigner.assign(
        pd_scores.detach(), pd_boxes_px.detach(), anchors * strides,
        gt_labels, gt_boxes, gt_valid, topk=10, num_classes=cfg.nc,
    )
    fg = tgt["fg_mask"]
    t_scores = tgt["target_scores"]
    t_boxes_px = tgt["target_bboxes"]
    t_sum, fg_count = t_scores.sum(), fg.sum()
    if axis is not None:
        t_sum, fg_count = (axis.all_reduce(torch.stack([t_sum, fg_count.to(t_sum.dtype)]))
                           .unbind(0))
    t_sum = t_sum.clamp(min=1.0)

    # class BCE over all anchors
    loss_cls = bce_logits(cls_l, t_scores).sum() / t_sum

    # box CIoU + DFL on foreground anchors
    weight = t_scores.sum(-1) * fg  # [B, A]
    t_boxes_grid = t_boxes_px / strides[None]
    ciou = assigner.bbox_iou_ciou(pd_boxes_grid, t_boxes_grid)
    loss_box = ((1.0 - ciou) * weight).sum() / t_sum

    t_ltrb = torch.cat(
        [anchors[None] - t_boxes_grid[..., :2], t_boxes_grid[..., 2:] - anchors[None]], dim=-1
    ).clamp(0, reg_max - 1 - 0.01)
    dfl = df_loss(box_d.reshape(B, A, 4, reg_max), t_ltrb, reg_max)
    loss_dfl = (dfl * weight).sum() / t_sum

    # mask loss over all foreground anchors, in chunks. TAL assigns at most
    # topk (10) anchors a GT, so M * 10 bounds the foreground count, and
    # ranking by fg_score puts every foreground anchor ahead of the padding
    M = gt_valid.shape[1]
    k = min(M * 10, A)
    chunk = min(cfg.max_fg, k)
    n_chunks = -(-k // chunk)
    fg_score = fg.to(torch.float32) * (1.0 + t_scores.sum(-1))
    fg_idx = assigner.topk_indices_desc(fg_score, k)  # [B, k]
    sel = {
        "valid": fg.gather(1, fg_idx),  # [B, k]
        "coef": mcoef.gather(1, fg_idx[..., None].expand(B, k, mcoef.shape[-1])),
        "gt": tgt["target_gt_idx"].gather(1, fg_idx),
        "box": t_boxes_px.gather(1, fg_idx[..., None].expand(B, k, 4)),
    }
    pad = n_chunks * chunk - k  # padded slots are invalid: zero loss
    if pad:
        sel = {n: F.pad(v, (0, 0) * (v.ndim - 2) + (0, pad)) for n, v in sel.items()}

    scale = mw / cfg.imgsz
    proto_f32 = proto.to(torch.float32)
    # each chunk is recomputed in the backward instead of keeping its
    # [B, chunk, mh, mw] float32 intermediates
    loss_seg = sum(
        checkpoint(
            _chunk_seg_loss,
            *(sel[n][:, i * chunk:(i + 1) * chunk] for n in ("coef", "gt", "box", "valid")),
            proto_f32, gt_instmap, scale, use_reentrant=False,
        )
        for i in range(n_chunks)
    ) / fg_count.clamp(min=1.0)

    parts = {
        "box": cfg.box_gain * loss_box,
        "seg": cfg.box_gain * loss_seg,
        "cls": cfg.cls_gain * loss_cls,
        "dfl": cfg.dfl_gain * loss_dfl,
    }
    total = (parts["box"] + parts["seg"] + parts["cls"] + parts["dfl"]) * (
        B * (axis.size if axis is not None else 1))
    out = {n: v.detach() for n, v in parts.items()}
    if axis is not None:
        out = dict(zip(out, axis.all_reduce(torch.stack(list(out.values()))).unbind(0)))
    return total, {**out, "fg_count": fg_count}
