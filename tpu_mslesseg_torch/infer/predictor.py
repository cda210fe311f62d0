"""Batched slice predictor for one plane.

Port of ``tpu_mslesseg/infer/predictor.py``:

    volume-space uint8 slices [N,H,W]
      -> PNG-space orient -> letterbox -> /255
      -> YOLO11-seg forward on grayscale input (stem folded over in_ch;
         with TPU_MSLESSEG_PALLAS_STEM=1 on a CUDA device, b0+b1 run as
         the fused stem kernel)
      -> DFL decode + padded NMS (conf .25, iou .7, max_det 300)
      -> proto-mask union at proto resolution
      -> bilinear sample of the union logits at the inverse-letterbox
         source-pixel grid -> threshold -> volume-space masks [N,H,W]
"""

from __future__ import annotations

import torch

from tpu_mslesseg_torch.core import geometry
from tpu_mslesseg_torch.infer import decode as dec
from tpu_mslesseg_torch.infer.mask_union import mask_union_logits_batch
from tpu_mslesseg_torch.infer.nms import nms_batch
from tpu_mslesseg_torch.model import stem
from tpu_mslesseg_torch.model.yolo11 import fold_gray_stem

PROTO_STRIDE = 4


def _bilinear_sample(img, ys, xs):
    """Sample img [..., H, W] at the outer product of ys [h], xs [w]
    (bilinear; indices clamped to the edge, as the reference does)."""
    H, W = img.shape[-2:]
    y0 = torch.floor(ys)
    x0 = torch.floor(xs)
    wy = (ys - y0)[:, None]
    wx = (xs - x0)[None, :]
    y0i = y0.to(torch.long).clamp(0, H - 1)
    y1i = (y0i + 1).clamp(0, H - 1)
    x0i = x0.to(torch.long).clamp(0, W - 1)
    x1i = (x0i + 1).clamp(0, W - 1)
    r0 = img[..., y0i, :]
    r1 = img[..., y1i, :]
    return (
        r0[..., x0i] * (1 - wy) * (1 - wx)
        + r0[..., x1i] * (1 - wy) * wx
        + r1[..., x0i] * wy * (1 - wx)
        + r1[..., x1i] * wy * wx
    )


def proto_grid(lb: dec.Letterbox, device=None):
    """Proto-pixel coordinates of the source-pixel centers (half-pixel
    mapping from letterbox px at the proto stride)."""
    ys, xs = lb.src_centers_in_letterbox(device)
    return (
        (ys + 0.5) / PROTO_STRIDE - 0.5,
        (xs + 0.5) / PROTO_STRIDE - 0.5,
    )


def detect_and_union(model, variables, x, imgsz, conf, iou, max_det,
                     mask_union=mask_union_logits_batch, stem_w=None):
    """Forward on grayscale NHWC [M, S, S, 1], decode, NMS and the mask
    union: -> union logits [M, mh, mw] f32. With `stem_w` (from
    ``stem.maybe_build``), b0+b1 run as the fused stem."""
    if stem_w is not None:
        p2 = stem.stem_apply(model, stem_w, x[..., 0])
        out = torch.func.functional_call(model, variables, (p2,), {"from_p2": True})
    else:
        out = torch.func.functional_call(model, variables, (x,))
    reg_max = model.cfg.reg_max
    box_d, cls_l, mcoef = dec.flatten_level_outputs(out, reg_max)
    anchors, strides = dec.make_anchors(imgsz, imgsz, device=x.device)
    boxes = dec.decode_boxes(box_d, anchors, strides, reg_max)
    scores = torch.sigmoid(cls_l.to(torch.float32))[..., 0]  # single class
    nb, _, keep, kidx = nms_batch(boxes, scores, conf, iou, max_det)
    kept_coef = torch.gather(
        mcoef, 1, kidx[..., None].expand(-1, -1, mcoef.shape[-1])
    )
    return mask_union(out["proto"].contiguous(), kept_coef, nb, keep, PROTO_STRIDE)


def prepare_variables(model, variables, device) -> dict:
    """A state_dict for serving: the stem folded for grayscale input, every
    tensor on `device`. Raises unless its keys are the model's."""
    missing = set(model.state_dict()) - set(variables)
    extra = set(variables) - set(model.state_dict())
    if missing or extra:
        raise ValueError(
            f"variables do not match the model: missing {sorted(missing)}, "
            f"extra {sorted(extra)}"
        )
    folded = fold_gray_stem(dict(variables))
    return {k: torch.as_tensor(v).to(device) for k, v in folded.items()}


class SlicePredictor:
    """Runs the prediction path for one slice shape.

    Usage:
        pred = SlicePredictor(model, variables, slice_hw=(182, 218),
                              device="cuda")
        masks = pred(slices_u8)   # [N,182,218] bool, volume space
    """

    def __init__(self, model, variables, slice_hw, imgsz: int = 640,
                 conf: float = 0.25, iou: float = 0.7, max_det: int = 300,
                 mask_thresh: float = 0.0, device="cuda"):
        self.model = model
        self.device = torch.device(device)
        self.variables = prepare_variables(model, variables, self.device)
        self.slice_hw = tuple(slice_hw)
        self.imgsz = imgsz
        self.conf = conf
        self.iou = iou
        self.max_det = max_det
        self.mask_thresh = mask_thresh
        h, w = self.slice_hw
        # PNG-space (model) dims are transposed volume-slice dims
        self.lb = dec.Letterbox(src_h=w, src_w=h, size=imgsz)
        # opt-in fused stem (TPU_MSLESSEG_PALLAS_STEM=1, CUDA only)
        self._stem_w = stem.maybe_build(self.variables, self.device, imgsz)

    @torch.inference_mode()
    def __call__(self, slices_u8):
        slices_u8 = torch.as_tensor(slices_u8, device=self.device)
        if tuple(slices_u8.shape[1:]) != self.slice_hw:
            raise ValueError(f"slices {tuple(slices_u8.shape)} vs {self.slice_hw}")
        png = geometry.to_png_space_batch(slices_u8).to(torch.float32) / 255.0
        x = self.lb.apply(png).to(self.model.dtype)[..., None]
        union = detect_and_union(
            self.model, self.variables, x, self.imgsz, self.conf, self.iou,
            self.max_det, stem_w=self._stem_w,
        )
        ys, xs = proto_grid(self.lb, self.device)
        png_masks = _bilinear_sample(union, ys, xs) > self.mask_thresh
        return geometry.from_png_space_batch(png_masks)
