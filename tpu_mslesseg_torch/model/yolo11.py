"""YOLO11-seg model family (n/s/m/l/x) as one ``nn.Module``.

Port of ``tpu_mslesseg/model/yolo11.py``. The module tree is ultralytics'
(``model.0`` ... ``model.23``), so state_dict keys are those of a real
``yolo11*-seg.pt``. Public layout is the reference's: the input is NHWC
``[B, H, W, C]`` and every output is NHWC. Inside, the network runs NCHW
tensors in channels-last memory, so the NHWC views it returns are
contiguous.
"""

from __future__ import annotations

import functools
import math
import os
from dataclasses import dataclass, field

import torch
from torch import nn

from tpu_mslesseg_torch.core.device import precision_of
from tpu_mslesseg_torch.model import blocks
from tpu_mslesseg_torch.model.blocks import (
    C2PSA, C3k2, CastConv2d, Concat, Conv, DWConv, Proto, SPPF, upsample2x,
)

# depth multiple, width multiple, max channels — the published YOLO11 scales
SCALES = {
    "n": (0.50, 0.25, 1024),
    "s": (0.50, 0.50, 1024),
    "m": (0.50, 1.00, 512),
    "l": (1.00, 1.00, 512),
    "x": (1.00, 1.50, 512),
}

STRIDES = (8, 16, 32)

_STEM_KEY = "model.0.conv.weight"


def make_divisible(x: float, divisor: int = 8) -> int:
    return max(divisor, int(x + divisor / 2) // divisor * divisor)


@dataclass(frozen=True)
class YoloConfig:
    nc: int = 1
    scale: str = "n"
    reg_max: int = 16
    nm: int = 32  # mask coefficients
    npr: int = 256  # proto channels (pre width-scaling)
    depth: float = field(init=False)
    width: float = field(init=False)
    max_ch: int = field(init=False)

    def __post_init__(self):
        d, w, mc = SCALES[self.scale]
        object.__setattr__(self, "depth", d)
        object.__setattr__(self, "width", w)
        object.__setattr__(self, "max_ch", mc)

    def ch(self, c: int) -> int:
        """Width-scaled channel count."""
        return make_divisible(min(c, self.max_ch) * self.width, 8)

    def rep(self, n: int) -> int:
        """Depth-scaled repeat count."""
        return max(round(n * self.depth), 1) if n > 1 else n

    @property
    def c3k_deep(self) -> bool:
        """m/l/x force c3k=True in every C3k2 (Ultralytics scale rule)."""
        return self.scale in ("m", "l", "x")

    @property
    def head_ch(self):
        """(P3, P4, P5) output channels of the neck."""
        return (self.ch(256), self.ch(512), self.ch(1024))


class Segment(nn.Module):
    """Detect+Segment head branches (raw per-level outputs, no decode).

    The DFL projection is a fixed arange contraction in ``infer.decode``,
    so unlike ultralytics there is no ``dfl`` module."""

    def __init__(self, nc, ch, reg_max=16, nm=32, npr=256):
        super().__init__()
        c2 = max(16, ch[0] // 4, reg_max * 4)
        c3 = max(ch[0], min(nc, 100))
        c4 = max(ch[0] // 4, nm)
        self.cv2 = nn.ModuleList(
            nn.Sequential(Conv(x, c2, 3), Conv(c2, c2, 3),
                          CastConv2d(c2, 4 * reg_max, 1)) for x in ch
        )
        self.cv3 = nn.ModuleList(
            nn.Sequential(
                nn.Sequential(DWConv(x, x, 3), Conv(x, c3, 1)),
                nn.Sequential(DWConv(c3, c3, 3), Conv(c3, c3, 1)),
                CastConv2d(c3, nc, 1),
            ) for x in ch
        )
        self.cv4 = nn.ModuleList(
            nn.Sequential(Conv(x, c4, 3), Conv(c4, c4, 3),
                          CastConv2d(c4, nm, 1)) for x in ch
        )
        self.proto = Proto(ch[0], npr, nm)

    def forward(self, feats):
        return {
            "box": [self.cv2[i](f) for i, f in enumerate(feats)],
            "cls": [self.cv3[i](f) for i, f in enumerate(feats)],
            "mcoef": [self.cv4[i](f) for i, f in enumerate(feats)],
            "proto": self.proto(feats[0]),
        }


class YOLO11Seg(nn.Module):
    """Full YOLO11-seg network; child index == ultralytics layer index.

    Input: NHWC [B, H, W, C] with H, W % 32 == 0 (C is 3, or 1 with a
    stem folded by `fold_gray_stem`); with ``from_p2``, the P2/4 map
    [B, c, H/4, W/4] (channels-last) that the fused stem computed
    (``model/stem.py``), and ``model.0``/``model.1`` are skipped. In train
    mode (``model.train()``; the model is built in eval mode) every block
    normalises with batch statistics and updates its running ones
    (``blocks.Conv``). With ``remat``, a train-mode forward with autograd on
    recomputes every ``C3k2``, the ``SPPF`` and the ``C2PSA`` in the
    backward instead of storing their activations (``blocks.rematerialise``,
    the reference's ``nn.remat`` over the same blocks): the same results,
    less activation memory, more time. A float32 model convolves in full
    float32 on the card (``precision_of``: TF32 off for the forward; the
    trainer scopes its backward alike).
    Returns a dict of NHWC tensors:
      box:   list of 3 [B, Hi, Wi, 4*reg_max] DFL box distributions
      cls:   list of 3 [B, Hi, Wi, nc] class logits
      mcoef: list of 3 [B, Hi, Wi, nm] mask coefficients
      proto: [B, H/4, W/4, nm] mask prototypes
    """

    # the layers the reference rematerialises: every C3k2, the SPPF, the C2PSA
    REMAT_LAYERS = (2, 4, 6, 8, 9, 10, 13, 16, 19, 22)

    def __init__(self, cfg: YoloConfig, dtype=torch.float32, remat: bool = False):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.remat = remat
        ch, n2, c3k = cfg.ch, cfg.rep(2), cfg.c3k_deep
        self.model = nn.Sequential(
            Conv(3, ch(64), 3, 2),                                    # 0 P1/2
            Conv(ch(64), ch(128), 3, 2),                              # 1 P2/4
            C3k2(ch(128), ch(256), n2, c3k, e=0.25),                  # 2
            Conv(ch(256), ch(256), 3, 2),                             # 3 P3/8
            C3k2(ch(256), ch(512), n2, c3k, e=0.25),                  # 4
            Conv(ch(512), ch(512), 3, 2),                             # 5 P4/16
            C3k2(ch(512), ch(512), n2, True),                         # 6
            Conv(ch(512), ch(1024), 3, 2),                            # 7 P5/32
            C3k2(ch(1024), ch(1024), n2, True),                       # 8
            SPPF(ch(1024), ch(1024), 5),                              # 9
            C2PSA(ch(1024), ch(1024), n2),                            # 10
            upsample2x(), Concat(),                                   # 11, 12
            C3k2(ch(1024) + ch(512), ch(512), n2, c3k),               # 13
            upsample2x(), Concat(),                                   # 14, 15
            C3k2(ch(512) + ch(512), ch(256), n2, c3k),                # 16 P3 out
            Conv(ch(256), ch(256), 3, 2),                             # 17
            Concat(),                                                 # 18
            C3k2(ch(256) + ch(512), ch(512), n2, c3k),                # 19 P4 out
            Conv(ch(512), ch(512), 3, 2),                             # 20
            Concat(),                                                 # 21
            C3k2(ch(512) + ch(1024), ch(1024), n2, True),             # 22 P5 out
            Segment(cfg.nc, cfg.head_ch, cfg.reg_max, cfg.nm,
                    cfg.ch(cfg.npr)),                                 # 23
        )
        self.eval()  # serves as built; the trainer switches to train mode

    def forward(self, x, from_p2: bool = False):
        with precision_of(self.dtype):
            return self._forward(x, from_p2)

    def _forward(self, x, from_p2: bool):
        m = self.model
        if self.remat and self.training and torch.is_grad_enabled():
            m = [functools.partial(blocks.rematerialise, layer) if i in self.REMAT_LAYERS
                 else layer for i, layer in enumerate(m)]
        if from_p2:
            y = x.to(self.dtype).contiguous(memory_format=torch.channels_last)
        else:
            x = x.to(self.dtype).permute(0, 3, 1, 2)
            y = m[1](m[0](x.contiguous(memory_format=torch.channels_last)))
        y = m[3](m[2](y))
        p3b = m[4](y)
        p4b = m[6](m[5](p3b))
        p5b = m[10](m[9](m[8](m[7](p4b))))
        n13 = m[13](m[12]([m[11](p5b), p4b]))
        p3 = m[16](m[15]([m[14](n13), p3b]))
        p4 = m[19](m[18]([m[17](p3), n13]))
        p5 = m[22](m[21]([m[20](p4), p5b]))
        out = m[23]([p3, p4, p5])
        nhwc = lambda t: t.permute(0, 2, 3, 1)
        return {
            "box": [nhwc(t) for t in out["box"]],
            "cls": [nhwc(t) for t in out["cls"]],
            "mcoef": [nhwc(t) for t in out["mcoef"]],
            "proto": nhwc(out["proto"]),
        }


def cls_bias_prior(nc: int, stride: int, imgsz: int = 640) -> float:
    """Detect-head prior for the class-logit bias: ~5 objects per 640x640
    image (the reference's ``cls_bias_init``)."""
    return math.log(5 / nc / (imgsz / stride) ** 2)


def create_model(nc: int = 1, scale: str = "n", dtype=torch.float32, remat: bool = False):
    cfg = YoloConfig(nc=nc, scale=scale)
    return YOLO11Seg(cfg, dtype=dtype, remat=remat), cfg


def create_model_from_env():
    """Serving-model construction from the TPU_MSLESSEG_{DTYPE,SCALE,IMGSZ}
    env knobs — the same names and defaults as the reference, so both
    packages resolve dtype, scale and imgsz alike. Returns (model, cfg,
    imgsz)."""
    dtype = {"float32": torch.float32, "bfloat16": torch.bfloat16}[
        os.environ.get("TPU_MSLESSEG_DTYPE", "bfloat16")
    ]
    model, cfg = create_model(
        nc=1, scale=os.environ.get("TPU_MSLESSEG_SCALE", "n"), dtype=dtype
    )
    return model, cfg, int(os.environ.get("TPU_MSLESSEG_IMGSZ", "640"))


def init_variables(model: YOLO11Seg, seed: int) -> dict:
    """Seeded random state_dict for `model` (float32, CPU), drawn from one
    ``torch.Generator``: conv weights LeCun-normal (std 1/sqrt(fan_in), the
    reference's flax default), conv biases 0 except the class-head prior,
    BatchNorm at identity (scale 1, bias 0, mean 0, var 1)."""
    gen = torch.Generator().manual_seed(seed)
    sd = {}
    for key, ref in model.state_dict().items():
        if ".bn." in key:
            name = key.rsplit(".", 1)[1]
            fill = {"weight": 1.0, "running_var": 1.0}.get(name, 0.0)
            sd[key] = torch.full_like(ref, fill)
        elif key.endswith(".weight"):
            fan_in = ref[0].numel()
            sd[key] = torch.randn(ref.shape, generator=gen) / math.sqrt(fan_in)
        else:
            sd[key] = torch.zeros_like(ref)
    for i, s in enumerate(STRIDES):
        sd[f"model.23.cv3.{i}.2.bias"].fill_(cls_bias_prior(model.cfg.nc, s))
    return sd


def fold_gray_stem(variables: dict) -> dict:
    """Inference-only variables transform for grayscale inputs.

    ``conv(repeat(x, 3), W) == conv(x, W.sum(in_ch))``, so summing the stem
    kernel over its input channels (in float32) lets the network take
    [B, H, W, 1] directly. Returns a new dict (input untouched);
    idempotent."""
    k = variables[_STEM_KEY]
    if k.shape[1] == 1:
        return variables
    new = dict(variables)
    new[_STEM_KEY] = k.to(torch.float32).sum(dim=1, keepdim=True).to(k.dtype)
    return new
