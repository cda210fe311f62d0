"""Seeded synthetic training batches, in the layout the train step takes.

The augmentation that makes real batches is not ported yet, so smoke runs
and tests build theirs here with numpy: a few bright ellipses ("lesions")
on a noisy background an image. A batch holds ``images`` [B, S, S, 3]
float32 in [0, 1], ``instmap_proto`` [B, S/4, S/4] uint8 (instance id + 1
inside each ellipse at a quarter of the resolution, 0 elsewhere), ``boxes``
[B, M, 4] float32 xyxy in pixels (the ellipses' boxes, zero rows for the
padding) and ``valid`` [B, M] bool.
"""

from __future__ import annotations

import numpy as np


def synthetic_batch(seed: int, batch: int, imgsz: int, slots: int, max_valid: int = 5,
                    size: tuple[float, float] = (1 / 16, 1 / 4)) -> dict:
    """One batch from `seed`: 1 to `max_valid` ellipses an image, each
    between ``size[0]`` and ``size[1]`` of the image's side across (1/16 to
    1/4 unless given), in the first slots of `slots`. Ellipses of a third
    of the side and more hold anchors of every level, which puts the box
    and DFL loss parts well above zero at seeded weights."""
    if imgsz % 4 or max_valid > slots:
        raise ValueError(f"imgsz {imgsz} must be a multiple of 4 and max_valid <= slots")
    rng = np.random.default_rng(seed)
    ph = imgsz // 4
    gray = rng.uniform(0.1, 0.5, (batch, imgsz, imgsz)).astype(np.float32)
    instmap = np.zeros((batch, ph, ph), np.uint8)
    boxes = np.zeros((batch, slots, 4), np.float32)
    valid = np.zeros((batch, slots), np.bool_)
    yy, xx = np.mgrid[0:imgsz, 0:imgsz].astype(np.float32) + 0.5
    for b in range(batch):
        for i in range(int(rng.integers(1, max_valid + 1))):
            w, h = rng.uniform(imgsz * size[0], imgsz * size[1], 2)
            cx = rng.uniform(w / 2, imgsz - w / 2)
            cy = rng.uniform(h / 2, imgsz - h / 2)
            inside = ((xx - cx) / (w / 2)) ** 2 + ((yy - cy) / (h / 2)) ** 2 < 1.0
            gray[b][inside] = np.minimum(gray[b][inside] + 0.4, 1.0)
            # the mask at proto resolution: the centre pixel of every 4 x 4 cell
            instmap[b][inside[2::4, 2::4]] = i + 1
            boxes[b, i] = (cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2)
            valid[b, i] = True
    images = np.repeat(gray[..., None], 3, axis=-1)
    return {"images": images, "instmap_proto": instmap, "boxes": boxes, "valid": valid}
