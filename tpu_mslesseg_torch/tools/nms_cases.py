"""Seeded NMS inputs that exercise the suppression, made with numpy.

Seeded weights keep 85-224 boxes a slice near NMS's thresholds, and their
candidates overlap in long chains; these functions make inputs of that kind
for the tests and the smoke run: ``clustered`` (every anchor a box of its
nearest object's size, scored by how near it lies), ``chain`` (boxes in a row, each overlapping
the next above the IoU threshold and not the one after, so the fixpoint
needs about one step a link) and ``threshold_pairs`` (pairs whose IoU, as
``infer/nms.box_iou_matrix`` rounds it in float32, sits at, one ulp above
and one ulp below the threshold). Boxes are [B, A, 4] float32 xyxy in
letterbox pixels, scores [B, A] float32 in (0, 1).
"""

from __future__ import annotations

import numpy as np


def anchor_points(imgsz: int = 640):
    """The anchors' centres [A, 2] in pixels: the stride-8, 16 and 32 grids
    of the model's three levels (8,400 at 640)."""
    pts = []
    for stride in (8, 16, 32):
        y, x = np.mgrid[0:imgsz // stride, 0:imgsz // stride]
        pts.append((np.stack([x.ravel(), y.ravel()], -1) + 0.5) * stride)
    return np.concatenate(pts)


def clustered(seed: int, batch: int, anchors: int = 8400, imgsz: int = 640, objects: int = 12,
              ties: bool = True):
    """Each anchor (the model's grid at 8,400, else a random draw of it)
    predicts a box of its nearest object's size, give or take 15%, centred
    near the anchor, scored by how near it lies: the top candidates of an
    object are its neighbouring anchors, whose boxes overlap around the
    threshold, and 100-200 of 300 survive NMS at 0.7, as with seeded weights
    (C6). With `ties`, the logits lie on a grid of 1/8 (as bf16 logits do:
    exact ties everywhere). -> (boxes, scores)."""
    rng = np.random.default_rng(seed)
    pts = anchor_points(imgsz)
    if anchors != len(pts):
        pts = pts[rng.integers(0, len(pts), anchors)]
    size = rng.uniform(imgsz / 20, imgsz / 4, (batch, objects, 2))
    ctr = rng.uniform(0, 1, (batch, objects, 2)) * (imgsz - size) + size / 2
    dist = np.linalg.norm((pts[None, :, None] - ctr[:, None]) / size[:, None], axis=-1)
    near = dist.argmin(-1)
    wh = np.take_along_axis(size, near[..., None], 1) * rng.uniform(0.85, 1.15, (batch, anchors, 2))
    c = pts[None] + rng.normal(0, 2, (batch, anchors, 2))
    boxes = np.concatenate([c - wh / 2, c + wh / 2], -1).astype(np.float32)
    logits = 1 - 4 * dist.min(-1) + rng.normal(0, 1, (batch, anchors))
    if ties:
        logits = np.round(logits * 8) / 8
    return boxes, (1 / (1 + np.exp(-logits))).astype(np.float32)


def chain(depth: int, anchors: int, seed: int = 0, width: float = 10.0, step: float = 1.2):
    """One image: `depth` boxes of side `width` in a row, `step` apart, with
    descending scores from 0.99 (IoU of neighbours (w - s) / (w + s), 0.786
    at the defaults, and of boxes two apart (w - 2s) / (w + 2s), 0.613: the
    greedy result keeps every second box, and the fixpoint takes about
    `depth` steps), then `anchors - depth` random boxes far below the row
    with random scores under the row's. -> (boxes [1, anchors, 4], scores
    [1, anchors])."""
    rng = np.random.default_rng(seed)
    x = np.arange(depth) * step
    row = np.stack([x, np.zeros(depth), x + width, np.full(depth, width)], -1)
    rest = anchors - depth
    xy = rng.uniform(0, 600, (rest, 2)) + [0.0, 100.0]
    other = np.concatenate([xy, xy + rng.uniform(5, 40, (rest, 2))], -1)
    boxes = np.concatenate([row, other])[None].astype(np.float32)
    top = 0.99 - 1e-3 * np.arange(depth)
    scores = np.concatenate([top, rng.uniform(0.05, top[-1] - 1e-3, rest)])[None]
    return boxes, scores.astype(np.float32)


def iou32(a, b):
    """IoU of boxes `a` and `b` (float32 xyxy), each elementwise operation
    rounded to float32 in ``box_iou_matrix``'s order."""
    a, b = np.float32(a), np.float32(b)
    zero = np.float32(0)
    area_a = max(a[2] - a[0], zero) * max(a[3] - a[1], zero)
    area_b = max(b[2] - b[0], zero) * max(b[3] - b[1], zero)
    w = max(min(a[2], b[2]) - max(a[0], b[0]), zero)
    h = max(min(a[3], b[3]) - max(a[1], b[1]), zero)
    inter = w * h
    union = max((area_a + area_b) - inter, np.float32(1e-7))
    return inter / union


def threshold_pairs(iou_thres: float, pairs: int = 12, seed: int = 0):
    """One image of `pairs` pairs of boxes, apart, each pair's first box
    scored above its second and their IoU (``iou32``) exactly float32
    `iou_thres` rounded, one ulp above it or one ulp below it, a third each
    in turn: the second box is suppressed only where its IoU exceeds the
    threshold. -> (boxes [1, 2 pairs, 4], scores [1, 2 pairs], ious
    [pairs] float32)."""
    rng = np.random.default_rng(seed)
    t = np.float32(iou_thres)
    targets = (t, np.nextafter(t, np.float32(2)), np.nextafter(t, np.float32(-1)))
    boxes, ious = [], []
    for p in range(pairs):
        want, y0 = targets[p % 3], np.float32(40 * p)
        for _ in range(1000):  # a random first box, then the second box's width
            side, h = rng.uniform(8, 32, 2).astype(np.float32)
            first = np.array([0, y0, side, y0 + h], np.float32)
            second = np.array([0, y0, np.float32(want * side), y0 + h], np.float32)
            got = iou32(first, second)
            up = got < want
            # walk the width an ulp at a time (at x = 0 the right edge is the
            # width, to the last bit) until the IoU is the target or passes it
            while got != want and (got < want) == up:
                second[2] = np.nextafter(second[2], np.float32(np.inf if up else -np.inf))
                got = iou32(first, second)
            if got == want:
                break
        else:
            raise ValueError(f"no pair of boxes found with IoU {want!r}")
        boxes += [first, second]
        ious.append(got)
    scores = 0.9 - 0.01 * np.arange(2 * pairs)
    return (np.stack(boxes)[None].astype(np.float32), scores[None].astype(np.float32),
            np.array(ious, np.float32))
