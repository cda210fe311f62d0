"""YOLO-seg polygon label writer (mask PNG -> normalized polygon rows).

Port of ``tpu_mslesseg/pipeline/labels.py`` (numpy and ``scipy.ndimage``,
host only); the text it writes equals the JAX package's byte for byte.

Artifact parity with the reference's use of
``ultralytics.data.converter.convert_segment_masks_to_yolo_seg``
(``extraer_dataset.py:215-227``): every GT mask PNG produces a ``.txt``
with one row per instance: ``<cls> x1 y1 x2 y2 ...`` normalized to [0,1].
Instances are 8-connected components; the polygon is the component's outer
boundary traced with Moore neighbor tracing (pixel-accurate, equivalent to
cv2 ``CHAIN_APPROX_NONE`` external contours).

Note: these labels exist for on-disk interop with YOLO tooling.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
from scipy import ndimage

# Moore neighborhood in clockwise order starting from W
_NEIGH = [(-0, -1), (-1, -1), (-1, 0), (-1, 1), (0, 1), (1, 1), (1, 0), (1, -1)]


def trace_boundary(mask: np.ndarray) -> list:
    """Outer boundary of a single connected component (binary mask) as a
    list of (row, col) pixel coordinates, clockwise."""
    rows, cols = np.nonzero(mask)
    if len(rows) == 0:
        return []
    # start: topmost-leftmost pixel
    i = int(rows.min())
    j = int(cols[rows == i].min())
    if len(rows) == 1:
        return [(i, j)]

    boundary = [(i, j)]
    # backtrack direction: came from the west (safe: the start is the
    # topmost-leftmost pixel, nothing lies W/NW/N/NE of it)
    prev_dir = 0
    cur = (i, j)
    start_state = (cur, prev_dir)
    H, W = mask.shape
    # stop on Jacobi's criterion: the trace is closed when the START pixel
    # is re-entered from the SAME backtrack direction as the initial state
    # — stopping at the first mere revisit cuts off branches that hang off
    # the start pixel (caught by the upstream-converter golden on a
    # speckle component; cv2's border following keeps those arms)
    for _ in range(8 * len(rows) + 8):
        found = False
        # search neighbors clockwise starting just after the backtrack
        for d in range(8):
            k = (prev_dir + 1 + d) % 8
            di, dj = _NEIGH[k]
            ni, nj = cur[0] + di, cur[1] + dj
            if 0 <= ni < H and 0 <= nj < W and mask[ni, nj]:
                cur = (ni, nj)
                # new backtrack: the direction pointing back whence we came
                prev_dir = (k + 4) % 8
                if (cur, prev_dir) == start_state:
                    return boundary
                boundary.append(cur)
                found = True
                break
        if not found:
            return boundary  # isolated pixel path
    return boundary


def mask_to_polygons(mask: np.ndarray) -> list:
    """Binary mask -> list of polygons (each [(row, col), ...]) per
    8-connected component, >= 3 points each."""
    labeled, n = ndimage.label(mask > 0, structure=np.ones((3, 3), int))
    polys = []
    for comp in range(1, n + 1):
        sel = labeled == comp
        # upstream's `len(contour) >= 3` guard counts CHAIN_APPROX_SIMPLE
        # vertices, which compress any 1-px-wide straight run to its two
        # endpoints — so 1-px, 2-px AND straight-line components of any
        # length produce <3 points and are dropped from the label file
        # (pinned against the transcribed converter in
        # tests/test_labels_golden.py). Equivalent component-level rule:
        # drop iff all pixels are collinear.
        if _all_collinear(sel):
            continue
        b = trace_boundary(sel)
        polys.append(b)
    return polys


def _all_collinear(sel: np.ndarray) -> bool:
    ys, xs = np.nonzero(sel)
    d = np.stack([ys - ys[0], xs - xs[0]], 1)
    nz = d[np.any(d != 0, axis=1)]
    if len(nz) == 0:
        return True  # single pixel
    ref = nz[0]
    return bool(np.all(d[:, 0] * ref[1] - d[:, 1] * ref[0] == 0))


def write_yolo_seg_label(mask: np.ndarray, out_path, cls: int = 0):
    """Write the YOLO-seg label txt for one mask image (pixels > 0 are the
    object). Coordinates normalized by (W, H) like the converter."""
    H, W = mask.shape
    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    lines = []
    for poly in mask_to_polygons(mask):
        coords = []
        for r, c in poly:
            coords.append(f"{c / W:.6f}")
            coords.append(f"{r / H:.6f}")
        lines.append(f"{cls} " + " ".join(coords))
    out_path.write_text("\n".join(lines) + ("\n" if lines else ""))
