"""The port's label walk, traced by period, against the JAX package's.

``tpu_mslesseg_torch.pipeline.labels`` walks each component's boundary
until its first repeated state (pixel, backtrack direction) and tiles that
period up to the reference's cap of ``8 * area + 8`` steps. Every case here
holds the bytes it writes, and the point lists of ``trace_boundary`` and
``mask_to_polygons``, equal to ``tpu_mslesseg.pipeline.labels`` (numpy,
host only) and to the port's own plain versions, ``trace_boundary_ref`` and
``write_yolo_seg_label_ref``. Tolerance: none.
"""

from pathlib import Path

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from hypothesis.extra.numpy import arrays
from scipy import ndimage

from tpu_mslesseg.pipeline import labels as jlabels
from tpu_mslesseg_torch.pipeline import labels as tlabels

GOLDEN = Path(__file__).parent / "goldens" / "labels"
GOLDEN_CASES = sorted(p.stem[: -len("_mask")] for p in GOLDEN.glob("*_mask.npy"))


def _components(mask):
    """Every 8-connected component of `mask` (collinear ones too) as a
    boolean mask of the whole image."""
    labeled, n = ndimage.label(mask > 0, structure=np.ones((3, 3), int))
    return [labeled == k for k in range(1, n + 1)]


def _speckle_arm():
    # the start (1, 6) is the tip of a one-pixel arm off a 5x5 block, with
    # specks beside it
    m = np.zeros((14, 12), np.uint8)
    m[4:9, 4:9] = 1
    m[1:4, 6] = 1
    m[[2, 3, 11, 12], [1, 10, 2, 10]] = 1
    return m


def _ring():
    m = np.zeros((12, 13), np.uint8)
    m[2:10, 3:11] = 1
    m[3:9, 4:10] = 0
    return m


def _staircase():
    m = np.zeros((12, 13), np.uint8)
    for i in range(11):
        m[i, i:i + 2] = 1
    return m


def _borders():
    # a two-pixel-wide cross touching all four edges of the image
    m = np.zeros((10, 11), np.uint8)
    m[4:6, :] = 1
    m[:, 5:7] = 1
    return m


def _hole():
    m = np.zeros((12, 12), np.uint8)
    m[2:10, 2:10] = 1
    m[4:7, 4:8] = 0
    return m


def _diagonal_pair():
    m = np.zeros((7, 7), np.uint8)
    m[3, 3] = m[4, 4] = 1
    return m


def _L():
    m = np.zeros((8, 6), np.uint8)
    m[0:6, 0] = 1
    m[5, 0:4] = 1
    return m


SHAPES = {"speckle_arm": _speckle_arm, "ring": _ring, "staircase": _staircase,
          "borders": _borders, "hole": _hole, "diagonal_pair": _diagonal_pair, "L": _L}


def _written(write, mask, path):
    write(mask, path)
    return path.read_bytes()


def _assert_like_jax(mask, tmp_path):
    want = _written(jlabels.write_yolo_seg_label, mask, tmp_path / "j.txt")
    assert _written(tlabels.write_yolo_seg_label, mask, tmp_path / "t.txt") == want
    assert _written(tlabels.write_yolo_seg_label_ref, mask, tmp_path / "r.txt") == want
    assert tlabels.mask_to_polygons(mask) == jlabels.mask_to_polygons(mask)
    for sel in [mask] + _components(mask):
        want = jlabels.trace_boundary(sel)
        assert tlabels.trace_boundary(sel) == want
        assert tlabels.trace_boundary_ref(sel) == want
    return want


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_shapes_that_stress_the_period_equal_jax(tmp_path, shape):
    mask = SHAPES[shape]()
    _assert_like_jax(mask, tmp_path)
    if shape == "diagonal_pair":  # collinear: a walk, but no polygon
        assert (tmp_path / "t.txt").read_bytes() == b""
        prefix, period, total = tlabels.trace_boundary_period(mask)
        assert (len(prefix), len(period), total) == (1, 2, 8 * 2 + 8 + 1)
    else:
        assert (tmp_path / "t.txt").read_bytes().startswith(b"0 ")
    if shape == "L":  # the cap falls inside a period
        prefix, period, total = tlabels.trace_boundary_period(mask)
        whole, part = divmod(total - len(prefix), len(period))
        assert whole >= 1 and 0 < part < len(period)
    if shape == "speckle_arm":  # the arm is walked out and back in each period
        prefix, period, _ = tlabels.trace_boundary_period(mask)
        assert prefix == [(1, 6)] and period.count((2, 6)) == 2


@settings(max_examples=200, deadline=None, database=None)
@given(arrays(np.uint8, (24, 24), elements=st.integers(0, 1)))
def test_random_masks_write_the_bytes_of_jax_and_of_the_plain_writer(tmp_path_factory, mask):
    tmp = tmp_path_factory.mktemp("labels")
    want = _written(jlabels.write_yolo_seg_label, mask, tmp / "j.txt")
    assert _written(tlabels.write_yolo_seg_label, mask, tmp / "t.txt") == want
    assert _written(tlabels.write_yolo_seg_label_ref, mask, tmp / "r.txt") == want


def test_a_60x60_box_is_walked_once_round_then_tiled():
    """The fast walk stops at its first repeated state: on a 60x60 box that
    is the start and one trip round the 236 boundary pixels, where the
    reference walks the cap of 8 * 3600 + 8 steps. Only the start state lies
    outside the period: it is the one state whose backtrack (west) points
    outside the component, and the step is one-to-one on the others."""
    mask = np.zeros((64, 66), bool)
    mask[2:62, 3:63] = True
    perimeter = 4 * 60 - 4
    prefix, period, total = tlabels.trace_boundary_period(mask)
    assert len(prefix) + len(period) <= 3 * perimeter
    assert prefix == [(2, 3)] and len(period) == perimeter
    assert total == 8 * 3600 + 8 + 1
    assert tlabels.trace_boundary(mask) == jlabels.trace_boundary(mask)


@pytest.mark.parametrize("case", GOLDEN_CASES)
def test_plain_walk_equals_jax_on_the_golden_masks(tmp_path, case):
    mask = np.load(GOLDEN / f"{case}_mask.npy")
    for sel in [mask] + _components(mask):
        assert tlabels.trace_boundary_ref(sel) == jlabels.trace_boundary(sel)
    _assert_like_jax(mask, tmp_path)


def test_a_walk_that_ends_early_has_no_period_and_a_bad_count_raises():
    # two pixels apart: the start has no neighbour, the walk ends at once
    mask = np.zeros((5, 5), bool)
    mask[1, 1] = mask[3, 3] = True
    assert tlabels.trace_boundary_period(mask) == ([(1, 1)], [], 1)
    assert tlabels.trace_boundary(mask) == jlabels.trace_boundary(mask) == [(1, 1)]
    assert tlabels.trace_boundary_period(np.zeros((3, 3), bool)) == ([], [], 0)
    with pytest.raises(ValueError):
        tlabels._tiled_counts([(0, 0)], [], 5)
    with pytest.raises(ValueError):
        tlabels._tiled_counts([(0, 0), (0, 1)], [(1, 1)], 1)
