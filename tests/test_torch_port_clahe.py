"""The port's CLAHE (tile LUTs and the whole chain) vs the JAX package.

The tile LUTs are held exactly against JAX's Pallas ``_tile_luts_pallas``
(interpret mode on the CPU) and against the ``tile_lut`` inside
``enhance._clahe_core``. That function is not exposed, so the test reads it
through ``_clahe_core`` on a one-tile image: with one tile the four blended
LUTs are the same, the blend returns the LUT entry of each pixel's value,
and every value the tile holds shows its LUT entry. The images are held
exactly against ``enhance.clahe_batch`` and ``enhance_for_model``, and
within the cv2 goldens' own bounds (``tests/test_enhance.py``). The blend's
plain version, given the LUTs of JAX's Pallas kernel, equals the blend of
JAX's compiled ``_clahe_core`` on every pixel.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_mslesseg.preproc import clahe_pallas as jcp
from tpu_mslesseg.preproc import enhance as jenh
from tpu_mslesseg_torch.preproc import clahe as tcl
from tpu_mslesseg_torch.preproc import enhance as tenh
from torch_threads import one_torch_thread  # noqa: F401

GOLDENS = Path(__file__).parent / "goldens" / "enhance_goldens.npz"
# (h, w) of the three plane slices of a 182x218x182 volume
PLANE_HW = [(182, 218), (182, 182), (218, 182)]


def _tile(rng, th, tw, kind, limit):
    """A th x tw uint8 tile of one edge-case kind (clip limit `limit`)."""
    area = th * tw
    if kind == "random":
        pix = rng.integers(0, 256, area)
    elif kind == "every_value":  # each of the 256 values at least once
        pix = np.concatenate([np.arange(256), rng.integers(0, 256, area - 256)])
    elif kind == "constant":
        pix = np.full(area, 131)
    elif kind == "two_valued":
        pix = np.where(rng.uniform(size=area) < 0.3, 17, 240)
    elif kind == "residual_zero":  # clipped excess exactly 512: residual 0
        big = 512 + limit
        pix = np.concatenate([np.full(big, 60), 61 + np.arange(area - big) % 190])
    elif kind == "all_clip":  # every bin above limit 1 (clip_limit 0.1)
        pix = np.concatenate([np.arange(256), np.arange(256), rng.integers(0, 256, area - 512)])
    else:
        raise ValueError(kind)
    return rng.permutation(pix).astype(np.uint8).reshape(th, tw)


def _limit(area, kind):
    return max(int((0.1 if kind == "all_clip" else 2.0) * area / 256), 1)


KINDS = ["random", "every_value", "constant", "two_valued", "residual_zero", "all_clip"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("hw", PLANE_HW)
def test_tile_luts_equal_jax_exactly(hw, kind):
    th, tw, area, limit = tcl.tile_geometry(*hw)
    assert (th, tw, limit) == {(182, 218): (23, 28, 5), (182, 182): (23, 23, 4),
                               (218, 182): (28, 23, 5)}[hw]
    limit = _limit(area, kind)
    rng = np.random.default_rng(area + len(kind))
    tiles = np.stack([_tile(rng, th, tw, kind, limit).reshape(-1) for _ in range(2)])
    got = tcl.tile_luts_ref(torch.from_numpy(tiles).long(), area, limit).numpy()
    assert got.dtype == np.float32 and got.shape == (2, 256)

    want = np.asarray(jcp._tile_luts_pallas(jnp.asarray(tiles, jnp.int32), area, limit))
    np.testing.assert_array_equal(got, want)

    # the tile_lut of _clahe_core, read through a one-tile image
    if kind == "residual_zero":
        hist = np.bincount(tiles[0], minlength=256)
        assert np.maximum(hist - limit, 0).sum() % 256 == 0
    img = tiles[0].reshape(th, tw)
    clip = 0.1 if kind == "all_clip" else 2.0
    out = np.asarray(jenh._clahe_core(jnp.asarray(img), clip, 1, 1))
    np.testing.assert_array_equal(out, got[0][img].astype(np.uint8))
    if kind == "every_value":  # the whole LUT was seen
        assert len(np.unique(img)) == 256


@pytest.mark.parametrize("hw", PLANE_HW)
def test_image_tiles_and_luts_match_jax(hw):
    """REFLECT_101 extension and tile order as JAX's ``jnp.pad(...,
    "reflect")`` and reshape give them; the per-image LUTs as Pallas."""
    rng = np.random.default_rng(hw[0] + hw[1])
    imgs = rng.integers(0, 256, (2,) + hw, dtype=np.uint8)
    th, tw, area, limit = tcl.tile_geometry(*hw)
    ext = np.pad(imgs, ((0, 0), (0, 8 * th - hw[0]), (0, 8 * tw - hw[1])), mode="reflect")
    want_tiles = ext.reshape(2, 8, th, 8, tw).transpose(0, 1, 3, 2, 4).reshape(-1, area)
    got_tiles = tcl.image_tiles(torch.from_numpy(imgs)).numpy()
    np.testing.assert_array_equal(got_tiles, want_tiles)
    got = tcl.clahe_tile_luts(torch.from_numpy(imgs)).numpy()
    assert got.shape == (2, 64, 256)
    want = np.asarray(jcp._tile_luts_pallas(jnp.asarray(want_tiles, jnp.int32), area, limit))
    np.testing.assert_array_equal(got.reshape(-1, 256), want)


@pytest.fixture(scope="module")
def goldens():
    return np.load(GOLDENS)


def _plane_images():
    """uint8 images of the two other plane shapes: noise, and a smooth
    field with noise (steep and flat tile LUTs)."""
    rng = np.random.default_rng(11)
    out = []
    for hw in PLANE_HW[1:]:
        yy, xx = np.mgrid[: hw[0], : hw[1]]
        smooth = (np.sin(yy / 7.0) + np.cos(xx / 11.0)) * 60 + 128 + rng.normal(0, 5, hw)
        out.append(np.stack([rng.integers(0, 256, hw), smooth.clip(0, 255)]).astype(np.uint8))
    return out


def test_clahe_batch_equals_jax_and_meets_cv2_bounds(goldens):
    imgs = goldens["imgs"]
    got = tenh.clahe_batch(torch.from_numpy(imgs)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jenh.clahe_batch(imgs)))
    np.testing.assert_array_equal(
        tenh.enhance_batch(torch.from_numpy(imgs), "CLAHE", normalize=False).numpy(), got
    )
    # the cv2 goldens' own bounds (tests/test_enhance.py::test_clahe_close)
    diff = np.abs(got.astype(int) - goldens["CLAHE"].astype(int))
    assert diff.max() <= 2, diff.max()
    assert (diff > 0).mean() < 0.005
    assert (diff > 1).mean() < 1e-3
    for imgs in _plane_images():
        np.testing.assert_array_equal(
            tenh.clahe_batch(torch.from_numpy(imgs)).numpy(),
            np.asarray(jenh.clahe_batch(imgs)),
        )


def test_enhance_for_model_clahe_equals_jax(goldens):
    rng = np.random.default_rng(12)
    batches = [goldens["imgs"].astype(np.float32) * 3.7 - 40.0]
    for hw in PLANE_HW[1:]:
        s = rng.normal(500, 150, (3,) + hw).astype(np.float32)
        s[1] = 7.0  # constant slice
        s[2, 40:90, 60:120] += 900.0
        batches.append(s)
    for slices in batches:
        want = np.asarray(jenh.enhance_for_model(jnp.asarray(slices), "CLAHE"))
        got = tenh.enhance_for_model(torch.from_numpy(slices), "CLAHE").numpy()
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, want)


def test_lab_luts_equal_jax():
    np.testing.assert_array_equal(tenh._LAB_FWD, jenh._LAB_FWD)
    np.testing.assert_array_equal(tenh._LAB_BWD, jenh._LAB_BWD)
    assert float(tcl.lut_scale(644)) == float(np.float32(255.0 / 644))


def test_wrapper_refuses_devices_without_a_kernel():
    with pytest.raises(ValueError, match="no kernel"):
        tcl.clahe_tile_luts(torch.zeros((1, 16, 16), dtype=torch.uint8, device="meta"))


def _disc_images(rng, n, h, w):
    """Noise inside a centred disc of half the image's area, zeros outside:
    background-heavy, as a FLAIR slice is."""
    yy, xx = np.mgrid[:h, :w]
    inside = (yy - h / 2) ** 2 + (xx - w / 2) ** 2 < 0.5 * h * w / np.pi
    return (rng.integers(0, 256, (n, h, w)) * inside).astype(np.uint8)


def _jax_luts(imgs, tiles_x, tiles_y):
    """JAX's Pallas tile LUTs of uint8 images [N, H, W], as [N, T, 256]."""
    n, h, w = imgs.shape
    th, tw, area, limit = tcl.tile_geometry(h, w, 2.0, tiles_x, tiles_y)
    ext = np.pad(imgs, ((0, 0), (0, tiles_y * th - h), (0, tiles_x * tw - w)), mode="reflect")
    tiles = ext.reshape(n, tiles_y, th, tiles_x, tw).transpose(0, 1, 3, 2, 4).reshape(-1, area)
    luts = jcp._tile_luts_pallas(jnp.asarray(tiles, jnp.int32), area, limit)
    return np.array(luts).reshape(n, tiles_y * tiles_x, 256)


BLEND_CASES = {  # name: (images, tiles_x, tiles_y)
    **{f"plane_{h}x{w}": (lambda rng, h=h, w=w: rng.integers(0, 256, (2, h, w)).astype(np.uint8), 8, 8)
       for h, w in PLANE_HW},
    "background_182x218": (lambda rng: _disc_images(rng, 2, 182, 218), 8, 8),
    "one_tile_23x28": (lambda rng: rng.integers(0, 256, (2, 23, 28)).astype(np.uint8), 1, 1),
    "tiles_4x6_182x218": (lambda rng: rng.integers(0, 256, (2, 182, 218)).astype(np.uint8), 4, 6),
}


@pytest.mark.parametrize("case", list(BLEND_CASES))
def test_clahe_blend_ref_equals_jax_blend(case):
    """The plain blend on LUTs from JAX's Pallas kernel equals the blend in
    JAX's compiled ``_clahe_core`` (the program ``clahe_batch`` runs), the
    backward L map applied to both."""
    make, tiles_x, tiles_y = BLEND_CASES[case]
    imgs = make(np.random.default_rng(len(case)))
    luts = _jax_luts(imgs, tiles_x, tiles_y)
    core = jax.jit(jax.vmap(lambda im: jenh._clahe_core(im, 2.0, tiles_x, tiles_y)))
    want = jenh._LAB_BWD[np.asarray(core(jnp.asarray(imgs)))]
    bwd = torch.from_numpy(tenh._LAB_BWD)
    got = tcl.clahe_blend_ref(torch.from_numpy(imgs), torch.from_numpy(luts), bwd, tiles_x, tiles_y)
    assert got.dtype == torch.uint8 and tuple(got.shape) == imgs.shape
    np.testing.assert_array_equal(got.numpy(), want)
    # the wrapper runs the plain version on the CPU and launches nothing
    before = tcl.BLEND_LAUNCHES
    again = tcl.clahe_blend(torch.from_numpy(imgs), torch.from_numpy(luts), bwd, tiles_x, tiles_y)
    assert torch.equal(again, got) and tcl.BLEND_LAUNCHES == before


def test_blend_wrapper_refuses_devices_without_a_kernel():
    imgs = torch.zeros((1, 16, 16), dtype=torch.uint8, device="meta")
    luts = torch.zeros((1, 64, 256), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        tcl.clahe_blend(imgs, luts, torch.zeros(256, dtype=torch.uint8, device="meta"))
