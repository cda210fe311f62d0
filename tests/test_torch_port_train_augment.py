"""The port's augmentation (``train/augment.py``) against the JAX package's.

The draws are the reference's: ``jax.random`` gives each sample's seven
parameters as the JAX ``make_batch`` draws them, and both applies take the
same parameters, with the mosaic on and off, with and without the flip, and
with scales and translations that push tiles and boxes off the canvas. The
source dataset is 8 random slices of 40x48 with one to three rectangles of
lesion each (instance maps, boxes and ``valid`` from ``label_instances``).

Tolerances: ``images`` within 1e-5 on the [0, 1] scale (the reference
resamples with one-hot matrix products, the port with two-tap gathers,
which round differently), ``instmap``, ``instmap_proto`` and ``valid``
exactly equal, ``boxes`` within 1e-4 pixels. The port's own draw is held
to its ranges and to its seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_mslesseg.train import augment as jaug
from tpu_mslesseg_torch.train import augment as taug
from tpu_mslesseg_torch.train import data as tdata

S, B, M, H, W, MAX_INST = 64, 6, 8, 40, 48, 4


@pytest.fixture(scope="module")
def dataset():
    rng = np.random.default_rng(11)
    images = rng.integers(0, 256, (M, H, W)).astype(np.uint8)
    inst = np.zeros((M, H, W), np.uint8)
    boxes = np.zeros((M, MAX_INST, 4), np.float32)
    valid = np.zeros((M, MAX_INST), bool)
    for i in range(M):
        mask = np.zeros((H, W), np.uint8)
        for _ in range(rng.integers(1, 4)):
            y, x = rng.integers(0, H - 6), rng.integers(0, W - 6)
            mask[y : y + rng.integers(3, 12), x : x + rng.integers(3, 14)] = 1
        inst[i], boxes[i], valid[i] = tdata.label_instances(mask, MAX_INST)
    return {"images": images, "instmaps": inst, "boxes": boxes, "valid": valid}


def _jax_params(key, cfg):
    """The parameters JAX's make_batch draws with `key`, as numpy [B] arrays."""
    keys = jax.random.split(key, B)
    p = jax.vmap(lambda k: jaug._draw_params(k, cfg))(keys)
    return {f: np.asarray(getattr(p, f)) for f in jaug._AugParams._fields}


CASES = {
    "mosaic": (True, {}),
    "mosaic_flip": (True, {"flip_u": 0.0}),
    "mosaic_noflip": (True, {"flip_u": 0.99}),
    "mosaic_off_canvas": (True, {"s": 1.5, "tx": -20.0, "ty": 90.0, "gain": 1.0}),
    "plain": (False, {}),
    "plain_flip": (False, {"flip_u": 0.0}),
    "plain_off_canvas": (False, {"s": 1.4, "tx": 5.0, "ty": 60.0, "gain": 1.0}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_apply_equals_jax(dataset, case):
    mosaic, override = CASES[case]
    cfg = jaug.AugConfig(imgsz=S, max_inst=MAX_INST, mosaic=mosaic)
    p = _jax_params(jax.random.PRNGKey(len(case)), cfg)
    for k, v in override.items():
        p[k] = np.full(B, v, np.float32)
    rng = np.random.default_rng(len(case))
    idx = rng.integers(0, M, (B, 4))

    n = 4 if mosaic else 1
    jd = {k: jnp.asarray(v) for k, v in dataset.items()}
    jp = jaug._AugParams(**{k: jnp.asarray(v) for k, v in p.items()})
    j_out = jax.jit(jax.vmap(
        lambda pp, ids: jaug._apply_mosaic(
            pp, jd["images"][ids].astype(jnp.float32), jd["instmaps"][ids], jd["boxes"][ids],
            jd["valid"][ids], cfg)))(jp, jnp.asarray(idx[:, :n]))
    j_img, j_inst, j_boxes, j_valid = (np.asarray(a) for a in j_out)

    tp = taug.AugParams(**{k: torch.tensor(v) for k, v in p.items()})
    td = {k: torch.from_numpy(v) for k, v in dataset.items()}
    ti = torch.from_numpy(idx[:, :n])
    t_img, t_inst, t_boxes, t_valid = taug.apply_batch(
        tp, td["images"][ti].float(), td["instmaps"][ti], td["boxes"][ti], td["valid"][ti],
        taug.AugConfig(*cfg))

    np.testing.assert_allclose(t_img.numpy() / 255.0, j_img / 255.0, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(t_inst.numpy(), j_inst)
    np.testing.assert_array_equal(t_valid.numpy(), j_valid)
    np.testing.assert_allclose(t_boxes.numpy(), j_boxes, rtol=0, atol=1e-4)
    assert j_valid.any() and (t_inst.numpy() > 0).any()  # the cases hold instances
    if "off_canvas" in case:  # the border shows, and boxes fell off the canvas
        assert (j_img == 114).any()
        assert j_valid.sum() < dataset["valid"][idx[:, :n]].sum()


@pytest.mark.parametrize("mosaic", [True, False])
def test_make_batch_equals_jax(dataset, mosaic):
    """The whole batch (proto-resolution map, [0, 1] images in 3 channels)
    from the draws JAX's make_batch makes with the same key."""
    cfg = jaug.AugConfig(imgsz=S, max_inst=MAX_INST, mosaic=mosaic)
    key = jax.random.PRNGKey(3)
    idx = np.random.default_rng(5).integers(0, M, (B, 4))
    want = jax.tree_util.tree_map(np.asarray, jaug.make_batch(
        key, {k: jnp.asarray(v) for k, v in dataset.items()}, jnp.asarray(idx), cfg))
    p = taug.AugParams(**{k: torch.tensor(v) for k, v in _jax_params(key, cfg).items()})
    got = taug.make_batch(p, {k: torch.from_numpy(v) for k, v in dataset.items()},
                          torch.from_numpy(idx), taug.AugConfig(*cfg))
    assert set(got) == set(want)
    np.testing.assert_allclose(got["images"].numpy(), want["images"], rtol=0, atol=1e-5)
    for k in ("instmap", "instmap_proto", "valid"):
        np.testing.assert_array_equal(got[k].numpy(), want[k])
    np.testing.assert_allclose(got["boxes"].numpy(), want["boxes"], rtol=0, atol=1e-4)
    np.testing.assert_array_equal(taug.proto_centers(S).numpy(), np.arange(S // 4) * 4 + 1)


def test_draw_ranges_and_determinism():
    cfg = taug.AugConfig(imgsz=S)
    p = taug.draw_params(torch.Generator().manual_seed(0), cfg, 4096)
    assert all(t.shape == (4096,) and t.dtype == torch.float32 for t in p)
    for c in (p.yc, p.xc):
        assert torch.equal(c, c.floor()) and c.min() >= S / 2 and c.max() < 3 * S / 2
    assert p.s.min() >= 0.5 and p.s.max() < 1.5
    assert p.tx.min() >= 0.4 * S - 1e-4 and p.tx.max() < 0.6 * S + 1e-4
    assert p.ty.min() >= 0.4 * S - 1e-4 and p.ty.max() < 0.6 * S + 1e-4
    assert p.flip_u.min() >= 0 and p.flip_u.max() < 1
    assert p.gain.min() >= 0.6 and p.gain.max() < 1.4
    again = taug.draw_params(torch.Generator().manual_seed(0), cfg, 4096)
    assert all(torch.equal(a, b) for a, b in zip(p, again))
    other = taug.draw_params(torch.Generator().manual_seed(1), cfg, 4096)
    assert not torch.equal(p.s, other.s)
    # the validation config draws the identity
    v = taug.draw_params(torch.Generator().manual_seed(0),
                         taug.AugConfig(imgsz=S, scale=0.0, translate=0.0, fliplr=0.0, hsv_v=0.0), 8)
    assert bool((v.s == 1).all() and (v.tx == S / 2).all() and (v.gain == 1).all())
