"""LT (``preproc/enhance.lt_batch``) against the JAX package's, exactly.

``c * log1p(v)`` with ``c = 255 / log1p(max)`` a slice, truncated to uint8.
The port reads ``log1p`` of 0..255 from a table of the reference's float32
values (float64 ``log1p`` rounded, with XLA's one-ulp differences at 6, 46,
48 and 178) and divides tensor by tensor, as XLA does. Checked on an image
of every maximum 0..255 holding every value up to it, and on blank and
random slices through ``enhance_batch``. Tolerance: none.
"""

import numpy as np
import pytest
import torch

from tpu_mslesseg.preproc import enhance as jenh
from tpu_mslesseg_torch.preproc import enhance as tenh


def test_lt_equals_jax_for_every_maximum():
    imgs = np.zeros((256, 16, 16), np.uint8)
    for m in range(256):
        imgs[m].reshape(-1)[: m + 1] = np.arange(m + 1)
    got = tenh.lt_batch(torch.from_numpy(imgs)).numpy()
    want = np.asarray(jenh.lt_batch(imgs))
    bad = [m for m in range(256) if not np.array_equal(got[m], want[m])]
    assert bad == []


def test_the_log1p_table_is_the_references():
    import jax.numpy as jnp

    x = np.arange(256, dtype=np.float32)
    np.testing.assert_array_equal(tenh._LOG1P, np.asarray(jnp.log1p(jnp.asarray(x))))
    diff = tenh._LOG1P != np.log1p(x.astype(np.float64)).astype(np.float32)
    assert np.nonzero(diff)[0].tolist() == [6, 46, 48, 178]


@pytest.mark.parametrize("seed", [0, 1])
def test_lt_through_enhance_batch_equals_jax(seed):
    rng = np.random.default_rng(seed)
    raw = rng.normal(400, 120, (6, 24, 28)).astype(np.float32)
    raw[2] = 0.0  # a blank slice
    u8 = rng.integers(0, 200, (6, 20, 20)).astype(np.uint8)  # maxima below 255
    np.testing.assert_array_equal(tenh.enhance_batch(torch.from_numpy(raw), "LT").numpy(),
                                  np.asarray(jenh.enhance_batch(raw, "LT")))
    np.testing.assert_array_equal(
        tenh.enhance_batch(torch.from_numpy(u8), "LT", normalize=False).numpy(),
        np.asarray(jenh.enhance_batch(u8, "LT", normalize=False)))
