"""Proto-mask union of the PyTorch port vs the JAX package.

On the CPU the port's wrapper runs its plain version, which must agree with
the JAX reference formulation and with the Pallas kernel run in interpret
mode (rtol 1e-5, atol 1e-5: only the order of the 32-term sums differs).
The CUDA kernel itself runs only on the card, in
``tests/test_torch_port_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_mslesseg.infer import mask_union_pallas as mup
from tpu_mslesseg_torch.infer import mask_union as tmu


def _rand_case(rng, n=3, mh=16, mw=16, nm=32, k=20, off_map=False):
    proto = rng.normal(size=(n, mh, mw, nm)).astype(np.float32)
    coef = rng.normal(size=(n, k, nm)).astype(np.float32)
    # boxes in letterbox px over a proto of stride 4 -> coords in [0, 4*m)
    lo = -4 * mw if off_map else 0
    x1 = rng.uniform(lo, 4 * mw * 0.8, (n, k))
    y1 = rng.uniform(lo, 4 * mh * 0.8, (n, k))
    grow = 2 * 4 * mw if off_map else 4 * mw / 2
    boxes = np.stack(
        [x1, y1, x1 + rng.uniform(2, grow, (n, k)), y1 + rng.uniform(2, grow, (n, k))],
        axis=-1,
    ).astype(np.float32)
    keep = rng.uniform(size=(n, k)) > 0.3
    return proto, coef, boxes, keep


def _keep_pattern(keep, pattern):
    if pattern == "all_dead":
        return np.zeros_like(keep)
    if pattern == "scattered":
        keep = np.zeros_like(keep)
        keep[:, [3, 70, keep.shape[1] - 1]] = True  # holes across chunks
    return keep


def _jax_ref(proto, coef, boxes, keep):
    return np.asarray(jax.vmap(mup.mask_union_logits_ref)(proto, coef, boxes, keep))


def _jax_pallas(proto, coef, boxes, keep):
    return np.asarray(
        mup.mask_union_logits_batch(proto, coef, boxes, keep, platform="tpu", interpret=True)
    )


CASES = [
    # (pattern, k, off_map)
    ("random", 20, False),
    ("random", 130, False),
    ("all_dead", 20, False),
    ("scattered", 150, False),
    ("random", 40, True),
]


@pytest.mark.parametrize("pattern,k,off_map", CASES)
def test_plain_union_matches_jax_ref_and_pallas(pattern, k, off_map):
    rng = np.random.default_rng(k + 7 * off_map)
    proto, coef, boxes, keep = _rand_case(rng, n=2, k=k, off_map=off_map)
    keep = _keep_pattern(keep, pattern)
    got = tmu.mask_union_logits_ref(
        torch.from_numpy(proto), torch.from_numpy(coef), torch.from_numpy(boxes),
        torch.from_numpy(keep),
    ).numpy()
    np.testing.assert_allclose(got, _jax_ref(proto, coef, boxes, keep), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, _jax_pallas(proto, coef, boxes, keep), rtol=1e-5, atol=1e-5)
    if pattern == "all_dead":
        assert np.all(got == tmu._NEG)


def test_plain_union_bf16_proto_matches_jax():
    rng = np.random.default_rng(3)
    proto, coef, boxes, keep = _rand_case(rng)
    proto_bf = jnp.asarray(proto, jnp.bfloat16)
    want = _jax_pallas(proto_bf, coef, boxes, keep)
    got = tmu.mask_union_logits_ref(
        torch.from_numpy(np.array(proto_bf.astype(jnp.float32))).to(torch.bfloat16),
        torch.from_numpy(coef), torch.from_numpy(boxes), torch.from_numpy(keep),
    ).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_plain_union_chunks_images():
    """The plain version walks the images in chunks to bound its
    per-detection tensor; chunking must not change the result."""
    rng = np.random.default_rng(11)
    args = [torch.from_numpy(a) for a in _rand_case(rng, n=5, k=30)]
    whole = tmu.mask_union_logits_ref(*args)
    saved = tmu._REF_CHUNK_ELEMS
    tmu._REF_CHUNK_ELEMS = 2 * 30 * 16 * 16  # two images per chunk
    try:
        chunked = tmu.mask_union_logits_ref(*args)
    finally:
        tmu._REF_CHUNK_ELEMS = saved
    torch.testing.assert_close(chunked, whole, rtol=0, atol=0)


def test_wrapper_on_cpu_runs_the_plain_version_and_counts_no_launch():
    rng = np.random.default_rng(12)
    args = [torch.from_numpy(a) for a in _rand_case(rng)]
    before = tmu.LAUNCHES
    out = tmu.mask_union_logits_batch(*args)
    assert tmu.LAUNCHES == before
    torch.testing.assert_close(out, tmu.mask_union_logits_ref(*args), rtol=0, atol=0)


def test_wrapper_refuses_a_device_without_the_kernel():
    rng = np.random.default_rng(13)
    args = [torch.from_numpy(a).to("meta") for a in _rand_case(rng)]
    with pytest.raises(ValueError, match="no kernel"):
        tmu.mask_union_logits_batch(*args)
