"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``gpu`` and skips without a CUDA device. The file
imports neither JAX nor the JAX package, so the machine with the card runs
it without the repository's conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_port_cuda.py -q

Tolerance: atol 1e-4, rtol 1e-5 (the kernel sums the 32 products in
another order than the plain version's matmul, which runs in full f32).
"""

import pytest
import torch

from tpu_mslesseg_torch.infer import mask_union as mu

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _case(seed, n, mh, mw, k, pattern, dtype, dev):
    gen = torch.Generator().manual_seed(seed)
    proto = torch.randn((n, mh, mw, 32), generator=gen)
    coef = torch.randn((n, k, 32), generator=gen)
    xy = torch.rand((n, k, 2), generator=gen) * 4 * mw
    wh = torch.rand((n, k, 2), generator=gen) * 2 * mw + 2
    if pattern == "off_map":
        xy = xy * 1.5 - 2 * mw
        wh = wh * 3
    boxes = torch.cat([xy, xy + wh], -1)
    keep = torch.rand((n, k), generator=gen) > 0.7
    if pattern == "all_dead":
        keep[:] = False
    elif pattern == "scattered":
        keep[:] = False
        keep[:, [3, 70, k - 1]] = True
    return proto.to(dev, dtype), coef.to(dev), boxes.to(dev), keep.to(dev)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "pattern,n,mh,mw,k",
    [
        ("random", 4, 40, 40, 20),
        ("random", 8, 160, 160, 300),
        ("all_dead", 4, 40, 40, 300),
        ("scattered", 4, 160, 160, 300),
        ("off_map", 4, 40, 40, 130),
        ("random", 3, 9, 9, 5),  # ragged last pixel tile
    ],
)
def test_kernel_matches_plain(cuda, dtype, pattern, n, mh, mw, k):
    args = _case(k + n, n, mh, mw, k, pattern, dtype, cuda)
    before = mu.LAUNCHES
    got = mu.mask_union_logits_batch(*args)
    torch.cuda.synchronize()
    assert mu.LAUNCHES == before + 1
    torch.testing.assert_close(got, mu.mask_union_logits_ref(*args), atol=1e-4, rtol=1e-5)
    if pattern == "all_dead":
        assert bool((got == mu._NEG).all())


def test_wrapper_checks_its_inputs(cuda):
    proto, coef, boxes, keep = _case(0, 2, 16, 16, 10, "random", torch.float32, cuda)
    with pytest.raises(ValueError):
        mu.mask_union_logits_batch(proto[..., :16], coef[..., :16], boxes, keep)
    with pytest.raises(TypeError):
        mu.mask_union_logits_batch(proto.half(), coef, boxes, keep)
    with pytest.raises(ValueError):
        mu.mask_union_logits_batch(proto.transpose(1, 2), coef, boxes, keep)
    with pytest.raises(ValueError):
        mu.mask_union_logits_batch(proto, coef, boxes.cpu(), keep)
    with pytest.raises(TypeError):
        mu.mask_union_logits_batch(proto, coef, boxes, keep.int())
