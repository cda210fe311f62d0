"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``gpu`` and skips without a CUDA device. The file
imports neither JAX nor the JAX package, so the machine with the card runs
it without the repository's conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_port_cuda.py -q

Tolerances: the mask union with f32 coefficients (the FMA kernel) atol
1e-4, rtol 1e-5 (the kernel sums the 32 products in another order than the
plain version's matmul, which runs in full f32); with bf16 proto and bf16
coefficients (the tensor-core kernel) ``mask_union.union_error_bound``, two
f32 summation orders of 32 exact products; the CLAHE tile LUTs exactly (integer histograms, the same f32
scale, round half to even) and the CLAHE blend exactly (the same f32
roundings, each FMA rounded once); the stem in f32 atol and rtol 2e-5 (cuDNN's
TF32 off), in bf16 ``stem.bf16_error_bound``: one bf16 ulp of b1's conv
sum carried through BN and SiLU, plus one ulp of the output (the two sum in
different orders, so a conv sum may round one ulp apart, and where BN's
running mean cancels most of it that ulp exceeds the output's).
"""

import pytest
import torch

from tpu_mslesseg_torch.infer import mask_union as mu
from tpu_mslesseg_torch.model import stem
from tpu_mslesseg_torch.model.yolo11 import create_model, fold_gray_stem, init_variables
from tpu_mslesseg_torch.preproc import clahe, enhance

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
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


def _tile_edge_boxes(gen, n, k, mh, mw):
    """Boxes (letterbox px, proto stride 4) whose edges fall on, just
    before and just after the 8 x 32 pixel tiles' borders, in rows and in
    columns."""
    offs = torch.tensor([-1.0, -0.5, 0.0, 0.25, 1.0, 7.5])
    def edges(tile, size):
        base = torch.randint(0, size // tile + 1, (n, k), generator=gen) * tile
        lo = base + offs[torch.randint(0, len(offs), (n, k), generator=gen)]
        span = torch.tensor([0.5, 1.0, float(tile), tile + 0.5, 2.5 * tile])
        return lo, lo + span[torch.randint(0, len(span), (n, k), generator=gen)]
    x1, x2 = edges(32, mw)
    y1, y2 = edges(8, mh)
    return torch.stack([x1, y1, x2, y2], -1) * 4


@pytest.mark.parametrize(
    "pattern,n,mh,mw,k",
    [
        ("random", 4, 40, 40, 21),  # K not a multiple of 8
        ("random", 8, 160, 160, 300),
        ("all_dead", 4, 40, 40, 300),  # n_active = 0
        ("scattered", 4, 160, 160, 300),
        ("off_map", 4, 40, 40, 130),
        ("tile_edges", 3, 40, 72, 64),  # boxes cut the tiles in rows and columns
        ("random", 3, 20, 24, 13),  # map not a multiple of the tile
        ("random", 3, 9, 9, 5),
    ],
)
def test_mma_kernel_within_bound(cuda, pattern, n, mh, mw, k):
    proto, coef, boxes, keep = _case(k + n, n, mh, mw, k,
                                     "random" if pattern == "tile_edges" else pattern,
                                     torch.bfloat16, cuda)
    coef = coef.to(torch.bfloat16)
    if pattern == "tile_edges":
        boxes = _tile_edge_boxes(torch.Generator().manual_seed(k), n, k, mh, mw).to(cuda)
    assert mu.kernel_inputs(proto, coef, boxes, keep)[0] == "mma"
    before = mu.LAUNCHES
    got = mu.mask_union_logits_batch(proto, coef, boxes, keep)
    torch.cuda.synchronize()
    assert mu.LAUNCHES == before + 1
    want = mu.mask_union_logits_ref(proto, coef, boxes, keep)
    bound = mu.union_error_bound(proto, coef, boxes, keep)
    assert bool(((got - want).abs() <= bound).all())
    assert bool((got[bound == 0] == mu._NEG).all())
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


# --------------------------------------------------------------------------
# CLAHE tile LUTs
# --------------------------------------------------------------------------


def _edge_tiles(th, tw, gen):
    """One-tile images [k, th, tw] of the edge cases, and each one's clip
    limit: constant, two-valued, clipped excess of exactly 512 (residual
    0), every bin above its limit (clip 0.1), and random."""
    area = th * tw
    limit = max(int(2.0 * area / 256), 1)
    big = 512 + limit
    cases = [
        (torch.full((area,), 131), 2.0),
        (torch.where(torch.rand(area, generator=gen) < 0.3, 17, 240), 2.0),
        (torch.cat([torch.full((big,), 60), 61 + torch.arange(area - big) % 190]), 2.0),
        (torch.cat([torch.arange(256), torch.arange(256),
                    torch.randint(0, 256, (area - 512,), generator=gen)]), 0.1),
        (torch.randint(0, 256, (area,), generator=gen), 2.0),
    ]
    return [(pix[torch.randperm(area, generator=gen)].reshape(1, th, tw).to(torch.uint8), c)
            for pix, c in cases]


@pytest.mark.parametrize("hw", [(182, 218), (182, 182), (218, 182), (24, 28)])
def test_clahe_kernel_equals_plain(cuda, hw):
    gen = torch.Generator().manual_seed(hw[0] * hw[1])
    imgs = torch.randint(0, 256, (8,) + hw, generator=gen, dtype=torch.uint8).to(cuda)
    before = clahe.LAUNCHES
    got = clahe.clahe_tile_luts(imgs)
    torch.cuda.synchronize()
    assert clahe.LAUNCHES == before + 1
    assert got.shape == (8, 64, 256) and got.dtype == torch.float32
    assert torch.equal(got, clahe.clahe_tile_luts_ref(imgs))
    th, tw, area, limit = clahe.tile_geometry(*hw)
    if area < 512 + limit:  # too small a tile for the edge cases
        return
    for tile, clip in _edge_tiles(th, tw, gen):
        tile = tile.to(cuda)
        got = clahe.clahe_tile_luts(tile, clip, 1, 1)
        assert torch.equal(got, clahe.clahe_tile_luts_ref(tile, clip, 1, 1))


def _clahe_images(kind, n, h, w, gen):
    """uint8 images [n, h, w]: uniform noise, noise inside a centred disc of
    half the area on zeros (background-heavy, as a FLAIR slice), or one
    value."""
    if kind == "constant":
        return torch.full((n, h, w), 131, dtype=torch.uint8)
    imgs = torch.randint(0, 256, (n, h, w), generator=gen, dtype=torch.uint8)
    if kind == "background":
        yy, xx = torch.meshgrid(torch.arange(h), torch.arange(w), indexing="ij")
        inside = (yy - h / 2) ** 2 + (xx - w / 2) ** 2 < 0.5 * h * w / torch.pi
        imgs = imgs * inside
    return imgs


CLAHE_CASES = [  # (kind, n, h, w, tiles_x, tiles_y)
    *[(kind, 6, h, w, 8, 8) for kind in ("random", "background", "constant")
      for h, w in ((182, 218), (182, 182), (218, 182))],
    ("random", 3, 45, 230, 16, 4),  # two tiles a warp
    ("background", 2, 37, 300, 20, 3),  # tiles_x not a multiple of the warps
    ("random", 3, 70, 41, 3, 7),  # tiles_x != tiles_y
    ("random", 5, 9, 11, 8, 8),  # 2 px tiles, bands past the image, 495 bytes
    ("random", 3, 23, 28, 1, 1),
]


@pytest.mark.parametrize("kind,n,h,w,tiles_x,tiles_y", CLAHE_CASES)
def test_clahe_kernels_equal_plain_on_image_kinds(cuda, kind, n, h, w, tiles_x, tiles_y):
    gen = torch.Generator().manual_seed(n * h * w + tiles_x)
    imgs = _clahe_images(kind, n, h, w, gen).to(cuda)
    before = clahe.LAUNCHES, clahe.BLEND_LAUNCHES
    luts = clahe.clahe_tile_luts(imgs, 2.0, tiles_x, tiles_y)
    torch.cuda.synchronize()
    assert clahe.LAUNCHES == before[0] + 1
    assert luts.shape == (n, tiles_x * tiles_y, 256) and luts.dtype == torch.float32
    want = clahe.clahe_tile_luts_ref(imgs, 2.0, tiles_x, tiles_y)
    assert torch.equal(luts, want)
    for out_map in (torch.from_numpy(enhance._LAB_BWD), torch.arange(256).flip(0)):
        out_map = out_map.to(cuda, torch.uint8)
        got = clahe.clahe_blend(imgs, luts, out_map, tiles_x, tiles_y)
        torch.cuda.synchronize()
        assert got.shape == imgs.shape and got.dtype == torch.uint8
        assert torch.equal(got, clahe.clahe_blend_ref(imgs, want, out_map, tiles_x, tiles_y))
    assert clahe.BLEND_LAUNCHES == before[1] + 2


def test_clahe_kernels_take_an_unaligned_view(cuda):
    """A view that starts off a 16-byte boundary (an image of 9 x 11 px)."""
    gen = torch.Generator().manual_seed(5)
    imgs = torch.randint(0, 256, (4, 9, 11), generator=gen, dtype=torch.uint8).to(cuda)[1:]
    assert imgs.data_ptr() % 16 != 0
    luts = clahe.clahe_tile_luts(imgs)
    assert torch.equal(luts, clahe.clahe_tile_luts_ref(imgs))
    out_map = torch.from_numpy(enhance._LAB_BWD).to(cuda)
    got = clahe.clahe_blend(imgs, luts, out_map)
    assert torch.equal(got, clahe.clahe_blend_ref(imgs, luts, out_map))


def test_clahe_enhancement_on_the_card_equals_the_cpu(cuda):
    gen = torch.Generator().manual_seed(3)
    slices = torch.randn((4, 182, 218), generator=gen) * 150 + 500
    slices[1] = 7.0
    want = enhance.enhance_for_model(slices, "CLAHE")  # the plain version
    before = clahe.LAUNCHES, clahe.BLEND_LAUNCHES
    got = enhance.enhance_for_model(slices.to(cuda), "CLAHE")
    assert (clahe.LAUNCHES, clahe.BLEND_LAUNCHES) == (before[0] + 1, before[1] + 1)
    assert torch.equal(got.cpu(), want)


def test_clahe_wrapper_checks_its_inputs(cuda):
    imgs = torch.zeros((2, 32, 32), dtype=torch.uint8)
    with pytest.raises(ValueError, match="no kernel"):
        clahe.clahe_tile_luts(imgs.to("meta"))
    with pytest.raises(TypeError):
        clahe.clahe_tile_luts(imgs.to(cuda, torch.float32))
    with pytest.raises(ValueError):
        clahe.clahe_tile_luts(imgs[0].to(cuda))
    with pytest.raises(ValueError):
        clahe.clahe_tile_luts(imgs.to(cuda), tiles_x=40)


def test_clahe_blend_wrapper_checks_its_inputs(cuda):
    imgs = torch.zeros((2, 32, 32), dtype=torch.uint8, device=cuda)
    luts = torch.zeros((2, 64, 256), device=cuda)
    out_map = torch.arange(256, device=cuda).to(torch.uint8)
    with pytest.raises(ValueError, match="no kernel"):
        clahe.clahe_blend(imgs.to("meta"), luts.to("meta"), out_map.to("meta"))
    with pytest.raises(TypeError):
        clahe.clahe_blend(imgs.float(), luts, out_map)
    with pytest.raises(ValueError):
        clahe.clahe_blend(imgs[0], luts, out_map)
    with pytest.raises(ValueError):
        clahe.clahe_blend(imgs, luts[:, :32], out_map)
    with pytest.raises(ValueError):
        clahe.clahe_blend(imgs, luts.double(), out_map)
    with pytest.raises(ValueError):
        clahe.clahe_blend(imgs, luts.cpu(), out_map)
    with pytest.raises(ValueError):
        clahe.clahe_blend(imgs, luts, out_map.long())
    before = clahe.BLEND_LAUNCHES
    clahe.clahe_blend(imgs, luts, out_map)
    assert clahe.BLEND_LAUNCHES == before + 1


# --------------------------------------------------------------------------
# fused stem
# --------------------------------------------------------------------------


def _stem_case(dtype, dev, seed=0):
    model, _ = create_model(nc=1, scale="n", dtype=dtype)
    sd = fold_gray_stem(init_variables(model, seed))
    gen = torch.Generator().manual_seed(seed + 1)
    for b in ("model.0", "model.1"):  # BN statistics away from identity
        n = sd[f"{b}.bn.weight"].numel()
        sd[f"{b}.bn.running_mean"] = torch.randn(n, generator=gen) * 0.2 + 0.3
        sd[f"{b}.bn.running_var"] = torch.rand(n, generator=gen) * 1.5 + 0.5
        sd[f"{b}.bn.bias"] = torch.randn(n, generator=gen) * 0.3 + 0.1
    return model, stem.stem_weights({k: v.to(dev) for k, v in sd.items()})




@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("size", [64, 256, 96])
def test_stem_kernel_matches_plain(cuda, dtype, size):
    model, w = _stem_case(dtype, cuda)
    x = torch.rand((5, size, size), generator=torch.Generator().manual_seed(size)).to(cuda, dtype)
    before = stem.LAUNCHES
    got = stem.stem_apply(model, w, x)
    torch.cuda.synchronize()
    assert stem.LAUNCHES == before + 1
    want = stem.stem_reference(model, w, x)
    assert got.shape == want.shape == (5, 32, size // 4, size // 4)
    assert got.dtype == dtype and got.is_contiguous(memory_format=torch.channels_last)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)
    else:
        bound = stem.bf16_error_bound(model, w, x, want)
        assert bool(((got.float() - want.float()).abs() <= bound).all())


def test_stem_wrapper_checks_its_inputs(cuda):
    model, w = _stem_case(torch.float32, cuda)
    x = torch.zeros((2, 64, 64), device=cuda)
    with pytest.raises(ValueError, match="no kernel"):
        stem.stem_apply(model, w, x.to("meta"))
    with pytest.raises(TypeError):
        stem.stem_apply(model, w, x.half())
    with pytest.raises(ValueError):
        stem.stem_apply(model, w, x[:, :62, :62])
    with pytest.raises(ValueError):
        stem.stem_apply(model, {k: v.cpu() for k, v in w.items()}, x)
