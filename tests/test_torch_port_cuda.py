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
running mean cancels most of it that ulp exceeds the output's); the Conv
block's fused BN + SiLU within one ulp of the stored type (bit-equal is
the aim: the kernel copies the plain version's roundings; each case prints
how many elements differ); a float32 ``lote`` under PyTorch's default TF32
flags exactly as with TF32 off; NMS's suppression kernel bit for bit (it
rounds each IoU as the plain ``box_iou_matrix`` does and computes the
fixpoint's greedy result).
"""

import contextlib

import numpy as np
import pytest
import torch

from tpu_mslesseg_torch.infer import mask_union as mu
from tpu_mslesseg_torch.infer import nms
from tpu_mslesseg_torch.model import blocks, bn_act, stem
from tpu_mslesseg_torch.model.yolo11 import create_model, fold_gray_stem, init_variables
from tpu_mslesseg_torch.preproc import clahe, enhance
from tpu_mslesseg_torch.tools import nms_cases

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


BLEND_SHAPES = [(182, 218), (182, 182), (218, 182), (37, 200)]  # the last: w % 16 = 8


@pytest.mark.parametrize("kind", ["random", "background"])
@pytest.mark.parametrize("n", [1, 50, 200])
@pytest.mark.parametrize("hw", BLEND_SHAPES)
def test_clahe_blend_equals_plain_at_cluster_edges(cuda, hw, n, kind):
    """The blend (a cluster of CTAs an image, each a share of its rows and
    of its LUT rows) exactly as the plain version at the plane shapes and a
    width that is not a multiple of 16, at 1, 50 and 200 images."""
    gen = torch.Generator().manual_seed(n * hw[0] + hw[1])
    imgs = _clahe_images(kind, n, *hw, gen).to(cuda)
    luts = clahe.clahe_tile_luts_ref(imgs)
    out_map = torch.from_numpy(enhance._LAB_BWD).to(cuda)
    before = clahe.BLEND_LAUNCHES
    got = clahe.clahe_blend(imgs, luts, out_map)
    torch.cuda.synchronize()
    assert clahe.BLEND_LAUNCHES == before + 1
    assert torch.equal(got, clahe.clahe_blend_ref(imgs, luts, out_map))


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


def _stem_case(dtype, dev, seed=0, scale="n"):
    model, _ = create_model(nc=1, scale=scale, dtype=dtype)
    sd = fold_gray_stem(init_variables(model, seed))
    gen = torch.Generator().manual_seed(seed + 1)
    for b in ("model.0", "model.1"):  # BN statistics away from identity
        n = sd[f"{b}.bn.weight"].numel()
        sd[f"{b}.bn.running_mean"] = torch.randn(n, generator=gen) * 0.2 + 0.3
        sd[f"{b}.bn.running_var"] = torch.rand(n, generator=gen) * 1.5 + 0.5
        sd[f"{b}.bn.bias"] = torch.randn(n, generator=gen) * 0.3 + 0.1
    return model, stem.stem_weights({k: v.to(dev) for k, v in sd.items()
                                     if k.startswith(("model.0.", "model.1."))})


_SCALES = [("n", 32), ("s", 64), ("m", 128), ("l", 128), ("x", 192)]
# (m, h, w): square sizes (200: 50 x 50 positions, ragged tiles) in both
# types at every scale; then the wider instances of both types at the full
# width of 640, and on a non-square input with an odd image count, ragged in
# both directions; then scale n's f32 instance at both
_STEM_CASES = [
    (dtype, (5, size, size), scale, c1)
    for scale, c1 in _SCALES for size in (64, 256, 96, 200)
    for dtype in (torch.float32, torch.bfloat16)
] + [
    (torch.float32, (2, 640, 640), scale, c1) for scale, c1 in _SCALES if scale in "smx"
] + [
    (torch.float32, (3, 96, 200), scale, c1) for scale, c1 in _SCALES if scale != "n"
] + [
    (torch.bfloat16, (2, 640, 640), scale, c1) for scale, c1 in _SCALES if scale in "smx"
] + [
    (torch.bfloat16, (3, 96, 200), scale, c1) for scale, c1 in _SCALES if scale != "n"
] + [
    (torch.float32, shape, "n", 32) for shape in ((2, 640, 640), (3, 96, 200))
]


@pytest.mark.parametrize("dtype,shape,scale,c1", _STEM_CASES)
def test_stem_kernel_matches_plain(cuda, dtype, shape, scale, c1):
    model, w = _stem_case(dtype, cuda, scale=scale)
    assert stem.instance_of(w)[1] == c1
    m, h, wd = shape
    x = torch.rand(shape, generator=torch.Generator().manual_seed(h + wd)).to(cuda, dtype)
    before = stem.LAUNCHES
    got = stem.stem_apply(model, w, x)
    torch.cuda.synchronize()
    assert stem.LAUNCHES == before + 1
    want = stem.stem_reference(model, w, x)
    assert got.shape == want.shape == (m, c1, h // 4, wd // 4)
    assert got.dtype == dtype and got.is_contiguous(memory_format=torch.channels_last)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)
    else:
        bound = stem.bf16_error_bound(model, w, x, want)
        assert bool(((got.float() - want.float()).abs() <= bound).all())


def test_stem_bf16_activation_is_exact_on_every_f32_input(cuda):
    assert stem.bf16_activation_mismatches(cuda) == 0


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


def test_stem_without_an_instance_raises_on_the_card(cuda):
    model, w = _stem_case(torch.float32, cuda)
    narrow = dict(w)
    for leaf in ("conv.weight", "bn.weight", "bn.bias", "bn.running_mean", "bn.running_var"):
        narrow[f"model.0.{leaf}"] = w[f"model.0.{leaf}"][:8].contiguous()
    narrow["model.1.conv.weight"] = w["model.1.conv.weight"][:, :8].contiguous()
    before = stem.LAUNCHES
    with pytest.raises(RuntimeError, match="no kernel instance"):
        stem.stem_apply(model, narrow, torch.zeros((1, 64, 64), device=cuda))
    assert stem.LAUNCHES == before


# --------------------------------------------------------------------------
# the Conv block's eval epilogue (BN + SiLU)
# --------------------------------------------------------------------------


def _bn_case(c, seed, dev):
    """A BatchNorm2d (eps 1e-3) on `dev` away from its init; a third of the
    variances under eps, as trained ones can be."""
    gen = torch.Generator().manual_seed(seed)
    bn = torch.nn.BatchNorm2d(c, eps=1e-3).eval()
    var = torch.rand(c, generator=gen) * 3 + 1e-2
    var[::3] = torch.rand(c, generator=gen)[::3] * 1e-4
    with torch.no_grad():
        bn.running_mean.copy_(torch.randn(c, generator=gen) * 2)
        bn.running_var.copy_(var)
        bn.weight.copy_(1 + 0.3 * torch.randn(c, generator=gen))
        bn.bias.copy_(0.5 * torch.randn(c, generator=gen))
    return bn.to(dev)


def _ulps(got, want):
    """|got - want| in units of the last place of the stored type, at the
    larger magnitude of the two."""
    bits = 7 if want.dtype == torch.bfloat16 else 23
    g, w = got.float(), want.float()
    _, e = torch.frexp(torch.maximum(g.abs(), w.abs()))
    ulp = torch.ldexp(torch.ones_like(w), (e - 1 - bits).clamp(min=-126 - bits))
    return (g - w).abs() / ulp


# (n, c, h, w, storage offset in elements): the model's narrowest and widest
# channels at its largest and smallest maps; a total size that is not a
# multiple of 8; an offset that breaks 16-byte alignment
_BN_ACT_SHAPES = [(4, 8, 320, 320, 0), (3, 256, 20, 20, 0), (2, 32, 160, 160, 0),
                  (2, 256, 160, 160, 0), (3, 12, 7, 9, 0), (2, 64, 20, 20, 3)]


@pytest.mark.parametrize("n,c,h,w,offset", _BN_ACT_SHAPES)
@pytest.mark.parametrize("act", [True, False])
@pytest.mark.parametrize("fmt", ["channels_last", "nchw"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_bn_act_kernel_matches_plain(cuda, dtype, fmt, act, n, c, h, w, offset):
    gen = torch.Generator().manual_seed(c * h + offset)
    flat = (torch.randn(n * c * h * w + offset, generator=gen) * 4).to(cuda, dtype)[offset:]
    y = (flat.view(n, h, w, c).permute(0, 3, 1, 2) if fmt == "channels_last"
         else flat.view(n, c, h, w))
    assert bn_act.layout(y) == fmt
    bn = _bn_case(c, c + h, cuda)
    want = bn_act.bn_act_ref(y, bn, act)
    before = bn_act.LAUNCHES
    got = bn_act.bn_act(y, bn, act)
    torch.cuda.synchronize()
    assert bn_act.LAUNCHES == before + 1
    assert got.data_ptr() == y.data_ptr() and got.dtype == dtype  # in place
    differing = int((got.view(torch.int16 if dtype == torch.bfloat16 else torch.int32)
                     != want.view(torch.int16 if dtype == torch.bfloat16 else torch.int32))
                    .sum())
    worst = float(_ulps(got, want).max())
    print(f"bn_act {dtype} {fmt} act={act} {(n, c, h, w)} offset {offset}: "
          f"{differing} of {got.numel()} elements differ, at most {worst} ulp")
    assert worst <= 1.0


@pytest.mark.parametrize("act", [True, False])
def test_bn_act_kernel_matches_plain_without_cudnn(cuda, act):
    """With cuDNN off, the plain version's batch norm is ATen's on a
    channels-last input too, and so is the kernel's arithmetic."""
    gen = torch.Generator().manual_seed(7)
    y = (torch.randn((2, 64, 40, 40), generator=gen) * 4).to(cuda)
    y = y.contiguous(memory_format=torch.channels_last)
    bn = _bn_case(64, 8, cuda)
    with torch.backends.cudnn.flags(enabled=False):
        want = bn_act.bn_act_ref(y, bn, act)
        got = bn_act.bn_act(y, bn, act)
    torch.cuda.synchronize()
    assert float(_ulps(got, want).max()) <= 1.0


def test_bn_act_kernel_writes_into_out(cuda):
    gen = torch.Generator().manual_seed(11)
    y = (torch.randn((2, 256, 20, 20), generator=gen) * 4).to(cuda, torch.bfloat16)
    y = y.contiguous(memory_format=torch.channels_last)
    bn = _bn_case(256, 12, cuda)
    keep = y.clone()
    out = torch.empty_like(y)
    got = bn_act.bn_act(y, bn, True, out=out)
    torch.cuda.synchronize()
    assert got.data_ptr() == out.data_ptr() and torch.equal(y, keep)
    assert float(_ulps(got, bn_act.bn_act_ref(y, bn, True)).max()) <= 1.0
    with pytest.raises(ValueError, match="out must be like y"):
        bn_act.bn_act(y, bn, True, out=torch.empty_like(y, memory_format=torch.contiguous_format))


def test_conv_eval_launches_the_bn_act_kernel_without_autograd(cuda):
    conv = blocks.Conv(16, 32, 3, 1).to(cuda)
    conv.bn = _bn_case(32, 9, cuda)
    x = torch.rand((2, 16, 40, 40), generator=torch.Generator().manual_seed(9)).to(cuda)
    x = x.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    before = bn_act.LAUNCHES
    with torch.inference_mode():
        got = conv(x)
    torch.cuda.synchronize()
    assert bn_act.LAUNCHES == before + 1
    with torch.enable_grad():
        plain = conv(x)  # autograd on: the plain version, no launch
    assert bn_act.LAUNCHES == before + 1 and plain.requires_grad
    assert torch.equal(got, plain.detach())


def test_bn_act_wrapper_checks_its_inputs(cuda):
    bn = _bn_case(8, 10, cuda)
    y = torch.zeros((2, 8, 4, 4), device=cuda)
    before = bn_act.LAUNCHES
    with pytest.raises(ValueError, match="BN terms"):  # terms off the activation's device
        bn_act.bn_act(y, bn.cpu(), True)
    bn = bn.to(cuda)
    with pytest.raises(ValueError, match="channels-last or NCHW"):
        bn_act.bn_act(y[:, :, :, :2], bn, True)
    with pytest.raises(TypeError):
        bn_act.bn_act(y.half(), bn, True)
    with pytest.raises(ValueError):
        bn_act.bn_act(y[:, :4].contiguous(), bn, True)  # 4 channels against 8 terms
    assert bn_act.LAUNCHES == before
    cpu = bn_act.bn_act(y.cpu(), bn.cpu(), True)  # a CPU tensor: the plain version
    assert bn_act.LAUNCHES == before and cpu.device.type == "cpu"


# --------------------------------------------------------------------------
# NMS's suppression
# --------------------------------------------------------------------------


def _nms_case(name):
    """-> (boxes, scores, conf, iou) as numpy, max_det 300"""
    if name == "served_shape":  # one plane of a served dispatch
        return (*nms_cases.clustered(0, 200, 8400), 0.25, 0.7)
    if name.startswith("chain_"):
        return (*nms_cases.chain(int(name[6:]), 8400), 0.25, 0.7)
    if name == "ties_partly_valid":
        return (*nms_cases.clustered(1, 16, 400), 0.25, 0.7)
    if name == "distinct_scores":
        return (*nms_cases.clustered(2, 16, 400, ties=False), 0.25, 0.7)
    if name == "k_below_max_det":
        return (*nms_cases.clustered(3, 16, 50), 0.25, 0.7)
    if name == "conf_0.001":
        return (*nms_cases.clustered(4, 50, 8400), 0.001, 0.7)
    if name == "none_valid":
        return (*nms_cases.clustered(5, 4, 400), 0.9999, 0.7)
    if name.startswith("threshold_"):
        thr = float(name[10:])
        boxes, scores, _ = nms_cases.threshold_pairs(thr, 30, 7)
        return boxes, scores, 0.25, thr
    raise KeyError(name)


@pytest.mark.parametrize("name", ["served_shape", "chain_40", "chain_250", "ties_partly_valid",
                                  "distinct_scores", "k_below_max_det", "conf_0.001",
                                  "none_valid", "threshold_0.7", "threshold_0.3",
                                  "threshold_0.45"])
def test_nms_kernel_matches_plain(cuda, name, monkeypatch):
    """``nms_batch`` on the card through the kernel against the same call
    with the plain suppression on the card: keep, indices, boxes and scores
    bit for bit. The threshold pairs decide how the plain version compares
    ``iou > iou_thres``: at 0.3 float32 rounds the threshold up, so a
    comparison in float64 would suppress the pairs at it."""
    boxes, scores, conf, iou = _nms_case(name)
    boxes, scores = torch.from_numpy(boxes).to(cuda), torch.from_numpy(scores).to(cuda)
    before = nms.LAUNCHES
    got = nms.nms_batch(boxes, scores, conf, iou, 300)
    torch.cuda.synchronize()
    assert nms.LAUNCHES == before + 1
    monkeypatch.setattr(nms, "suppress", nms.suppress_ref)
    want = nms.nms_batch(boxes, scores, conf, iou, 300)
    assert nms.LAUNCHES == before + 1
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    if name.startswith("threshold_"):
        t = np.float32(iou)
        _, _, ious = nms_cases.threshold_pairs(iou, 30, 7)
        np.testing.assert_array_equal(got[2][0, 1:60:2].cpu().numpy(), ious <= t)


@pytest.mark.parametrize("k", [1, 31, 32, 33, 300, 1024])
def test_nms_kernel_matches_plain_at_every_k(cuda, k):
    """The kernel's words and shared-memory layout at K around a word's
    edge, at the callers' 300 and at the limit, 1,024 (157 KB of shared
    memory, past the default 48 KB), conf 0.001."""
    boxes, scores = nms_cases.clustered(k, 8, max(k, 2), objects=4)
    top = torch.from_numpy(boxes[:, :k]).to(cuda)
    valid = torch.from_numpy(scores[:, :k] > 0.001).to(cuda)
    got = nms.suppress(top, valid, 0.7)
    want = nms.suppress_ref(top, valid, 0.7)
    assert torch.equal(got, want)
    if k > 1:
        assert bool(got.any()) and not bool(got.all())


@pytest.mark.parametrize("b,k", [(1, 300), (50, 300), (200, 300), (600, 300), (50, 1),
                                 (50, 63), (50, 64), (50, 65), (50, 1024)])
def test_nms_kernel_matches_plain_at_cluster_and_tile_edges(cuda, b, k):
    """The kernel (a cluster of CTAs an image, 32 x 32 tiles of the lower
    triangle spread over its warps) bit for bit as ``suppress_ref`` at 1 to
    600 images and at K around a tile's edge and at the limit, on
    served-like clusters at conf 0.25 (at K = 1,024 conf 0.001, so that
    every row block holds valid candidates)."""
    boxes, scores = nms_cases.clustered(b + k, b, max(2000, k), objects=8)
    conf = 0.001 if k == 1024 else 0.25
    order = np.argsort(-scores, axis=1, kind="stable")[:, :k]
    top = torch.from_numpy(np.take_along_axis(boxes, order[..., None], 1)).to(cuda)
    valid = torch.from_numpy(np.take_along_axis(scores, order, 1) > conf).to(cuda)
    before = nms.LAUNCHES
    got = nms.suppress(top.contiguous(), valid.contiguous(), 0.7)
    torch.cuda.synchronize()
    assert nms.LAUNCHES == before + 1
    assert torch.equal(got, nms.suppress_ref(top, valid, 0.7))
    if k > 1:
        assert bool(got.any()) and not bool(got.all())


def test_nms_on_the_card_makes_no_host_sync(cuda):
    """Under ``torch.cuda.set_sync_debug_mode("error")`` a synchronising
    call raises: ``nms_batch`` through the kernel makes none; through the
    plain version, which reads a bool back each step, it raises."""
    boxes, scores, conf, iou = _nms_case("served_shape")
    boxes, scores = torch.from_numpy(boxes).to(cuda), torch.from_numpy(scores).to(cuda)
    nms.nms_batch(boxes, scores, conf, iou, 300)  # built and loaded before the check
    torch.cuda.synchronize()
    try:
        torch.cuda.set_sync_debug_mode("error")
        nms.nms_batch(boxes, scores, conf, iou, 300)
        with pytest.MonkeyPatch.context() as mp, pytest.raises(RuntimeError, match="synchroniz"):
            mp.setattr(nms, "suppress", nms.suppress_ref)
            nms.nms_batch(boxes, scores, conf, iou, 300)
    finally:
        torch.cuda.set_sync_debug_mode(0)


def test_nms_wrapper_checks_its_inputs(cuda):
    boxes, scores = nms_cases.clustered(0, 2, 64)
    top = torch.from_numpy(boxes).to(cuda)
    valid = torch.from_numpy(scores > 0.25).to(cuda)
    before = nms.LAUNCHES
    with pytest.raises(ValueError, match="valid on cpu"):
        nms.suppress(top, valid.cpu(), 0.7)
    with pytest.raises(TypeError):
        nms.suppress(top.half(), valid, 0.7)
    with pytest.raises(ValueError, match=f"at most {nms.MAX_K}"):
        over = nms.MAX_K + 1
        nms.suppress(torch.zeros((1, over, 4), device=cuda),
                     torch.ones((1, over), dtype=torch.bool, device=cuda), 0.7)
    assert nms.LAUNCHES == before
    # a strided view, and a contiguous one off a 16-byte boundary, are copied
    # first
    flat = torch.zeros(1 + top[:, :40].numel(), device=cuda)
    flat[1:] = top[:, :40].reshape(-1)
    for view in (top[:, 1:41], flat[1:].view(2, 40, 4)):
        assert torch.equal(nms.suppress(view, valid[:, 1:41], 0.7),
                           nms.suppress_ref(view, valid[:, 1:41], 0.7))
    assert flat[1:].data_ptr() % 16 and nms.LAUNCHES == before + 2
    empty = nms.suppress(top[:0], valid[:0], 0.7)
    assert tuple(empty.shape) == (0, 64) and nms.LAUNCHES == before + 2


def test_lote_launches_the_nms_kernel_once_a_call(cuda, monkeypatch):
    """``ConsensusPredictor.lote`` (GC, imgsz 320, one patient, 8 slices a
    plane, a plane's own weights) launches the kernel once for each
    ``nms_batch`` call, one a plane."""
    from tpu_mslesseg_torch.bench import workload
    from tpu_mslesseg_torch.infer import predictor
    from tpu_mslesseg_torch.infer.consensus3 import ConsensusPredictor

    size = workload.Size(vol_shape=(64, 72, 64), serve_patients=("P39",), per_plane=8, short=8,
                         serve_lesion=(slice(20, 40), slice(25, 45), slice(20, 40)))
    slices, idx, gts = workload.serving_group(0, size)
    model, _ = create_model(nc=1, scale="n", dtype=torch.bfloat16)
    cp = ConsensusPredictor(model, workload.plane_weights(model, 0, base=10), size.vol_shape,
                            mejora="GC", imgsz=320, umbral=2, per_plane_counts=True, device=cuda)
    calls = []

    def counted(*a, **kw):
        calls.append(nms.LAUNCHES)
        return nms.nms_batch(*a, **kw)

    monkeypatch.setattr(predictor, "nms_batch", counted)
    before = nms.LAUNCHES
    cp.lote(slices, idx, gts)
    torch.cuda.synchronize()
    assert len(calls) == 3 and calls == [before, before + 1, before + 2]
    assert nms.LAUNCHES == before + 3


# --------------------------------------------------------------------------
# the train step
# --------------------------------------------------------------------------


def test_train_step_on_the_card_matches_the_cpu(cuda):
    """Five f32 micro-steps (three applies) at imgsz 64 from the same weights
    on the same batches, on the card and on the CPU. The ellipses span a
    third of the image and more, so every loss part is above 0.1 and is held
    at rtol 1e-3; the bias group warms from 0 (from 0.1, AdamW turns the
    sign of a rounding-noise gradient into a step of 0.1 and the runs part
    ways on any two devices), and every parameter's update (after minus
    initial) is within 10% of its leaf's largest update on at least 99% of
    the leaf's elements, three BatchNorm biases with a noise gradient left
    out."""
    from tpu_mslesseg_torch.tools.train_batches import synthetic_batch
    from tpu_mslesseg_torch.train import trainer

    noise = ("model.10.m.0.attn.pe.bn.bias", "model.10.m.0.attn.proj.bn.bias",
             "model.10.m.0.ffn.1.bn.bias")
    cfg = trainer.TrainConfig(batch_size=2, imgsz=64, max_fg=8, seed=1, warmup_bias_lr=0.0)
    batches = [synthetic_batch(200 + i, 2, 64, 4, max_valid=2, size=(0.3, 0.7))
               for i in range(5)]
    rows, init, last = {}, {}, {}
    for where in (cuda, torch.device("cpu")):
        model, _ = create_model(nc=1, scale="n")
        state = trainer.init_train_state(model, cfg, 4, device=where)
        assert state.device.type == where.type
        init[where.type] = {k: v.detach().cpu().clone() for k, v in model.named_parameters()}
        rows[where.type] = [trainer.train_step(state, b) for b in batches]
        assert all(v.device.type == where.type for v in rows[where.type][0].values()
                   if isinstance(v, torch.Tensor))
        assert state.applies == 3 and state.step == 5
        last[where.type] = {k: v.detach().cpu() for k, v in model.named_parameters()}
    for got, want in zip(rows["cuda"], rows["cpu"]):
        for k in ("loss", "box", "seg", "cls", "dfl"):
            assert float(want[k]) > 0.1
            assert float(got[k]) == pytest.approx(float(want[k]), rel=1e-3)
    held = 0
    for k, first in init["cpu"].items():
        assert torch.equal(first, init["cuda"][k])
        if k in noise:
            continue
        d_cpu, d_card = last["cpu"][k] - first, last["cuda"][k] - first
        top = float(d_cpu.abs().max())
        if top < 1e-6:  # a level without foreground: decay alone
            continue
        held += 1
        assert bool(torch.isfinite(d_card).all())
        off = float(((d_card - d_cpu).abs() > 0.1 * top).float().mean())
        assert off <= 0.01, (k, off, top)
    assert held > 200


def test_train_state_defaults_to_the_card(cuda):
    from tpu_mslesseg_torch.train import trainer

    model, _ = create_model(nc=1, scale="n")
    state = trainer.init_train_state(model, trainer.TrainConfig(imgsz=64, batch_size=2), 4)
    assert state.device.type == "cuda"


def test_a_fold_parallel_micro_step_on_the_card_matches_the_cpu(cuda):
    """Two folds' first micro-steps (``fold_parallel.fold_step``) from their
    seeded states on a shared pool on the card and on the CPU: the same
    draws (the fold's generator lives on the host), f32 loss parts within
    rtol 1e-3, as the single step above."""
    import numpy as np

    from tpu_mslesseg_torch.train import augment, fold_parallel, trainer

    rng = np.random.default_rng(4)
    m, h, w = 12, 48, 40
    data = {"images": rng.integers(0, 255, (m, h, w)).astype(np.uint8),
            "instmaps": np.zeros((m, h, w), np.uint8), "boxes": np.zeros((m, 4, 4), np.float32),
            "valid": np.zeros((m, 4), bool)}
    for i in range(m):
        data["instmaps"][i, 8:30, 6:28] = 1
        data["images"][i, 8:30, 6:28] = 230
        data["boxes"][i, 0] = (6, 8, 28, 30)
        data["valid"][i, 0] = True
    meta = [(("P1", "P30")[i % 2], "FLAIR", i) for i in range(m)]
    from tpu_mslesseg_torch.pipeline.paciente import calcular_fold

    pools, counts = fold_parallel.build_fold_index_pools(meta, 2, calcular_fold)
    cfg = trainer.TrainConfig(batch_size=2, imgsz=64, max_fg=8, warmup_bias_lr=0.0)
    acfg = augment.AugConfig(imgsz=64, max_inst=4)
    rows = {}
    for where in (cuda, torch.device("cpu")):
        model, _ = create_model(nc=1, scale="n")
        states = fold_parallel.init_multi_fold_state(model, cfg, 2, [0, 1], device=where)
        dd = {k: torch.from_numpy(v).to(where) for k, v in data.items()}
        rows[where.type] = [fold_parallel.fold_step(st, pools[f], counts[f], dd, acfg)
                            for f, st in states.items()]
        assert all(st.step == 1 and st.device.type == where.type for st in states.values())
    for got, want in zip(rows["cuda"], rows["cpu"]):
        for k in ("loss", "box", "seg", "cls", "dfl"):
            assert np.isfinite(float(want[k])) and float(want[k]) > 0
            assert float(got[k]) == pytest.approx(float(want[k]), rel=1e-3)


# --------------------------------------------------------------------------
# float32 means float32: the program scopes TF32 off itself
# --------------------------------------------------------------------------


@pytest.fixture
def default_flags():
    """PyTorch's default TF32 flags for the test (cuDNN's on, the matrix
    products' off), the process's own put back after it: the `cuda`
    fixture turns TF32 off for good."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: TF32 exists on the card only")
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = True, False
    yield torch.device("cuda")
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def test_f32_lote_under_default_flags_equals_it_with_tf32_off(default_flags):
    """One float32 ``ConsensusPredictor.lote`` (GC, imgsz 320, one patient,
    8 slices a plane) with PyTorch's default flags equals, head output for
    head output and voxel for voxel, the same call with TF32 off for the
    whole process; inside the model cuDNN's TF32 flag reads False, and the
    caller's comes back. Without the program's scope the head outputs
    differ: TF32 is in use there."""
    from tpu_mslesseg_torch.bench import workload
    from tpu_mslesseg_torch.infer.consensus3 import ConsensusPredictor
    from tpu_mslesseg_torch.model import yolo11

    size = workload.Size(vol_shape=(64, 72, 64), serve_patients=("P39",), per_plane=8, short=8,
                         serve_lesion=(slice(20, 40), slice(25, 45), slice(20, 40)))
    slices, idx, gts = workload.serving_group(0, size)
    model, _ = create_model(nc=1, scale="n", dtype=torch.float32)
    cp = ConsensusPredictor(model, workload.plane_weights(model, 0, base=10), size.vol_shape,
                            mejora="GC", imgsz=320, umbral=2, per_plane_counts=True,
                            device=default_flags)
    heads, inside = [], []

    def post(module, args, out):
        heads.append(torch.cat([out["proto"].flatten(), out["box"][0].flatten()]).clone())

    hooks = [cp.model.register_forward_hook(post), cp.model.model[0].register_forward_hook(
        lambda module, args, out: inside.append(torch.backends.cudnn.allow_tf32))]
    try:
        default = cp.lote(slices, idx, gts)
        assert torch.backends.cudnn.allow_tf32 is True and inside == [False] * 3
        torch.backends.cudnn.allow_tf32 = False
        off = cp.lote(slices, idx, gts)
        torch.backends.cudnn.allow_tf32 = True
        assert inside == [False] * 6
        with pytest.MonkeyPatch.context() as mp:  # the scope taken out
            mp.setattr(yolo11, "precision_of", lambda dtype: contextlib.nullcontext())
            cp.lote(slices, idx, gts)
    finally:
        for h in hooks:
            h.remove()
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(heads[:3], heads[3:6]))
    assert not all(torch.equal(a, b) for a, b in zip(heads[:3], heads[6:9]))
    (c0, x0, v0), (c1, x1, v1) = default, off
    assert torch.equal(x0, x1) and all(torch.equal(v0[p], v1[p]) for p in v0)
    assert all(torch.equal(c0[k], c1[k]) for k in c0)
