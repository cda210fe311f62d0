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
# both directions
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
