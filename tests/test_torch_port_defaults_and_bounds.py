"""The port's serving defaults, the mask union's error bound and the union
wrapper's input preparation, on the CPU.

- ``ConsensusPredictor`` and ``SlicePredictor`` serve on CUDA unless the
  caller asks for another device (the CPU tests pass ``device="cpu"``).
- ``mask_union.union_error_bound`` bounds the plain version's f32 result
  against the exact dot products (float64 of the same bf16 inputs), and is
  0 exactly where no kept box holds the pixel.
- ``mask_union.kernel_inputs`` routes bf16 proto with bf16 coefficients to
  the tensor-core kernel and everything else to the FMA kernel, and computes
  each image's live-slot count.
- ``chip_smoke.py`` counts the bytes and operations of the work it bounds
  from the shapes and, for the union, from the pixels the kept boxes hold;
  its background-heavy CLAHE inputs are about half zeros;
  ``tools/kernel_ab.py``'s ablations still find their text in the stem and
  the CLAHE source, and its stem cases reach each scale's kernel instance
  and hold an output to the stem's tolerance.
"""

import inspect

import numpy as np
import pytest
import torch

from tpu_mslesseg_torch.infer import mask_union as mu
from tpu_mslesseg_torch.infer.consensus3 import ConsensusPredictor
from tpu_mslesseg_torch.infer.predictor import SlicePredictor
from tpu_mslesseg_torch.model.yolo11 import create_model


@pytest.mark.parametrize("cls", [ConsensusPredictor, SlicePredictor])
def test_predictors_serve_on_cuda_by_default(cls):
    assert inspect.signature(cls.__init__).parameters["device"].default == "cuda"


def _bf16_case(seed, n=3, mh=12, mw=20, k=17, scale=1.0):
    rng = np.random.default_rng(seed)
    proto = torch.from_numpy(rng.normal(size=(n, mh, mw, 32)) * scale).to(torch.bfloat16)
    coef = torch.from_numpy(rng.normal(size=(n, k, 32)) * scale).to(torch.bfloat16)
    x1 = rng.uniform(-8, 4 * mw, (n, k))
    y1 = rng.uniform(-8, 4 * mh, (n, k))
    boxes = np.stack([x1, y1, x1 + rng.uniform(1, 2 * mw, (n, k)),
                      y1 + rng.uniform(1, 2 * mh, (n, k))], -1)
    keep = torch.from_numpy(rng.uniform(size=(n, k)) > 0.4)
    keep[0] = False  # an image with nothing kept
    return proto, coef, torch.from_numpy(boxes.astype(np.float32)), keep


def _exact_union(proto, coef, boxes, keep, stride=4):
    """The union in float64 on the same (bf16) inputs, and where a kept box
    holds each pixel."""
    p = proto.double().numpy()
    c = coef.double().numpy()
    b = boxes.double().numpy() / stride
    kp = keep.numpy()
    n, mh, mw, _ = p.shape
    rows = np.arange(mh)[None, None, :, None]
    cols = np.arange(mw)[None, None, None, :]
    dots = np.einsum("nkc,nhwc->nkhw", c, p)
    x1, y1, x2, y2 = (b[..., i, None, None] for i in range(4))
    ok = (cols >= x1) & (cols < x2) & (rows >= y1) & (rows < y2) & kp[:, :, None, None]
    return np.where(ok, dots, mu._NEG).max(1), ok.any(1)


@pytest.mark.parametrize("seed,scale", [(0, 1.0), (1, 1.0), (2, 37.0), (3, 0.01)])
def test_union_error_bound_bounds_the_f32_sum(seed, scale):
    args = _bf16_case(seed, scale=scale)
    ref = mu.mask_union_logits_ref(*args).double().numpy()
    bound = mu.union_error_bound(*args).double().numpy()
    exact, held = _exact_union(*args)
    assert held.any() and not held.all()
    assert np.all(np.abs(ref - exact) <= bound)
    assert np.all(bound[~held] == 0.0) and np.all(bound[held] > 0.0)
    assert np.all(ref[~held] == mu._NEG)
    # the bound is a bound, not a guess: it holds with room on these inputs
    assert np.abs(ref - exact)[held].max() <= 0.5 * bound[held].max()


@pytest.mark.parametrize(
    "proto_dtype,coef_dtype,route",
    [
        (torch.bfloat16, torch.bfloat16, "mma"),
        (torch.bfloat16, torch.float32, "fma"),
        (torch.float32, torch.bfloat16, "fma"),
        (torch.float32, torch.float32, "fma"),
    ],
)
def test_kernel_inputs_route_by_dtype(proto_dtype, coef_dtype, route):
    proto, coef, boxes, keep = _bf16_case(5)
    proto, coef = proto.to(proto_dtype), coef.to(coef_dtype)
    got_route, c, b, kp, _ = mu.kernel_inputs(proto, coef, boxes.double(), keep)
    assert got_route == route
    assert c.dtype == (torch.bfloat16 if route == "mma" else torch.float32)
    assert c.is_contiguous() and torch.equal(c.float(), coef.float())
    assert b.dtype == torch.float32 and kp.dtype == torch.bool


def test_kernel_inputs_n_active_is_the_highest_kept_slot_plus_one():
    proto, coef, boxes, _ = _bf16_case(6, n=4, k=9)
    keep = torch.zeros((4, 9), dtype=torch.bool)
    keep[1, 0] = True
    keep[2, [2, 5]] = True
    keep[3, 8] = True
    *_, n_active = mu.kernel_inputs(proto, coef, boxes, keep.t().contiguous().t())
    assert n_active.dtype == torch.int32
    assert n_active.tolist() == [0, 1, 6, 9]


# --------------------------------------------------------------------------
# the bounds chip_smoke.py reports, and the kernel A/B tool's ablations
# --------------------------------------------------------------------------


def _chip_smoke():
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_under_test", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("dtype,route", [(torch.bfloat16, "mma"), (torch.float32, "fma")])
def test_union_work_counts_the_products_the_data_needs(dtype, route):
    cs = _chip_smoke()
    proto, coef, boxes, keep = _bf16_case(7, n=3, mh=12, mw=20, k=17)
    proto, coef = proto.to(dtype), coef.to(dtype)
    out = mu.mask_union_logits_ref(proto, coef, boxes, keep)
    work = cs.union_work(torch, mu, proto, coef, boxes, keep, 4, out)
    _, held = _exact_union(proto, coef, boxes, keep)
    b = boxes.double().numpy() / 4
    rows, cols = np.arange(12)[None, None, :, None], np.arange(20)[None, None, None, :]
    x1, y1, x2, y2 = (b[..., i, None, None] for i in range(4))
    pairs = ((cols >= x1) & (cols < x2) & (rows >= y1) & (rows < y2)
             & keep.numpy()[:, :, None, None]).sum()
    assert pairs > 0 and held.sum() <= pairs
    assert work["ops"] == {f"{route}_flops": 64.0 * pairs}
    elem = 2 if route == "mma" else 4
    assert work["bytes"] == (proto.numel() * proto.element_size() + coef.numel() * elem
                             + boxes.numel() * 4 + keep.numel() + out.numel() * 4)
    assert work["bound_by"] == "bytes"
    assert work["bound_ms"] == pytest.approx(work["bytes"] / cs.HBM_BYTES_PER_S * 1e3)


def test_stem_work_counts_both_convolutions():
    cs = _chip_smoke()
    x = torch.zeros((2, 64, 96), dtype=torch.bfloat16)
    out = torch.zeros((2, 16, 24, 32), dtype=torch.bfloat16)
    work = cs.stem_work(x, out)
    assert work["bytes"] == 2 * 64 * 96 * 2 + 2 * 16 * 24 * 32 * 2
    assert work["ops"] == {"b0_f32_flops": 2.0 * 2 * 32 * 48 * 16 * 9,
                           "b1_bf16_flops": 2.0 * 2 * 16 * 24 * 32 * 16 * 9}
    ops_ms = max(work["ops"]["b0_f32_flops"] / cs.F32_FLOPS,
                 work["ops"]["b1_bf16_flops"] / cs.BF16_TENSOR_FLOPS) * 1e3
    assert work["ops_ms"] == pytest.approx(ops_ms)
    both = cs.summed([work, work])
    assert both["bytes"] == 2 * work["bytes"] and both["bound_ms"] == 2 * work["bound_ms"]


def test_stem_work_in_f32_adds_both_convolutions_on_the_f32_pipe():
    cs = _chip_smoke()
    x = torch.zeros((2, 64, 96))
    out = torch.zeros((2, 16, 24, 64))
    work = cs.stem_work(x, out)
    assert work["bytes"] == 2 * 64 * 96 * 4 + 2 * 16 * 24 * 64 * 4
    b0 = 2.0 * 2 * 32 * 48 * 32 * 9
    b1 = 2.0 * 2 * 16 * 24 * 64 * 32 * 9
    assert work["ops"] == {"b0_b1_f32_flops": b0 + b1}
    assert work["ops_ms"] == pytest.approx((b0 + b1) / cs.F32_FLOPS * 1e3)
    assert work["bound_by"] == "operations"


def test_kernel_ab_ablations_still_match_the_stem_source():
    from tpu_mslesseg_torch.tools import kernel_ab

    # the ablations rewrite scale n's kernels: the source between the two markers
    text = (kernel_ab.CSRC / "stem.cu").read_text()
    head, src, rest = kernel_ab.ablatable("stem", text)
    assert head + src + rest == text
    assert head.endswith(kernel_ab.STEM_N_BEGIN) and rest.startswith(kernel_ab.STEM_N_END)
    assert "stem_mma_kernel" in src and "stem_fma_kernel" in src
    assert "stem_bf16_wide_kernel" in rest and "_wide_kernel" not in src
    # the tool tells stem_forward's argument lists apart by this symbol
    assert 'extern "C" int stem_abi_version() { return 4; }' in rest
    for name, subs in kernel_ab.ABLATIONS.items():
        for old, _ in subs:
            assert src.count(old) == 1, (name, old)
    # and the f32 wide kernel, between its own two markers
    region = (kernel_ab.STEM_F32_WIDE_BEGIN, kernel_ab.STEM_F32_WIDE_END)
    head, src, rest = kernel_ab.ablatable("stem", text, region)
    assert head + src + rest == text
    assert "stem_f32_wide_kernel" in src and "stem_bf16_wide_kernel" not in src
    for name, subs in kernel_ab.F32_WIDE_ABLATIONS.items():
        for old, _ in subs:
            assert src.count(old) == 1, (name, old)
    # and the bf16 wide kernel, between its own two markers
    region = (kernel_ab.STEM_BF16_WIDE_BEGIN, kernel_ab.STEM_BF16_WIDE_END)
    head, src, rest = kernel_ab.ablatable("stem", text, region)
    assert head + src + rest == text
    assert "stem_bf16_wide_kernel" in src and "stem_f32_wide_kernel" not in src
    assert "stem_mma_kernel" not in src and "stem_mma_wide_kernel" not in text
    for name, subs in kernel_ab.BF16_WIDE_ABLATIONS.items():
        for old, _ in subs:
            assert src.count(old) == 1, (name, old)


def test_clahe_works_count_images_luts_and_output():
    cs = _chip_smoke()
    x = torch.zeros((3, 20, 30), dtype=torch.uint8)
    luts = torch.zeros((3, 64, 256))
    lut = cs.clahe_work(x, luts)
    assert lut["bytes"] == 3 * 20 * 30 + 3 * 64 * 256 * 4
    assert lut["ops"] == {"ops": 3 * 20 * 30 + 4.0 * 3 * 64 * 256}
    blend = cs.blend_work(x, luts, x.clone())
    assert blend["bytes"] == 2 * 3 * 20 * 30 + 3 * 64 * 256 * 4
    assert blend["ops"] == {"ops": 10.0 * 3 * 20 * 30}
    assert lut["bound_by"] == blend["bound_by"] == "bytes"
    assert blend["bound_ms"] == pytest.approx(blend["bytes"] / cs.HBM_BYTES_PER_S * 1e3)


@pytest.mark.parametrize("hw", [(182, 218), (182, 182), (218, 182)])
def test_background_heavy_images_are_about_half_zeros(hw):
    cs = _chip_smoke()
    imgs = torch.randint(1, 256, (2,) + hw, dtype=torch.uint8)
    out = cs.background_heavy(torch, imgs)
    assert out.dtype == torch.uint8 and out.shape == imgs.shape
    inside = out != 0
    assert torch.equal(out[inside], imgs[inside])  # the disc keeps its pixels
    assert 0.49 < float((~inside).float().mean()) < 0.51
    assert not bool(inside[:, 0, 0].any()) and bool(inside[:, hw[0] // 2, hw[1] // 2].all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("scale", ["n", "s", "m", "l", "x"])
def test_kernel_ab_stem_cases_reach_each_instance(scale, dtype):
    """The stem weights kernel_ab makes for a scale are that scale's
    instance, and its reference check passes the plain version's own output
    and fails one pushed beyond the tolerance."""
    from tpu_mslesseg_torch.model import stem
    from tpu_mslesseg_torch.tools import kernel_ab

    gen = torch.Generator().manual_seed(0)
    w = kernel_ab._stem_weights(gen, *kernel_ab.STEM_CHANNELS[scale], torch.device("cpu"))
    c0_c1 = stem.instance_of(w)
    assert c0_c1 == kernel_ab.STEM_CHANNELS[scale] and scale in stem.INSTANCES[c0_c1]
    x = torch.rand((2, 16, 24), generator=gen).to(dtype)
    model, _ = create_model(nc=1, scale=scale, dtype=dtype)
    plain = stem.stem_reference(model, w, x).permute(0, 2, 3, 1)
    assert kernel_ab._stem_reference_errors(x, w, {"stem": plain}, scale) == {"stem": 0.0}
    with pytest.raises(AssertionError):
        kernel_ab._stem_reference_errors(x, w, {"stem": plain.float() + 0.1}, scale)


def test_kernel_ab_clahe_variants_still_match_the_clahe_source():
    """Each variant's substitutions, applied in turn, each find their text
    once in ``csrc/clahe_tile_lut.cu``; each blend ablation guards a loop
    with a condition that never holds."""
    from tpu_mslesseg_torch.tools import kernel_ab

    text = (kernel_ab.CSRC / "clahe_tile_lut.cu").read_text()
    for name, subs in kernel_ab.CLAHE_ABLATIONS.items():
        src = text
        for old, new in subs:
            assert src.count(old) == 1, (name, old)
            src = src.replace(old, new)
        assert src != text
        if name.startswith("clahe_blend"):
            assert src.count(kernel_ab._NEVER) == len(subs)
