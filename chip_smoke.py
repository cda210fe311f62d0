"""Smoke run of the PyTorch port (``tpu_mslesseg_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one JSON line:

0. device: the card's name and power limit; builds the CUDA sources of the
   four kernels (one ``nvcc`` a source, started together; the two CLAHE
   kernels share one).
1. kernel: the proto-mask union kernel against its plain PyTorch version on
   the card, at the main path's shapes (64 images, 160x160 proto, 32
   coefficients, 300 detection slots), for four keep patterns: bf16 proto
   with bf16 coefficients (the tensor-core kernel, within
   ``mask_union.union_error_bound``), bf16 and f32 proto with f32
   coefficients (the FMA kernel, atol 1e-4, rtol 1e-5); then the
   tensor-core kernel's edge cases (K = 21, a 20x24 map, nothing kept).
2. main path (GC): ``ConsensusPredictor.lote`` at full width (YOLO11n-seg,
   bf16, imgsz 640, GC enhancement, umbral 2, per-plane counts, the plain
   stem) over 4 synthetic 182x218x182 patients, 50 lesion-centred slices
   per plane (one patient 45, padded with out-of-range indices), seeded
   random weights. Checks that the union kernel ran, that detections were
   kept, that the padded slots wrote nothing and that the result equals the
   same call with the plain union; then times 3 dispatches after a warm-up
   (informational).
3. timing: the union kernel and its plain version on phase 2's union
   inputs (one launch of 600 images), with the bytes and operations that
   work needs, its bound and the kernel's share of it.
4. clahe_kernel: the CLAHE tile-LUT kernel against its plain version on 64
   random and 64 background-heavy L images (noise in a centred disc of
   half the area, zeros around it) of each plane shape and on one-tile edge
   cases (constant, two-valued, residual 0, every bin clipped), and the
   blend kernel against its plain version on the first two sets: exactly
   equal; then ``enhance_for_model(..., "CLAHE")`` with both kernels
   against the same with both plain versions, on the card.
5. stem_kernel: the fused stem against ``model.0``/``model.1`` (BN
   statistics perturbed) at 64 images of 640: f32 within 2e-5; bf16 within
   one bf16 ulp of b1's conv sum carried through BN and SiLU, plus one ulp
   of the output (``stem.bf16_error_bound``), with the errors also in ulps
   of the larger of the value and 1.0.
6. rapido (this slice's path): ``pipeline.rapido.ejecutar_fold_rapido``
   over an experiment tree in a temporary directory — five synthetic
   182x218x182 patients in fold 1 (one with 45 slices per plane), their
   FLAIR/mask NIfTI and GT, stage-1 image names (50 lesion-centred indices
   per plane), a ``best.pt`` per plane from its own seed — with ``--mejora
   CLAHE``, YOLO11n-seg, bf16, imgsz 640, umbral 2 and
   ``TPU_MSLESSEG_PALLAS_STEM=1``: two dispatches of 4 patients, the second
   the fifth patient repeated. Checks that every volume/JSON pair and
   nothing else was written, that all four kernels launched (the CLAHE
   tile LUTs and blend, the stem, the union), that NMS
   kept detections, that the volumes on disk equal a
   direct ``lote`` of the same groups and the JSONs their counts' metrics.
7. stem_main_path: phase 6's first group through ``lote`` with the stem
   off: per-plane and consensus Dice against the stem-on run (the consensus
   at least 0.99), and the stem and union kernels against their plain
   versions on that group's own inputs (the bounds of phases 5 and 1).
8. timing: each kernel against its plain version at the main path's
   per-launch shapes, on phase 7's inputs (one CLAHE dispatch: three
   launches of 200 images, one a plane, each with its plane's weights),
   and the stem at 600 images of 640: the median of plain, kernel, kernel,
   plain blocks after a warm-up. The two CLAHE kernels are timed again on a
   background-heavy copy of those L images (each slice inside a centred
   disc of half its area, zeros around it, as a FLAIR slice is about half
   background). A CLAHE kernel takes less time than the host takes to call
   its wrapper, so its time is the device time from replays of a CUDA
   graph of 20 wrapper calls (the event-timed calls kept as ``call_ms``).
   Each kernel's timing comes with a ``bound`` line: the bytes
   and operations the work needs (each input read once, each output
   written once; the union's products counted over the pixels its kept
   boxes hold), the least time the card could take for them (3.35 TB/s;
   989 TFLOP/s bf16 on the tensor cores, 67 TFLOP/s f32 off them), which
   of the two bounds it, the share bound / kernel, and the launches a
   dispatch. Then the whole CLAHE enhancement of a dispatch
   (``enhance_for_model`` on the group's 3 x 200 slices) with both plain
   versions, with the tile-LUT kernel and the plain blend, and with both
   kernels, timed in turns; the three results are equal.

Then the kernel summary line (per CLAHE dispatch: kernel and plain ms,
the CLAHE kernels' background-heavy ms, the bound and what bounds it;
``library_ms`` is null, as no single PyTorch call computes any of the four
functions), the card's ``nvidia-smi`` name and power limit, and last
``{"ok": true, "device": {...}}``. Any failure
raises and the script exits non-zero; without a CUDA device, or outside a
checkout of the repository, it exits non-zero before printing any result.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time
import zlib
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
VOL_SHAPE = (182, 218, 182)
PLANES = ("axial", "coronal", "sagital")
PATIENTS = ("P39", "P18", "P07", "P12")  # the last serves 45 slices per plane
FOLD_PATIENTS = ("P1", "P2", "P3", "P4", "P5")  # fold 1 of 5; the last serves 45
N_PER_PLANE = 50
N_SHORT = 45
IMGSZ = 640
EPOCHS = 50
DEVICE = "cuda:0"
MAX_DIFF_LINES = 50
ATOL, RTOL = 1e-4, 1e-5  # the FMA union kernel (f32 coefficients)
STEM_TOL = 2e-5
NEAR_THRESHOLD = 1e-3
MIN_DICE = 0.99
# kernel -> (its CUDA source, the Pallas kernel body it replaces)
KERNEL_SOURCES = {
    "mask_union": ("tpu_mslesseg_torch/csrc/mask_union.cu",
                   "tpu_mslesseg/infer/mask_union_pallas.py:88"),
    "clahe_tile_lut": ("tpu_mslesseg_torch/csrc/clahe_tile_lut.cu",
                       "tpu_mslesseg/preproc/clahe_pallas.py:27"),
    "clahe_blend": ("tpu_mslesseg_torch/csrc/clahe_tile_lut.cu",
                    "tpu_mslesseg/preproc/clahe_pallas.py:86"),
    "stem": ("tpu_mslesseg_torch/csrc/stem.cu", "tpu_mslesseg/model/stem_pallas.py:149"),
}
KERNELS = tuple(KERNEL_SOURCES)
SOURCES = tuple(dict.fromkeys(Path(src).stem for src, _ in KERNEL_SOURCES.values()))
NOTES = {"clahe_blend": "the reference's blend is the XLA apply outside pallas_call "
                        "(one-hot matmuls on the TPU's MXU), not a Pallas kernel"}
# the H100 SXM's published peaks (NVIDIA's data sheet: dense rates, 700 W)
HBM_BYTES_PER_S = 3.35e12
BF16_TENSOR_FLOPS = 989e12
F32_FLOPS = 67e12
# the serving model of phase 6, as a user's environment would set it
SERVING_ENV = {
    "TPU_MSLESSEG_PALLAS_STEM": "1", "TPU_MSLESSEG_DTYPE": "bfloat16",
    "TPU_MSLESSEG_SCALE": "n", "TPU_MSLESSEG_IMGSZ": str(IMGSZ),
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_label(torch) -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return {"name": torch.cuda.get_device_name(0), "nvidia_smi": smi[0] if smi else ""}


def patient_volume(pid: str):
    """The benchmark's synthetic patient (bench.py's fallback recipe)."""
    rng = np.random.default_rng(zlib.crc32(pid.encode()))
    vol = rng.normal(500, 150, VOL_SHAPE).astype(np.float64)
    mask = np.zeros(VOL_SHAPE)
    mask[80:100, 100:130, 70:110] = 1
    return vol, mask


def plane_indices(geometry, gt, plane: str, n: int):
    """`n` lesion-centred slice indices, padded with neighbours (bench.py's
    recipe)."""
    axis = geometry.plane_axis(plane)
    other = tuple(i for i in range(3) if i != axis)
    has = np.nonzero(np.any(gt > 0, axis=other))[0]
    lo = max(0, len(has) // 2 - n // 2)
    idx = has[lo : lo + n]
    if len(idx) < n:
        extra = np.setdiff1d(np.arange(gt.shape[axis]), idx)[: n - len(idx)]
        idx = np.concatenate([idx, extra])
    return idx


def plane_work(geometry, torch, vol, gt, n: int):
    """Per plane: lesion-centred slice indices and the raw slices."""
    work = {}
    for plane in PLANES:
        idx = plane_indices(geometry, gt, plane, n)
        slices = geometry.extract_slices(
            torch.from_numpy(vol.astype(np.float32)), plane, idx
        ).numpy()
        work[plane] = (idx, slices)
    return work


def synthetic_batch(geometry, torch):
    """One serving group: slices {plane: [P, 50, h, w]}, indices {plane:
    [P, 50]} (the short patient padded with blank slices and the index
    max(VOL_SHAPE)) and ground truths [P, X, Y, Z]."""
    slices = {p: [] for p in PLANES}
    idx = {p: [] for p in PLANES}
    gts = []
    for pid in PATIENTS:
        vol, gt = patient_volume(pid)
        n = N_SHORT if pid == PATIENTS[-1] else N_PER_PLANE
        work = plane_work(geometry, torch, vol, gt, n)
        for p in PLANES:
            ix, sl = work[p]
            pad = N_PER_PLANE - n
            idx[p].append(np.concatenate([ix, np.full(pad, max(VOL_SHAPE))]))
            slices[p].append(np.concatenate([sl, np.zeros((pad,) + sl.shape[1:], sl.dtype)]))
        gts.append(gt)
    slices = {p: np.stack(v) for p, v in slices.items()}
    idx = {p: np.stack(v) for p, v in idx.items()}
    gts = np.stack(gts).astype(np.float32)
    return slices, idx, gts


class Recorder:
    """Passes the union through to `fn`, keeps the last call's inputs and
    output (and with `keep_calls` every call's inputs) for the timing
    phases, and counts kept detections over calls."""

    def __init__(self, fn, keep_calls: bool = False):
        self.fn = fn
        self.last = None
        self.calls = [] if keep_calls else None
        self.kept = 0
        self.images = 0

    def __call__(self, proto, mcoef, boxes, keep, stride):
        out = self.fn(proto, mcoef, boxes, keep, stride)
        self.last = (proto, mcoef, boxes, keep, stride, out)
        if self.calls is not None:
            self.calls.append((proto, mcoef, boxes, keep, stride))
        self.kept = self.kept + keep.sum()  # on the device: no sync per call
        self.images += keep.shape[0]
        return out


def random_case(torch, gen, n, k, dtype, pattern, dev, coef_dtype=None, mh=160, mw=160):
    proto = torch.randn((n, mh, mw, 32), generator=gen).to(dev, dtype)
    coef = torch.randn((n, k, 32), generator=gen).to(dev, coef_dtype or torch.float32)
    xy = torch.rand((n, k, 2), generator=gen) * 4 * torch.tensor([mw, mh])
    wh = torch.rand((n, k, 2), generator=gen) * 200 + 2
    if pattern == "off_map":  # boxes that run off the 640x640 letterbox
        xy = xy * 1.5 - 320
        wh = wh * 3
    boxes = torch.cat([xy, xy + wh], -1).to(dev)
    keep = torch.rand((n, k), generator=gen) > 0.7
    if pattern == "all_dead":
        keep[:] = False
    elif pattern == "scattered":
        keep[:] = False
        keep[:, [3, 70, k - 1]] = True
    return proto, coef, boxes, keep.to(dev)


def cuda_ms(torch, fn, reps: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(torch, fn, reps: int) -> float:
    """Device ms of one `fn` call: `reps` calls captured in one CUDA graph,
    replayed three times after a warm-up; the median replay over `reps`.
    Free of the host's cost of a call, which exceeds a CLAHE kernel's time."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    times = []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    del graph
    return float(np.median(times))


def timed_pair(torch, run_k, run_p, reps_k: int, reps_p: int):
    """Kernel and plain ms: one warm-up each, then blocks in the order
    plain, kernel, kernel, plain; returns (kernel blocks, plain blocks)."""
    for fn in (run_k, run_p):
        fn()
    k_ms, p_ms = [], []
    for fn, sink in ((run_p, p_ms), (run_k, k_ms), (run_k, k_ms), (run_p, p_ms)):
        sink.append(cuda_ms(torch, fn, reps_k if fn is run_k else reps_p))
    return k_ms, p_ms


def check_union(torch, mu, args, got, want) -> dict:
    """The union kernel's error against the plain version on `args`:
    within ``union_error_bound`` on the tensor-core route, atol/rtol on the
    FMA route; raises beyond it."""
    route = mu.kernel_inputs(*args[:4])[0]
    d = (got - want).abs()
    out = {"route": route, "max_abs_err": float(d.max())}
    if route == "fma":
        torch.testing.assert_close(got, want, atol=ATOL, rtol=RTOL)
        return out
    bound = mu.union_error_bound(*args)
    ratio = torch.where(bound > 0, d / bound, torch.where(d > 0, float("inf"), 0.0))
    out["max_err_over_bound"] = float(ratio.max())
    if out["max_err_over_bound"] > 1.0:
        raise AssertionError(f"mask union ({route}): {out} beyond union_error_bound")
    return out


def emit_bound(kernel: str, work: dict, kernel_ms: float, launches: int, what: str) -> None:
    emit({"phase": "bound", "kernel": kernel, "work": what, **work, "kernel_ms": kernel_ms,
          "share_of_bound": work["bound_ms"] / kernel_ms, "launches_per_dispatch": launches})


def work_bound(bytes_moved: float, ops: dict) -> dict:
    """The least time the card could take for work that moves `bytes_moved`
    and does ops {pipe: (count, peak per s)}: the larger of the bytes' time
    at the memory rate and the slowest pipe's time at its peak."""
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    ops_ms = max(n / rate * 1e3 for n, rate in ops.values())
    return {"bytes": bytes_moved, "ops": {k: n for k, (n, _) in ops.items()},
            "bytes_ms": bytes_ms, "ops_ms": ops_ms, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def union_work(torch, mu, proto, mcoef, boxes, keep, stride, out) -> dict:
    """Bytes and products of one union launch: proto, the coefficients as
    the kernel takes them, boxes, keep and the union once; 64 flops per
    (pixel, kept detection whose box holds it), on the tensor cores for the
    mma route, else on the f32 pipe."""
    route, coef, b, kp, _ = mu.kernel_inputs(proto, mcoef, boxes, keep)
    _, mh, mw, _ = proto.shape
    q = b / stride
    def span(lo, hi, size):
        return (torch.ceil(hi).clamp(0, size) - torch.ceil(lo).clamp(0, size)).clamp(min=0)
    pixels = (span(q[..., 0], q[..., 2], mw) * span(q[..., 1], q[..., 3], mh))[kp].sum()
    flops = 64.0 * float(pixels)
    rate = BF16_TENSOR_FLOPS if route == "mma" else F32_FLOPS
    return work_bound(nbytes(proto, coef, b, kp, out), {f"{route}_flops": (flops, rate)})


def stem_work(x, out) -> dict:
    """Bytes and operations of one fused-stem launch on x [M, S, S] bf16:
    input and P2 once; b0 on the f32 pipe, b1 on the tensor cores."""
    m, h, w = x.shape
    b0 = 2.0 * m * (h // 2) * (w // 2) * 16 * 9
    b1 = 2.0 * m * (h // 4) * (w // 4) * 32 * 16 * 9
    return work_bound(nbytes(x, out), {"b0_f32_flops": (b0, F32_FLOPS),
                                       "b1_bf16_flops": (b1, BF16_TENSOR_FLOPS)})


def clahe_work(x, luts) -> dict:
    """Bytes and operations of one tile-LUT launch: the uint8 L images and
    the f32 LUTs once; a histogram add a pixel and about four operations a
    LUT entry (clip, redistribute, CDF, scale) off the tensor cores."""
    ops = float(x.numel()) + 4.0 * luts.numel()
    return work_bound(nbytes(x, luts), {"ops": (ops, F32_FLOPS)})


def blend_work(x, luts, out) -> dict:
    """Bytes and operations of one blend launch: the uint8 L images, the f32
    LUTs and the uint8 output once; ten f32 operations a pixel (three FMAs
    of two, two products, two differences) off the tensor cores."""
    return work_bound(nbytes(x, luts, out), {"ops": (10.0 * x.numel(), F32_FLOPS)})


def summed(works) -> dict:
    """Several launches' work as one dispatch's."""
    tot = {"bytes": sum(w["bytes"] for w in works),
           "ops": {k: sum(w["ops"][k] for w in works) for k in works[0]["ops"]}}
    for key in ("bytes_ms", "ops_ms", "bound_ms"):
        tot[key] = sum(w[key] for w in works)
    tot["bound_by"] = "bytes" if tot["bytes_ms"] >= tot["ops_ms"] else "operations"
    return tot


@contextlib.contextmanager
def switched(module, name, value):
    """`module.name` set to `value` for the duration."""
    old = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, old)


def background_heavy(torch, imgs):
    """`imgs` [N, H, W] inside a centred disc of half the image's area,
    zeros around it: about as much background as a FLAIR slice holds."""
    _, h, w = imgs.shape
    yy, xx = torch.meshgrid(torch.arange(h, device=imgs.device),
                            torch.arange(w, device=imgs.device), indexing="ij")
    inside = (yy - h / 2) ** 2 + (xx - w / 2) ** 2 < 0.5 * h * w / np.pi
    return imgs * inside


@contextlib.contextmanager
def plain_clahe(clahe, luts: bool = True, blend: bool = True):
    """CLAHE's tile LUTs (with `luts`) and its blend (with `blend`) by the
    plain versions for the duration."""
    with contextlib.ExitStack() as stack:
        if luts:
            stack.enter_context(switched(clahe, "clahe_tile_luts", clahe.clahe_tile_luts_ref))
        if blend:
            stack.enter_context(switched(clahe, "clahe_blend", clahe.clahe_blend_ref))
        yield


def zero_launches(counters):
    for module, name in counters.values():
        setattr(module, name, 0)


def read_launches(counters) -> dict:
    return {k: getattr(module, name) for k, (module, name) in counters.items()}


def perturbed_stem(torch, sd, seed: int):
    """`sd` with the stem's BN statistics away from identity (with identity
    statistics silu(bn(0)) == 0 would hide a padding fault)."""
    sd = dict(sd)
    gen = torch.Generator().manual_seed(seed)
    for b in ("model.0", "model.1"):
        n = sd[f"{b}.bn.weight"].numel()
        sd[f"{b}.bn.running_mean"] = torch.randn(n, generator=gen) * 0.2 + 0.3
        sd[f"{b}.bn.running_var"] = torch.rand(n, generator=gen) * 1.5 + 0.5
        sd[f"{b}.bn.bias"] = torch.randn(n, generator=gen) * 0.3 + 0.1
    return sd


def stem_errors(torch, stem, model, w, x, got, want) -> dict:
    """Max abs error, the share of differing elements and, in bf16, the
    largest error in bf16 ulps of max(|x|, 1) and over the stem's bf16
    bound (``stem.bf16_error_bound``); raises beyond the bound (f32:
    atol/rtol 2e-5)."""
    g, wf = got.float(), want.float()
    d = (g - wf).abs()
    out = {"max_abs_err": float(d.max()), "share_differing": float((d > 0).float().mean())}
    if got.dtype == torch.float32:
        torch.testing.assert_close(g, wf, atol=STEM_TOL, rtol=STEM_TOL)
        return out
    ulp = torch.exp2(torch.floor(torch.log2(wf.abs().clamp(min=1.0))) - 7)
    out["max_ulp_of_max_x_1"] = float((d / ulp).max())
    out["share_beyond_1_ulp"] = float((d > ulp).float().mean())
    del ulp
    out["max_err_over_bound"] = float((d / stem.bf16_error_bound(model, w, x, want)).max())
    if out["max_err_over_bound"] > 1.0:
        raise AssertionError(f"stem bf16: {out} beyond the bound")
    return out


def dice(a, b) -> float:
    a, b = a > 0, b > 0
    denom = int(a.sum()) + int(b.sum())
    return 1.0 if denom == 0 else 2.0 * int((a & b).sum()) / denom


def write_experiment(root: Path, geometry, torch, modelo_cls, save_checkpoint,
                     config_train, nifti, create_model, init_variables, strides):
    """The fold-1 experiment tree of phase 6 under `root`; returns the
    CLAHE axial experiment's Modelo."""
    ds = root / "MSLesSeg-Dataset" / "train"
    modelo = {p: modelo_cls(plano=p, num_cortes=N_PER_PLANE, modalidad=["FLAIR"],
                            k_folds=5, mejora="CLAHE") for p in PLANES}
    for pid in FOLD_PATIENTS:
        vol, gt = patient_volume(pid)
        nifti.save(vol.astype(np.float32), np.eye(4), ds / pid / "T1" / f"{pid}_T1_FLAIR.nii.gz")
        nifti.save(gt.astype(np.uint8), np.eye(4), ds / pid / "T1" / f"{pid}_T1_MASK.nii.gz")
        nifti.save(gt.astype(np.uint8), np.eye(4), root / "GT" / "train" / pid / f"{pid}_MASK.nii.gz")
        n = N_SHORT if pid == FOLD_PATIENTS[-1] else N_PER_PLANE
        for p in PLANES:
            images = root / "datasets" / modelo[p].base_path / "fold1" / pid / p / "images"
            images.mkdir(parents=True)
            for i in plane_indices(geometry, gt, p, n):  # stage 1's file names
                (images / f"{pid}_FLAIR_{i}.png").touch()
    model, _ = create_model(nc=1, scale="n")
    for k, p in enumerate(PLANES):  # one seed per plane: the per-plane forward
        sd = init_variables(model, seed=10 + k)
        for i in range(len(strides)):  # no class prior: NMS keeps detections
            sd[f"model.23.cv3.{i}.2.bias"].zero_()
        cfg = config_train(modelo=modelo[p], epochs=EPOCHS, fold_test=1, root=root)
        save_checkpoint(cfg.best_ckpt, sd)
    return modelo["axial"]


def main() -> int:
    import torch

    if not (ROOT / "tpu_mslesseg_torch" / "csrc" / "mask_union.cu").is_file():
        print(f"chip_smoke: {ROOT} is not a checkout of the repository",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one",
              file=sys.stderr)
        return 2
    os.environ.update(SERVING_ENV)  # read when the port's modules import
    sys.path.insert(0, str(ROOT))
    from tpu_mslesseg_torch import _build
    from tpu_mslesseg_torch.core import geometry
    from tpu_mslesseg_torch.evalx import metrics as mx
    from tpu_mslesseg_torch.infer import mask_union as mu
    from tpu_mslesseg_torch.infer.consensus3 import ConsensusPredictor
    from tpu_mslesseg_torch.io import nifti
    from tpu_mslesseg_torch.model import stem
    from tpu_mslesseg_torch.model.yolo11 import (
        STRIDES, create_model, create_model_from_env, fold_gray_stem, init_variables,
    )
    from tpu_mslesseg_torch.pipeline import rapido
    from tpu_mslesseg_torch.pipeline.modelo import Modelo
    from tpu_mslesseg_torch.pipeline.paciente import Paciente
    from tpu_mslesseg_torch.pipeline.paths import ConfigTrain
    from tpu_mslesseg_torch.preproc import clahe, enhance
    from tpu_mslesseg_torch.train.checkpoint import save_checkpoint

    dev = torch.device(DEVICE)
    # full f32 in the plain versions' matmuls and convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_label(torch)
    # each kernel's launch count: (module, counter)
    counters = {"mask_union": (mu, "LAUNCHES"), "clahe_tile_lut": (clahe, "LAUNCHES"),
                "clahe_blend": (clahe, "BLEND_LAUNCHES"), "stem": (stem, "LAUNCHES")}
    max_err = dict.fromkeys(KERNELS, 0.0)

    # ---- phase 0: device and build -------------------------------------
    t0 = time.perf_counter()
    _build.load_all(SOURCES)
    build_s = time.perf_counter() - t0
    ptxas = {
        k: [ln.strip() for ln in _build.build_logs.get(k, "").splitlines()
            if "registers" in ln or "spill" in ln or "Function properties" in ln]
        for k in SOURCES
    }
    emit({"phase": "device", **card, "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "tf32_matmul": False, "tf32_cudnn": False,
          "build_s": round(build_s, 3), "ptxas": ptxas})

    # ---- phase 1: union kernel vs plain at the main path's shapes ---------
    gen = torch.Generator().manual_seed(0)
    dname = lambda t: str(t).removeprefix("torch.")
    cases = [(d, c, pattern, 64, 300, 160, 160)
             for d, c in ((torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.float32),
                          (torch.float32, torch.float32))
             for pattern in ("random", "all_dead", "scattered", "off_map")]
    cases += [(torch.bfloat16, torch.bfloat16, "random", 16, 21, 160, 160),  # K % 8 != 0
              (torch.bfloat16, torch.bfloat16, "random", 16, 40, 20, 24),  # ragged tiles
              (torch.bfloat16, torch.bfloat16, "off_map", 16, 40, 20, 24)]
    for dtype, coef_dtype, pattern, n, k, mh, mw in cases:
        args = random_case(torch, gen, n, k, dtype, pattern, dev, coef_dtype, mh, mw)
        got = mu.mask_union_logits_batch(*args)
        want = mu.mask_union_logits_ref(*args)
        torch.cuda.synchronize()
        errs = check_union(torch, mu, args, got, want)
        if pattern == "all_dead" and not bool((got == mu._NEG).all()):
            raise AssertionError("all-dead slots must give exactly -1e4")
        max_err["mask_union"] = max(max_err["mask_union"], errs["max_abs_err"])
        emit({"phase": "kernel", "proto_dtype": dname(dtype), "coef_dtype": dname(coef_dtype),
              "pattern": pattern, "n": n, "k": k, "map": [mh, mw], **errs})

    # ---- phase 2: the GC main path (plain stem) ----------------------------
    model, _ = create_model(nc=1, scale="n", dtype=torch.bfloat16)
    variables = init_variables(model, seed=0)
    for i in range(len(STRIDES)):  # no class prior: NMS keeps detections
        variables[f"model.23.cv3.{i}.2.bias"].zero_()

    slices, idx, gts = synthetic_batch(geometry, torch)
    real_slices = len(PLANES) * ((len(PATIENTS) - 1) * N_PER_PLANE + N_SHORT)

    kw = dict(mejora="GC", imgsz=IMGSZ, umbral=2, per_plane_counts=True, device=dev)
    kernel_union = Recorder(mu.mask_union_logits_batch)
    plain_union = Recorder(mu.mask_union_logits_ref)
    with switched(stem, "ENABLED", False):
        cp = ConsensusPredictor(model, variables, VOL_SHAPE, mask_union=kernel_union, **kw)
        cp_plain = ConsensusPredictor(model, variables, VOL_SHAPE, mask_union=plain_union, **kw)

    zero_launches(counters)
    counts, cons, vols = cp.lote(slices, idx, gts)
    torch.cuda.synchronize()
    launches = read_launches(counters)["mask_union"]
    if launches < 1:
        raise AssertionError("the main path did not launch the mask-union kernel")

    keep = kernel_union.last[3]
    kept_per_slice = float(keep.sum()) / keep.shape[0]
    if not kept_per_slice > 0:
        raise AssertionError("NMS kept no detection on the main path")

    # outputs: shapes, binary volumes, counts that cover every voxel
    n_pat, n_vox = len(PATIENTS), int(np.prod(VOL_SHAPE))
    assert tuple(cons.shape) == (n_pat,) + VOL_SHAPE and cons.dtype == torch.uint8
    for key, c in counts.items():
        assert tuple(c.shape) == (n_pat, 4), key
        assert bool(torch.isfinite(c).all()) and bool((c.sum(1) == n_vox).all()), key
    for p in PLANES:
        assert tuple(vols[p].shape) == (n_pat,) + VOL_SHAPE
        assert bool(((vols[p] == 0) | (vols[p] == 1)).all()), p

    # the padded slots wrote nothing
    last = n_pat - 1
    for p in PLANES:
        axis = geometry.plane_axis(p)
        untouched = np.setdiff1d(np.arange(VOL_SHAPE[axis]), idx[p][last][:N_SHORT])
        rest = vols[p][last].index_select(axis, torch.as_tensor(untouched, device=dev))
        if bool(rest.any()):
            raise AssertionError(f"{p}: a padded slot wrote into the volume")

    # the same call with the plain union on the card
    p_counts, p_cons, p_vols = cp_plain.lote(slices, idx, gts)
    torch.cuda.synchronize()
    plain_rows = plain_union.last[5]
    n_diff, worst = 0, 0.0
    start = 0
    for p in PLANES:
        rows = n_pat * N_PER_PLANE
        d = (vols[p] != p_vols[p]).nonzero().tolist()
        if d:
            logits = cp_plain._plane_logits(plain_rows[start : start + rows], p)
            logits = logits.reshape((n_pat, N_PER_PLANE) + logits.shape[1:])
            axis = geometry.plane_axis(p)
            for pat, *xyz in d:
                j = int(np.nonzero(idx[p][pat] == xyz[axis])[0][0])
                hw = [c for a, c in enumerate(xyz) if a != axis]
                lg = float(logits[pat, j, hw[0], hw[1]])
                if n_diff < MAX_DIFF_LINES:
                    emit({"phase": "main_path_diff", "plane": p, "patient": pat,
                          "voxel": xyz, "plain_logit": lg})
                worst = max(worst, abs(lg - cp_plain.mask_thresh))
                n_diff += 1
        start += rows
    if worst >= NEAR_THRESHOLD:
        raise AssertionError(f"a voxel differs away from the threshold ({worst})")
    if n_diff == 0:
        if not torch.equal(cons, p_cons):
            raise AssertionError("consensus differs from the plain-union run")
        for key in counts:
            if not torch.equal(counts[key], p_counts[key]):
                raise AssertionError(f"{key}: counts differ from the plain-union run")
    else:  # the consensus may differ only where a plane volume did
        plane_diff = torch.zeros_like(cons, dtype=torch.bool)
        for p in PLANES:
            plane_diff |= vols[p] != p_vols[p]
        if bool(((cons != p_cons) & ~plane_diff).any()):
            raise AssertionError("consensus differs where no plane volume did")
    metrics = {k: cp.metrics_from_counts(counts[k][0]) for k in counts}

    times = []
    for rep in range(4):  # one warm-up, then 3 timed dispatches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cp.lote(slices, idx, gts)
        torch.cuda.synchronize()
        if rep:
            times.append(time.perf_counter() - t0)
    emit({"phase": "main_path", "mejora": "GC", "kernel_launches": launches,
          "union_route": mu.kernel_inputs(*kernel_union.last[:4])[0],
          "kept_per_slice": kept_per_slice, "slices_dispatched": int(keep.shape[0]),
          "real_slices": real_slices, "voxels_differing_from_plain": n_diff,
          "padded_slots_clean": True, "metrics_patient0": metrics,
          "informational": {"dispatch_s": times,
                            "slices_per_s": real_slices / float(np.median(times)),
                            **card}})

    # ---- phase 3: union kernel vs plain time on phase 2's inputs ----------
    proto, mcoef, boxes, keep, stride, _ = kernel_union.last
    run_k = lambda: mu.mask_union_logits_batch(proto, mcoef, boxes, keep, stride)
    run_p = lambda: mu.mask_union_logits_ref(proto, mcoef, boxes, keep, stride)
    got, want = run_k(), run_p()
    torch.cuda.synchronize()
    errs = check_union(torch, mu, kernel_union.last[:5], got, want)
    max_err["mask_union"] = max(max_err["mask_union"], errs["max_abs_err"])
    work = union_work(torch, mu, proto, mcoef, boxes, keep, stride, got)
    k_ms, p_ms = timed_pair(torch, run_k, run_p, 10, 3)
    emit_bound("mask_union", work, float(np.median(k_ms)), launches,
               "phase 2: one GC dispatch, one launch of 600 images")
    emit({"phase": "timing", "kernel": "mask_union", "n": int(proto.shape[0]),
          "k": int(mcoef.shape[1]), "proto_dtype": dname(proto.dtype),
          "coef_dtype": dname(mcoef.dtype), **errs,
          "kept_per_image": float(keep.sum()) / keep.shape[0],
          "kernel_ms": k_ms, "plain_ms": p_ms, **card})
    del cp, cp_plain, kernel_union, plain_union, proto, mcoef, boxes, keep, got, want

    # ---- phase 4: CLAHE tile-LUT and blend kernels vs plain -----------------
    bwd = torch.from_numpy(enhance._LAB_BWD).to(dev)
    for hw in [(182, 218), (182, 182), (218, 182)]:
        imgs = torch.randint(0, 256, (64,) + hw, generator=gen, dtype=torch.uint8).to(dev)
        sets = {"random": imgs, "background": background_heavy(torch, imgs)}
        cases = [(x, 2.0, 8) for x in sets.values()]
        th, tw, area, limit = clahe.tile_geometry(*hw)
        big = 512 + limit
        edge = [
            (torch.full((area,), 131), 2.0),
            (torch.where(torch.rand(area, generator=gen) < 0.3, 17, 240), 2.0),
            (torch.cat([torch.full((big,), 60), 61 + torch.arange(area - big) % 190]), 2.0),
            (torch.cat([torch.arange(256), torch.arange(256),
                        torch.randint(0, 256, (area - 512,), generator=gen)]), 0.1),
        ]
        for pix, clip in edge:  # one-tile images: the tile is the image
            tile = pix[torch.randperm(area, generator=gen)].reshape(1, th, tw)
            cases.append((tile.to(dev, torch.uint8), clip, 1))
        for x, clip, tiles in cases:
            got = clahe.clahe_tile_luts(x, clip, tiles, tiles)
            want = clahe.clahe_tile_luts_ref(x, clip, tiles, tiles)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"CLAHE LUTs differ from the plain version at {hw}")
        blend_px = {}
        for name, x in sets.items():
            luts = clahe.clahe_tile_luts(x)
            got = clahe.clahe_blend(x, luts, bwd)
            want = clahe.clahe_blend_ref(x, luts, bwd)
            torch.cuda.synchronize()
            blend_px[name] = int((got != want).sum())
            if blend_px[name]:
                raise AssertionError(f"CLAHE blend differs from the plain version at {hw}, "
                                     f"{name}: {blend_px[name]} px")
        enhance_px = {}
        for name, x in sets.items():
            raw = x.to(torch.float32) * 3.7 - 40.0  # the same images as slices
            got = enhance.enhance_for_model(raw, "CLAHE")
            with plain_clahe(clahe):
                want = enhance.enhance_for_model(raw, "CLAHE")
            torch.cuda.synchronize()
            enhance_px[name] = int((got != want).sum())
            if enhance_px[name]:
                raise AssertionError(f"CLAHE enhancement differs from the plain versions "
                                     f"({enhance_px[name]} px, {name})")
        emit({"phase": "clahe_kernel", "hw": list(hw), "images": {k: 64 for k in sets},
              "background_share": float((sets["background"] == 0).float().mean()),
              "tile": [th, tw], "limit": limit, "edge_tiles": len(edge),
              "max_abs_err": 0.0, "blend_px_differing": blend_px,
              "enhance_for_model_px_differing": enhance_px})
    del imgs, sets, cases, luts, got, want

    # ---- phase 5: stem kernel vs model.0/model.1 ---------------------------
    for dtype in (torch.float32, torch.bfloat16):
        smodel, _ = create_model(nc=1, scale="n", dtype=dtype)
        sd = perturbed_stem(torch, fold_gray_stem(init_variables(smodel, seed=3)), 4)
        w = stem.stem_weights({k: v.to(dev) for k, v in sd.items()})
        x = torch.rand((64, IMGSZ, IMGSZ), generator=gen).to(dev, dtype)
        got = stem.stem_apply(smodel, w, x)
        want = stem.stem_reference(smodel, w, x)
        torch.cuda.synchronize()
        if tuple(got.shape) != (64, 32, IMGSZ // 4, IMGSZ // 4) or got.dtype != dtype:
            raise AssertionError(f"stem output {tuple(got.shape)} {got.dtype}")
        if not got.is_contiguous(memory_format=torch.channels_last):
            raise AssertionError("stem output is not channels-last")
        errs = stem_errors(torch, stem, smodel, w, x, got, want)
        max_err["stem"] = max(max_err["stem"], errs["max_abs_err"])
        emit({"phase": "stem_kernel", "dtype": str(dtype).removeprefix("torch."), "m": 64,
              "imgsz": IMGSZ, **errs, "bound": "atol=rtol=2e-5" if dtype == torch.float32
              else "1 bf16 ulp of the conv sum through BN and SiLU, + 1 of the output"})
        del got, want, x
    torch.cuda.empty_cache()

    # ---- phase 6: rapido, the slice's path ------------------------------
    if not stem.ENABLED:
        raise AssertionError("TPU_MSLESSEG_PALLAS_STEM=1 did not switch the stem on")
    smodel, _, imgsz = create_model_from_env()
    if (smodel.dtype, smodel.cfg.scale, imgsz) != (torch.bfloat16, "n", IMGSZ):
        raise AssertionError("the serving model is not YOLO11n-seg bf16 at 640")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        root = Path(tmp)
        t0 = time.perf_counter()
        modelo = write_experiment(root, geometry, torch, Modelo, save_checkpoint, ConfigTrain,
                                  nifti, create_model, init_variables, STRIDES)
        setup_s = time.perf_counter() - t0
        cwd = os.getcwd()
        os.chdir(root)
        try:
            zero_launches(counters)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ok = rapido.ejecutar_fold_rapido(modelo, epochs=EPOCHS, k_folds=5, fold_test=1,
                                             umbral=2, device=dev)
            torch.cuda.synchronize()
            fold_s = time.perf_counter() - t0
            fold_launches = read_launches(counters)
            if ok is not True:
                raise AssertionError("ejecutar_fold_rapido did not serve the fold")
            for k, n in fold_launches.items():
                if n < 1:
                    raise AssertionError(f"the rapido fold did not launch the {k} kernel")

            # every (volume, JSON) pair and nothing else
            exp = f"{modelo.base_path}_{EPOCHS}epochs"
            kinds = PLANES + ("consenso",)
            expected = {
                Path(d) / exp / "fold1" / pid / f"{pid}_{k}{suffix}"
                for pid in FOLD_PATIENTS for k in kinds
                for d, suffix in (("pred_vols", ".nii.gz"), ("results", "_results.json"))
            }
            written = {
                p.relative_to(root) for d in ("pred_vols", "results")
                for p in (root / d).rglob("*") if p.is_file()
            }
            if written != expected:
                raise AssertionError(
                    f"rapido wrote {sorted(map(str, written - expected))}, "
                    f"missed {sorted(map(str, expected - written))}"
                )

            # a direct lote of the same groups with the same predictor set-up
            cache = {}
            payloads = [
                rapido._recolectar_paciente(
                    modelo, Paciente(id=pid, plano="axial", modalidad=["FLAIR"],
                                     mejora="CLAHE", dataset_dir="MSLesSeg-Dataset/train"),
                    EPOCHS, 5, 2, cache)
                for pid in FOLD_PATIENTS
            ]
            union = Recorder(mu.mask_union_logits_batch)
            cp = ConsensusPredictor(
                smodel, payloads[0]["variables"], VOL_SHAPE, mejora="CLAHE", imgsz=imgsz,
                umbral=2, planes=PLANES, per_plane_counts=True, device=dev, mask_union=union,
            )
            groups = [payloads[:4], [payloads[4]] * 4]
            lote_s, direct = [], []
            for chunk in groups:
                arrays = rapido._lote_arrays(chunk, PLANES, VOL_SHAPE)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = cp.lote(*arrays)
                torch.cuda.synchronize()
                lote_s.append(time.perf_counter() - t0)
                direct.append((chunk, arrays, out))
            kept_per_slice = float(union.kept) / max(union.images, 1)
            if not kept_per_slice > 0:
                raise AssertionError("NMS kept no detection on the rapido path")
            n_checked = 0
            for chunk, _, (counts, cons, vols) in direct:
                real = chunk if chunk[0] is not chunk[-1] else chunk[:1]
                for i, payload in enumerate(real):
                    pid = payload["pid"]
                    for k in kinds:
                        vol = cons[i] if k == "consenso" else vols[k][i]
                        disk = nifti.load(root / "pred_vols" / exp / "fold1" / pid
                                          / f"{pid}_{k}.nii.gz").get_fdata()
                        if not np.array_equal(disk, vol.cpu().numpy().astype(np.float64)):
                            raise AssertionError(f"{pid}/{k}: volume on disk != direct lote")
                        met = json.loads((root / "results" / exp / "fold1" / pid
                                          / f"{pid}_{k}_results.json").read_text())
                        if json.dumps(met) != json.dumps(mx.metrics_from_counts(counts[k][i])):
                            raise AssertionError(f"{pid}/{k}: JSON != metrics of the counts")
                        n_checked += 1
            real_fold = len(PLANES) * ((len(FOLD_PATIENTS) - 1) * N_PER_PLANE + N_SHORT)
            emit({"phase": "rapido", "mejora": "CLAHE", "patients": len(FOLD_PATIENTS),
                  "dispatches": len(groups), "lote_size": rapido.LOTE_PACIENTES,
                  "launches": fold_launches, "kept_per_slice": kept_per_slice,
                  "files_written": len(written), "pairs_checked_against_lote": n_checked,
                  "informational": {"setup_s": setup_s, "fold_s": fold_s, "lote_s": lote_s,
                                    "real_slices": real_fold,
                                    "fold_slices_per_s": real_fold / fold_s,
                                    "lote_slices_per_s": real_fold / sum(lote_s), **card}})

            # ---- phase 7: stem off vs stem on, same group -------------------
            rec_on = Recorder(mu.mask_union_logits_batch, keep_calls=True)
            rec_off = Recorder(mu.mask_union_logits_batch)
            with switched(stem, "ENABLED", False):
                cp_off = ConsensusPredictor(
                    smodel, payloads[0]["variables"], VOL_SHAPE, mejora="CLAHE",
                    imgsz=imgsz, umbral=2, planes=PLANES, per_plane_counts=True, device=dev,
                    mask_union=rec_off,
                )
            cp.mask_union = rec_on
            stem_before = stem.LAUNCHES
            _, on_arrays, (_, first_cons, _) = direct[0]
            _, on_cons, on_vols = cp.lote(*on_arrays)  # again: run to run the same?
            launched = stem.LAUNCHES - stem_before
            _, off_cons, off_vols = cp_off.lote(*on_arrays)
            torch.cuda.synchronize()
            if stem.LAUNCHES - stem_before != launched or launched < 1:
                raise AssertionError("the stem ran in the stem-off predictor, or not in the other")
            dices, differing = {}, {}
            for k in kinds:
                a = on_cons if k == "consenso" else on_vols[k]
                b = off_cons if k == "consenso" else off_vols[k]
                dices[k] = dice(a, b)
                differing[k] = int((a != b).sum())
            # the kernels against their plain versions on this group's own inputs
            stem_inputs, stem_x, stem_w = {}, {}, dict(cp._stem_w)
            for p in PLANES:
                sl = torch.as_tensor(on_arrays[0][p]["FLAIR"], device=dev)
                u8 = enhance.enhance_for_model(sl.reshape((-1,) + sl.shape[2:]), "CLAHE")
                png = geometry.to_png_space_batch(u8).to(torch.float32) / 255.0
                x = cp.lb[p].apply(png).to(smodel.dtype)
                got = stem.stem_apply(smodel, cp._stem_w[p], x)
                want = stem.stem_reference(smodel, cp._stem_w[p], x)
                stem_inputs[p] = stem_errors(torch, stem, smodel, cp._stem_w[p], x, got, want)
                max_err["stem"] = max(max_err["stem"], stem_inputs[p]["max_abs_err"])
                stem_x[p] = x
            union_calls = dict(zip(PLANES, rec_on.calls))  # the per-plane launches
            if len(rec_on.calls) != len(PLANES):
                raise AssertionError(f"{len(rec_on.calls)} union calls in a per-plane lote")
            union_inputs = {}
            for p, call in union_calls.items():
                got, want = mu.mask_union_logits_batch(*call), mu.mask_union_logits_ref(*call)
                torch.cuda.synchronize()
                union_inputs[p] = check_union(torch, mu, call, got, want)
                max_err["mask_union"] = max(max_err["mask_union"], union_inputs[p]["max_abs_err"])
            keep_on, keep_off = rec_on.last[3], rec_off.last[3]  # the last plane's NMS
            emit({"phase": "stem_main_path", "patients": 4, "dice_stem_on_vs_off": dices,
                  "voxels_differing": differing, "min_consensus_dice": MIN_DICE,
                  "stem_on_repeat_equal": bool(torch.equal(on_cons, first_cons)),
                  "stem_vs_plain_on_these_inputs": stem_inputs,
                  "union_vs_plain_on_these_inputs": union_inputs,
                  f"{PLANES[-1]}_slices_whose_nms_keep_differs":
                      int((keep_on != keep_off).any(dim=1).sum()),
                  f"{PLANES[-1]}_kept_on_off": [int(keep_on.sum()), int(keep_off.sum())]})
            if dices["consenso"] < MIN_DICE:
                raise AssertionError(f"stem on vs off: consensus Dice {dices} below {MIN_DICE}")
            # phase 8's CLAHE inputs: the group's slices and L images per plane
            clahe_slices, l_imgs = {}, {}
            for p in PLANES:
                sl = torch.as_tensor(on_arrays[0][p]["FLAIR"], device=dev)
                clahe_slices[p] = sl.reshape((-1,) + sl.shape[2:])
                u8 = enhance.normalize_to_uint8(clahe_slices[p])
                l_imgs[p] = torch.from_numpy(enhance._LAB_FWD).to(dev)[u8.long()]
            del cp, cp_off, direct, payloads, cache, on_arrays, on_cons, on_vols
            del off_cons, off_vols, first_cons, rec_on, rec_off, got, want, x
        finally:
            os.chdir(cwd)
    torch.cuda.empty_cache()

    # ---- phase 8: kernel vs plain time at the main path's per-launch shapes --
    per_dispatch = {k: n // len(groups) for k, n in fold_launches.items()}
    dispatch = "one CLAHE dispatch, per-plane weights: 3 launches of 200 images"
    timing, works = {}, {}

    def time_dispatch(kernel, runs, reps_k, reps_p, work_of, extra, inputs="main path",
                      graph=False):
        """Times each plane's launch, kernel vs plain; emits the timing
        lines and the dispatch's bound line. With `graph`, the kernel's
        time is its device time from CUDA-graph replays of the wrapper's
        call, and the event-timed call (host cost included) is kept as
        `call_ms`. Main-path timings are kept under the kernel's name,
        others under (kernel, inputs)."""
        k_sum, p_sum, ws = 0.0, 0.0, []
        for p, (run_k, run_p) in runs.items():
            k_ms, p_ms = timed_pair(torch, run_k, run_p, reps_k, reps_p)
            call = {}
            if graph:
                call = {"call_ms": k_ms}
                k_ms = [graph_ms(torch, run_k, reps_k) for _ in range(2)]
            k_sum += float(np.median(k_ms))
            p_sum += float(np.median(p_ms))
            ws.append(work_of(p))
            emit({"phase": "timing", "kernel": kernel, "inputs": inputs, "plane": p, **extra(p),
                  "kernel_ms": k_ms, **call, "plain_ms": p_ms, **card})
        key = kernel if inputs == "main path" else (kernel, inputs)
        works[key] = summed(ws)
        timing[key] = (k_sum, p_sum)
        emit_bound(kernel, works[key], k_sum, per_dispatch[kernel], f"{dispatch}; {inputs}")

    clahe_sets = {"main path": l_imgs,
                  "background": {p: background_heavy(torch, x) for p, x in l_imgs.items()}}
    for inputs, imgs in clahe_sets.items():
        luts = {}
        for p, x in imgs.items():
            luts[p], want = clahe.clahe_tile_luts(x), clahe.clahe_tile_luts_ref(x)
            got, want_b = clahe.clahe_blend(x, luts[p], bwd), clahe.clahe_blend_ref(x, want, bwd)
            torch.cuda.synchronize()
            if not torch.equal(luts[p], want):
                raise AssertionError(f"{p}: CLAHE LUTs differ on the {inputs} L images")
            if not torch.equal(got, want_b):
                raise AssertionError(f"{p}: CLAHE blend differs on the {inputs} L images")
        shape = lambda p: {"n": int(imgs[p].shape[0]), "hw": list(imgs[p].shape[1:]),
                           "background_share": float((imgs[p] == 0).float().mean())}
        time_dispatch(
            "clahe_tile_lut",
            {p: ((lambda x=x: clahe.clahe_tile_luts(x)), (lambda x=x: clahe.clahe_tile_luts_ref(x)))
             for p, x in imgs.items()},
            20, 5, lambda p: clahe_work(imgs[p], luts[p]), shape, inputs, graph=True,
        )
        time_dispatch(
            "clahe_blend",
            {p: ((lambda x=x, t=luts[p]: clahe.clahe_blend(x, t, bwd)),
                 (lambda x=x, t=luts[p]: clahe.clahe_blend_ref(x, t, bwd)))
             for p, x in imgs.items()},
            20, 5, lambda p: blend_work(imgs[p], luts[p], clahe.clahe_blend(imgs[p], luts[p], bwd)),
            shape, inputs, graph=True,
        )
        del luts, want, got, want_b

    # the whole CLAHE enhancement of the dispatch: plain, the tile-LUT
    # kernel with the plain blend, and both kernels
    variants = {"plain": lambda: plain_clahe(clahe),
                "tile_lut_kernel_plain_blend": lambda: plain_clahe(clahe, luts=False),
                "kernels": contextlib.nullcontext}

    def enhancement(variant):
        with variants[variant]():
            return [enhance.enhance_for_model(sl, "CLAHE") for sl in clahe_slices.values()]

    outs = {v: enhancement(v) for v in variants}
    torch.cuda.synchronize()
    for v in variants:
        if not all(torch.equal(a, b) for a, b in zip(outs[v], outs["plain"])):
            raise AssertionError(f"CLAHE enhancement ({v}) differs from the plain versions")
    del outs
    order = list(variants) + list(variants)[::-1]
    blocks = {v: [] for v in variants}
    for v in order:
        blocks[v].append(cuda_ms(torch, lambda v=v: enhancement(v), 5))
    emit({"phase": "timing", "what": "clahe_enhancement_per_dispatch",
          "slices": {p: int(sl.shape[0]) for p, sl in clahe_slices.items()},
          "ms": {v: float(np.median(b)) for v, b in blocks.items()}, "blocks_ms": blocks,
          "outputs_equal": True, **card})
    del clahe_slices, l_imgs, clahe_sets

    time_dispatch(
        "mask_union",
        {p: ((lambda c=c: mu.mask_union_logits_batch(*c)),
             (lambda c=c: mu.mask_union_logits_ref(*c))) for p, c in union_calls.items()},
        10, 3,
        lambda p: union_work(torch, mu, *union_calls[p],
                             mu.mask_union_logits_batch(*union_calls[p])),
        lambda p: {"n": int(union_calls[p][0].shape[0]), "k": int(union_calls[p][1].shape[1]),
                   "kept_per_image": float(union_calls[p][3].sum()) / union_calls[p][3].shape[0],
                   **union_inputs[p]},
    )
    del union_calls

    time_dispatch(
        "stem",
        {p: ((lambda x=x, w=stem_w[p]: stem.stem_apply(smodel, w, x)),
             (lambda x=x, w=stem_w[p]: stem.stem_reference(smodel, w, x)))
         for p, x in stem_x.items()},
        5, 3, lambda p: stem_work(stem_x[p], stem.stem_apply(smodel, stem_w[p], stem_x[p])),
        lambda p: {"m": int(stem_x[p].shape[0]), "imgsz": IMGSZ, **stem_inputs[p]},
    )
    del stem_x, stem_w
    torch.cuda.empty_cache()

    # the stem at 600 images, as the earlier rows of the kernel table
    sd = perturbed_stem(torch, fold_gray_stem(init_variables(smodel, seed=5)), 6)
    w = stem.stem_weights({k: v.to(dev) for k, v in sd.items()})
    x = torch.rand((600, IMGSZ, IMGSZ), generator=gen).to(dev, torch.bfloat16)
    got, want = stem.stem_apply(smodel, w, x), stem.stem_reference(smodel, w, x)
    torch.cuda.synchronize()
    errs = stem_errors(torch, stem, smodel, w, x, got, want)
    max_err["stem"] = max(max_err["stem"], errs["max_abs_err"])
    work = stem_work(x, got)
    del got, want
    k_ms, p_ms = timed_pair(torch, lambda: stem.stem_apply(smodel, w, x),
                            lambda: stem.stem_reference(smodel, w, x), 5, 3)
    emit_bound("stem", work, float(np.median(k_ms)), per_dispatch["stem"],
               "one launch of 600 random images")
    emit({"phase": "timing", "kernel": "stem", "m": 600, "imgsz": IMGSZ, "dtype": "bfloat16",
          **errs, "kernel_ms": k_ms, "plain_ms": p_ms, **card})

    emit({"kernels": [
        {"name": name, "route": "cuda", "source": source, "replaces": replaces,
         "launches": fold_launches[name], "max_abs_err": max_err[name],
         "ms": timing[name][0], "plain_ms": timing[name][1],
         "bound_ms": works[name]["bound_ms"], "bound_by": works[name]["bound_by"],
         "library_ms": None, "work": dispatch,
         **({"ms_background": timing[(name, "background")][0]}
            if (name, "background") in timing else {}),
         **({"note": NOTES[name]} if name in NOTES else {})}
        for name, (source, replaces) in KERNEL_SOURCES.items()
    ]})
    print(card["nvidia_smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": card["name"],
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
