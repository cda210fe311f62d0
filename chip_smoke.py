"""Smoke run of the PyTorch port (``tpu_mslesseg_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one JSON line:

0. device: the card's name and power limit; builds the CUDA kernels.
1. kernel: the proto-mask union kernel against its plain PyTorch version on
   the card, at the main path's shapes (64 images, 160x160 proto, 32
   coefficients, 300 detection slots), proto in bf16 and f32, for four
   keep patterns.
2. main path: ``ConsensusPredictor.lote`` at full width (YOLO11n-seg, bf16,
   imgsz 640, GC enhancement, umbral 2, per-plane counts) over 4 synthetic
   182x218x182 patients, 50 lesion-centred slices per plane (one patient
   45, padded with out-of-range indices), seeded random weights. Checks
   that the kernel ran, that detections were kept, that the padded slots
   wrote nothing and that the result equals the same call with the plain
   union; then times 3 dispatches after a warm-up (informational).
3. timing: the kernel and the plain version on the main path's own union
   inputs (600 images).

Then the kernel summary line, the card's ``nvidia-smi`` name and power
limit, and last ``{"ok": true, "device": {...}}``. Any failure raises and
the script exits non-zero; without a CUDA device, or outside a checkout of
the repository, it exits non-zero before printing any result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
import zlib
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
VOL_SHAPE = (182, 218, 182)
PLANES = ("axial", "coronal", "sagital")
PATIENTS = ("P39", "P18", "P07", "P12")  # the last serves 45 slices per plane
N_PER_PLANE = 50
N_SHORT = 45
IMGSZ = 640
DEVICE = "cuda:0"
MAX_DIFF_LINES = 50
ATOL, RTOL = 1e-4, 1e-5
NEAR_THRESHOLD = 1e-3


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


def plane_work(geometry, torch, vol, gt, n: int):
    """Lesion-centred slice indices and raw slices per plane, padded with
    neighbours to `n` (bench.py's recipe)."""
    work = {}
    for plane in PLANES:
        axis = geometry.plane_axis(plane)
        other = tuple(i for i in range(3) if i != axis)
        has = np.nonzero(np.any(gt > 0, axis=other))[0]
        lo = max(0, len(has) // 2 - n // 2)
        idx = has[lo : lo + n]
        if len(idx) < n:
            extra = np.setdiff1d(np.arange(gt.shape[axis]), idx)[: n - len(idx)]
            idx = np.concatenate([idx, extra])
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
    """Passes the union through to `fn` and keeps the last call's inputs
    and output (for the kept-detection count and the timing phase)."""

    def __init__(self, fn):
        self.fn = fn
        self.last = None

    def __call__(self, proto, mcoef, boxes, keep, stride):
        out = self.fn(proto, mcoef, boxes, keep, stride)
        self.last = (proto, mcoef, boxes, keep, stride, out)
        return out


def random_case(torch, gen, n, k, dtype, pattern, dev):
    mh = mw = 160
    proto = torch.randn((n, mh, mw, 32), generator=gen).to(dev, dtype)
    coef = torch.randn((n, k, 32), generator=gen).to(dev)
    xy = torch.rand((n, k, 2), generator=gen) * 640
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
    sys.path.insert(0, str(ROOT))
    from tpu_mslesseg_torch import _build
    from tpu_mslesseg_torch.core import geometry
    from tpu_mslesseg_torch.infer import mask_union as mu
    from tpu_mslesseg_torch.infer.consensus3 import ConsensusPredictor
    from tpu_mslesseg_torch.model.yolo11 import STRIDES, create_model, init_variables

    dev = torch.device(DEVICE)
    # full f32 in the plain versions' matmuls and convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_label(torch)

    # ---- phase 0: device and build -------------------------------------
    t0 = time.perf_counter()
    _build.load("mask_union")
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in _build.build_logs.get("mask_union", "").splitlines()
             if "registers" in ln or "spill" in ln]
    emit({"phase": "device", **card, "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "tf32_matmul": False, "tf32_cudnn": False,
          "build_s": round(build_s, 3), "ptxas": ptxas})

    # ---- phase 1: kernel vs plain at the main path's shapes -------------
    gen = torch.Generator().manual_seed(0)
    max_err = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        for pattern in ("random", "all_dead", "scattered", "off_map"):
            args = random_case(torch, gen, 64, 300, dtype, pattern, dev)
            got = mu.mask_union_logits_batch(*args)
            want = mu.mask_union_logits_ref(*args)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            torch.testing.assert_close(got, want, atol=ATOL, rtol=RTOL)
            if pattern == "all_dead" and not bool((got == mu._NEG).all()):
                raise AssertionError("all-dead slots must give exactly -1e4")
            max_err = max(max_err, err)
            emit({"phase": "kernel", "dtype": str(dtype).removeprefix("torch."),
                  "pattern": pattern, "n": 64, "k": 300, "max_abs_err": err,
                  "atol": ATOL, "rtol": RTOL})

    # ---- phase 2: the main path -----------------------------------------
    model, _ = create_model(nc=1, scale="n", dtype=torch.bfloat16)
    variables = init_variables(model, seed=0)
    for i in range(len(STRIDES)):  # no class prior: NMS keeps detections
        variables[f"model.23.cv3.{i}.2.bias"].zero_()

    slices, idx, gts = synthetic_batch(geometry, torch)
    real_slices = len(PLANES) * ((len(PATIENTS) - 1) * N_PER_PLANE + N_SHORT)

    kw = dict(mejora="GC", imgsz=IMGSZ, umbral=2, per_plane_counts=True, device=dev)
    kernel_union = Recorder(mu.mask_union_logits_batch)
    plain_union = Recorder(mu.mask_union_logits_ref)
    cp = ConsensusPredictor(model, variables, VOL_SHAPE, mask_union=kernel_union, **kw)
    cp_plain = ConsensusPredictor(model, variables, VOL_SHAPE, mask_union=plain_union, **kw)

    mu.LAUNCHES = 0
    counts, cons, vols = cp.lote(slices, idx, gts)
    torch.cuda.synchronize()
    launches = mu.LAUNCHES
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
    emit({"phase": "main_path", "kernel_launches": launches,
          "kept_per_slice": kept_per_slice, "slices_dispatched": int(keep.shape[0]),
          "real_slices": real_slices, "voxels_differing_from_plain": n_diff,
          "padded_slots_clean": True, "metrics_patient0": metrics,
          "informational": {"dispatch_s": times,
                            "slices_per_s": real_slices / float(np.median(times)),
                            **card}})

    # ---- phase 3: kernel vs plain time on the main path's union inputs -----
    proto, mcoef, boxes, keep, stride, _ = kernel_union.last
    run_k = lambda: mu.mask_union_logits_batch(proto, mcoef, boxes, keep, stride)
    run_p = lambda: mu.mask_union_logits_ref(proto, mcoef, boxes, keep, stride)
    got, want = run_k(), run_p()
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, atol=ATOL, rtol=RTOL)
    max_err = max(max_err, float((got - want).abs().max()))
    for fn in (run_k, run_p):  # warm-up
        fn()
    k_ms, p_ms = [], []
    for fn, sink in ((run_p, p_ms), (run_k, k_ms), (run_k, k_ms), (run_p, p_ms)):
        sink.append(cuda_ms(torch, fn, 10 if fn is run_k else 3))
    ms, plain_ms = float(np.median(k_ms)), float(np.median(p_ms))
    emit({"phase": "timing", "n": int(proto.shape[0]), "k": int(mcoef.shape[1]),
          "proto_dtype": str(proto.dtype).removeprefix("torch."),
          "kept_per_image": float(keep.sum()) / keep.shape[0],
          "kernel_ms": k_ms, "plain_ms": p_ms,
          **card})

    emit({"kernels": [{
        "name": "mask_union", "route": "cuda",
        "source": "tpu_mslesseg_torch/csrc/mask_union.cu",
        "replaces": "tpu_mslesseg/infer/mask_union_pallas.py:88",
        "launches": launches, "max_abs_err": max_err,
        "ms": ms, "plain_ms": plain_ms,
    }]})
    print(card["nvidia_smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": card["name"],
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
