"""A/B timing of the port's CUDA kernel sources in one process on one card.

    python -m tpu_mslesseg_torch.tools.kernel_ab [--parent DIR] [--ablate]

Builds each variant of ``csrc/stem.cu`` and ``csrc/mask_union.cu`` with
``nvcc`` (the flags of ``_build``) into a temporary directory and times the
bf16 paths on the same seeded inputs at the main path's launch shapes: the
stem at 200 and 600 images of 640, the union at 200 images with about 225
kept detections each (a CLAHE dispatch's per-plane launch) and at 600 with
about 85 (a GC dispatch's one launch). Each variant is timed in blocks of
CUDA-event-timed launches, in the order A, B, ..., B, A twice after a
warm-up. Prints the card's name and power limit, then one JSON line per
kernel and shape: each variant's median ms, its blocks, and its largest
difference from this tree's kernel.

- ``--parent DIR``: also the kernels of another tree (an unpacked ``git
  archive`` of the parent commit), each through its own C interface.
- ``--ablate``: also copies of this tree's stem with one part of its work
  taken out (their outputs are wrong by design): what each part costs.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from tpu_mslesseg_torch import _build

CSRC = Path(__file__).resolve().parents[1] / "csrc"
P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

# stem ablations: (text of stem.cu, its stand-in)
_B1_ACT = (
    "bn_silu(round_bf16(acc[mt][nt][2 * hh]), n0.x, n0.y, n0.z)",
    "acc[mt][nt][2 * hh] * n0.y",
), (
    "bn_silu(round_bf16(acc[mt][nt][2 * hh + 1]), n1.x, n1.y, n1.z)",
    "acc[mt][nt][2 * hh + 1] * n1.y",
)
_B0_ACT = ((
    "inside ? bn_silu(round_bf16(acc[c + u]), bn.x, bn.y, bn.z) : 0.0f",
    "inside ? acc[c + u] * bn.y : 0.0f",
),)
_MMA = ((
    "for (int nt = 0; nt < 4; ++nt) mma_bf16(acc[mt][nt], a, b[nt][0], b[nt][1]);",
    "for (int nt = 0; nt < 4; ++nt) acc[mt][nt][0] += __uint_as_float(a[nt] ^ b[nt][0]);",
),)
_INPUT = ((
    "? xm[(static_cast<size_t>(r) * w + c) / 2]",
    "? static_cast<uint32_t>(r ^ c)",
),)
_STORE = ((
    "if (c0 + i < w2) orow[idx] =",
    "if (c0 + i == -1) orow[idx] =",
),)
ABLATIONS = {
    "stem_without_b1_silu": _B1_ACT,
    "stem_without_b0_silu": _B0_ACT,
    "stem_without_silu": _B0_ACT + _B1_ACT,
    "stem_without_mma": _MMA,
    "stem_without_input_reads": _INPUT,
    "stem_without_output_writes": _STORE,
}


def _build_lib(args):
    name, src, out_dir = args
    so = out_dir / f"{name}.so"
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(src)],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stderr}")
    return name, ctypes.CDLL(str(so))


def _ms(fn, reps: int) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _compare(runs: dict, reps: int) -> dict:
    for fn in runs.values():
        fn()
    blocks = {k: [] for k in runs}
    order = list(runs) + list(runs)[::-1]
    for _ in range(2):
        for k in order:
            blocks[k].append(_ms(runs[k], reps))
    return {k: {"median_ms": float(np.median(v)), "blocks_ms": v} for k, v in blocks.items()}


def _stem_runs(libs, x, weights, stream):
    m, h, w = x.shape
    runs, outs = {}, {}
    for name, lib in libs.items():
        fn = lib.stem_forward
        fn.argtypes = [P, I] + [P] * 10 + [P, I, I, I, F, P]
        outs[name] = torch.empty((m, h // 4, w // 4, 32), dtype=x.dtype, device=x.device)
        args = [x.data_ptr(), 1, *(t.data_ptr() for t in weights), outs[name].data_ptr(),
                m, h, w, 1e-3, stream]
        runs[name] = lambda fn=fn, args=args: fn(*args)
    return runs, outs


def _union_runs(libs, sources, proto, coef, boxes, keep, stream):
    n, mh, mw, nm = proto.shape
    k = coef.shape[1]
    slot = torch.arange(1, k + 1, dtype=torch.int32, device=proto.device)
    n_active = (keep.to(torch.int32) * slot).amax(1).to(torch.int32)
    coef32 = coef.float().contiguous()
    runs, outs = {}, {}
    for name, lib in libs.items():
        fn = lib.mask_union_logits
        out = outs[name] = torch.empty((n, mh, mw), device=proto.device)
        common = (boxes.data_ptr(), keep.data_ptr(), n_active.data_ptr(), out.data_ptr(), n)
        if "int coef_bf16" in sources[name].read_text():
            fn.argtypes = [P, I, P, I, P, P, P, P, I, I, I, I, I, F, P]
            args = [proto.data_ptr(), 1, coef.data_ptr(), 1, *common, mh, mw, k, nm, 4.0, stream]
        else:  # the first interface: f32 coefficients, pixels counted flat
            fn.argtypes = [P, I, P, P, P, P, P, I, I, I, I, I, F, P]
            args = [proto.data_ptr(), 1, coef32.data_ptr(), *common, mh * mw, mw, k, nm, 4.0,
                    stream]
        runs[name] = lambda fn=fn, args=args: fn(*args)
    return runs, outs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, help="root of another tree to time beside this one")
    ap.add_argument("--ablate", action="store_true", help="also time the stem's ablations")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: needs a CUDA device")
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps({"card": torch.cuda.get_device_name(0), "nvidia_smi": smi}), flush=True)

    with tempfile.TemporaryDirectory(prefix="kernel_ab_") as tmp:
        tmp = Path(tmp)
        stem_src = {"stem": CSRC / "stem.cu"}
        union_src = {"mask_union": CSRC / "mask_union.cu"}
        if args.parent:
            parent = args.parent / "tpu_mslesseg_torch" / "csrc"
            stem_src["stem_parent"] = parent / "stem.cu"
            union_src["mask_union_parent"] = parent / "mask_union.cu"
        if args.ablate:
            text = stem_src["stem"].read_text()
            for name, subs in ABLATIONS.items():
                src = text
                for old, new in subs:
                    if src.count(old) != 1:
                        raise RuntimeError(f"{name}: the stem source no longer holds {old!r}")
                    src = src.replace(old, new)
                stem_src[name] = tmp / f"{name}.cu"
                stem_src[name].write_text(src)
        jobs = [(n, s, tmp) for n, s in {**stem_src, **union_src}.items()]
        with ThreadPoolExecutor(len(jobs)) as pool:
            libs = dict(pool.map(_build_lib, jobs))

        stream = torch.cuda.current_stream().cuda_stream
        gen = torch.Generator().manual_seed(0)
        # model.0 and model.1: conv weight, bn weight, bias, running mean, var
        sizes = (16 * 9, 16, 16, 16, 16, 32 * 16 * 9, 32, 32, 32, 32)
        weights = [torch.randn(s, generator=gen) * 0.3 for s in sizes]
        for i in (4, 9):  # running variances
            weights[i] = weights[i].abs() + 0.5
        weights = [t.to(dev).contiguous() for t in weights]
        for m in (200, 600):
            x = torch.rand((m, 640, 640), generator=gen).to(dev, torch.bfloat16)
            runs, outs = _stem_runs({n: libs[n] for n in stem_src}, x, weights, stream)
            res = _compare(runs, 5)
            for n in res:
                res[n]["max_diff"] = float((outs[n].float() - outs["stem"].float()).abs().max())
            print(json.dumps({"kernel": "stem", "m": m, "imgsz": 640, "variants": res}), flush=True)
            del x, runs, outs

        for n, keep_share in ((200, 0.75), (600, 0.283)):
            k = 300
            proto = torch.randn((n, 160, 160, 32), generator=gen).to(dev, torch.bfloat16)
            coef = torch.randn((n, k, 32), generator=gen).to(dev, torch.bfloat16)
            xy = torch.rand((n, k, 2), generator=gen) * 640
            boxes = torch.cat([xy, xy + torch.rand((n, k, 2), generator=gen) * 200 + 2], -1)
            keep = torch.rand((n, k), generator=gen) < keep_share
            boxes, keep = boxes.to(dev).contiguous(), keep.to(dev)
            runs, outs = _union_runs({u: libs[u] for u in union_src}, union_src,
                                     proto, coef, boxes, keep, stream)
            res = _compare(runs, 10)
            for u in res:
                res[u]["max_diff"] = float((outs[u] - outs["mask_union"]).abs().max())
            print(json.dumps({"kernel": "mask_union", "n": n, "k": k,
                              "kept_per_image": float(keep.sum()) / n, "variants": res}),
                  flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
