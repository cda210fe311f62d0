"""A/B timing of the port's CUDA kernel sources in one process on one card.

    python -m tpu_mslesseg_torch.tools.kernel_ab [--parent DIR] [--ablate]
        [--kernels stem,mask_union,clahe] [--stem-scales n] [--stem-dtype bfloat16]

Builds each variant of ``csrc/stem.cu``, ``csrc/mask_union.cu`` and
``csrc/clahe_tile_lut.cu`` with ``nvcc`` (the flags of ``_build``) into a
temporary directory and times them on the same seeded inputs at the main
path's launch shapes: the stem (by default scale n's bf16 instance) at 200
and 600 images of 640 (a wider instance at 200, phase 11's launch of
``chip_smoke.py``), each output also held against ``stem_reference``
(f32 within atol = rtol = 2e-5, bf16 within ``stem.bf16_error_bound``); the bf16
union at 200 images with about 225 kept detections each (a CLAHE
dispatch's per-plane launch) and at 600 with about 85 (a GC dispatch's one
launch); the CLAHE tile LUTs and the CLAHE blend at 200 L images of each
plane shape (a CLAHE dispatch's three launches), uniform noise and
background-heavy (the noise inside a centred disc of half the area, zeros
around it), the blend beside its plain version. Each variant is timed in
blocks of CUDA-event-timed launches, in the order A, B, ..., B, A twice
after a warm-up. Prints the card's name and power limit, then one JSON line
per kernel and shape: each variant's median ms, its blocks, and its
largest difference from this tree's kernel.

- ``--parent DIR``: also the kernels of another tree (an unpacked ``git
  archive`` of the parent commit), each through its own C interface.
- ``--ablate``: also copies of this tree's stem (scale n's kernels, and
  the wide kernel of ``--stem-dtype``), tile-LUT and blend kernels with one part of their
  work taken out (their outputs are wrong by design): what each part costs;
  and the tile-LUT kernel with equal values aggregated across a warp
  (``__match_any_sync``) before the histogram's atomics (the same LUTs by
  another route).
- ``--kernels``: which of the three sources to time (all by default).
- ``--stem-scales``, ``--stem-dtype``: the stem instances to time (any of
  n, s, m, l, x) and their type (bfloat16 or float32). The ablations of
  scale n's kernels are built and timed where n is asked for, those of the
  wide kernel of the asked type (bf16 or f32) where a wider scale is.

The CLAHE kernels take less time than the host takes to launch them, so
their lines also carry ``graph_ms``: the device time of a launch, from
replays of a CUDA graph of 20 launches.
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
# the stem's ablations rewrite one region of stem.cu, between two marker
# lines: scale n's kernels, or the f32 wide kernel (the other kernels repeat
# some of the text)
STEM_N_BEGIN = "// BEGIN scale n's kernels"
STEM_N_END = "// END scale n's kernels"
STEM_F32_WIDE_BEGIN = "// BEGIN the f32 wide kernel"
STEM_F32_WIDE_END = "// END the f32 wide kernel"
STEM_BF16_WIDE_BEGIN = "// BEGIN the bf16 wide kernel"
STEM_BF16_WIDE_END = "// END the bf16 wide kernel"
STEM_CHANNELS = {"n": (16, 32), "s": (32, 64), "m": (64, 128), "l": (64, 128), "x": (96, 192)}


def ablatable(base: str, text: str, region=(STEM_N_BEGIN, STEM_N_END)) -> tuple[str, str, str]:
    """``<base>.cu`` as (what precedes, the part the ablations rewrite, what
    follows); in stem.cu the part between the `region` markers."""
    if base != "stem":
        return "", text, ""
    head, begin, rest = text.partition(region[0])
    body, end, tail = rest.partition(region[1])
    if not (begin and end):
        raise RuntimeError(f"stem.cu no longer holds {region[0]!r} and {region[1]!r}")
    return head + begin, body, end + tail


ABLATIONS = {
    "stem_without_b1_silu": _B1_ACT,
    "stem_without_b0_silu": _B0_ACT,
    "stem_without_silu": _B0_ACT + _B1_ACT,
    "stem_without_mma": _MMA,
    "stem_without_input_reads": _INPUT,
    "stem_without_output_writes": _STORE,
}
# the f32 wide kernel's parts; `h < 0` (h is an argument) never holds, and
# the compiler cannot drop the code it guards
_W_B1_ACT = tuple((f"bn_silu(acc[i][4 * j + {k}], mu.{c}, sc.{c}, be.{c})",
                   f"acc[i][4 * j + {k}] * sc.{c}") for k, c in enumerate("xyzw"))
_W_B0_ACT = (("dst[k * L::kP1H * L::kRS] = inside ? bn_silu(a[k], bn.x, bn.y, bn.z) : 0.0f;",
              "dst[k * L::kP1H * L::kRS] = inside ? a[k] * bn.y : 0.0f;"),)
F32_WIDE_ABLATIONS = {
    "stem_f32_wide_without_b0": ((
        "for (int i = tid; i < 4 * kPatch; i += kThreads) {",
        "for (int i = tid; i < 4 * kPatch && h < 0; i += kThreads) {"),),
    "stem_f32_wide_without_b0_silu": _W_B0_ACT,
    "stem_f32_wide_without_b1": ((
        "for (int cl = 0; cl < kFGroup; ++cl) {", "for (int cl = 0; cl < kFGroup && h < 0; ++cl) {"),),
    "stem_f32_wide_without_b1_silu": _W_B1_ACT,
    "stem_f32_wide_without_w1_copies": ((
        "cp_async16(dst + 4 * i,", "if (h < 0) cp_async16(dst + 4 * i,"),),
    "stem_f32_wide_without_output_writes": ((
        "*reinterpret_cast<float4*>(dst + o) =", "if (h < 0) *reinterpret_cast<float4*>(dst + o) ="),),
}
# the bf16 wide kernel's parts. Each stand-in keeps the values finite (zeroed
# P1 slabs and w1 stages, bounded stand-in products), so that no ablation sends
# the activations to the division's slow path
BF16_WIDE_ABLATIONS = {
    "stem_bf16_wide_without_b0": ((
        "for (int r = r_lo; r < r_hi; ++r) {", "for (int r = r_lo; r < r_hi && h < 0; ++r) {"), (
        "  slab(0, 0, L::kRounds);\n",
        "  for (int i = tid; i < L::kP1 / 4; i += kT) "
        "reinterpret_cast<uint4*>(p1s)[i] = make_uint4(0, 0, 0, 0);\n"
        "  __syncthreads();\n  slab(0, 0, L::kRounds);\n"),),
    "stem_bf16_wide_without_b0_silu": ((
        "y[k] = (y[k] - bn.x) * bn.y + bn.z;", "y[k] = y[k] * bn.y;"), (
        "q[k] = silu_branch_free(y[k], slow);", "q[k] = y[k];"),),
    "stem_bf16_wide_without_mma": ((
        "Wgmma<L::kNW>::run(acc, a[dx], wgmma_desc(bs + dx * 2 * C1));",
        "acc[dx] += __uint_as_float((a[dx][0] ^ a[dx][3]) & 0x3f00ffffu);"),),
    "stem_bf16_wide_without_b1_silu": ((
        "z[e] = (z[e] - bn.x) * bn.y + bn.z;", "z[e] = z[e] * bn.y;"), (
        "v[e] = silu_branch_free(z[e], slow);", "v[e] = z[e];"),),
    "stem_bf16_wide_without_w1_copies": ((
        "cp_async16(dst + i, src + i);",
        "if (h < 0) cp_async16(dst + i, src + i); else dst[i] = make_uint4(0, 0, 0, 0);"),),
    "stem_bf16_wide_without_output_writes": ((
        "*reinterpret_cast<uint4*>(out + ((static_cast<size_t>(img) * h2 + r2) * w2 + c0 + i)",
        "if (h < 0) *reinterpret_cast<uint4*>(out + ((static_cast<size_t>(img) * h2 + r2) * w2 "
        "+ c0 + i)"),),
}
# CLAHE variants, all built from clahe_tile_lut.cu: the tile LUTs with equal
# values aggregated across the warp before the histogram's atomics
# (__match_any_sync; the leader adds the group's count: the same LUTs by
# another route), and ablations of either kernel (wrong outputs by design;
# `ry < 0.0f` never holds, so a loop guarded by it does no work)
_NEVER = " && ry < 0.0f"
CLAHE_ABLATIONS = {
    "clahe_tile_lut_match_any": ((
        """      if (s * 32 + lane < area) {
        atomicAdd(&hist[band[r * w + reflect101(x0 + c, w)]], 1);
      }""",
        """      {
        const bool valid = s * 32 + lane < area;
        const int v = valid ? band[r * w + reflect101(x0 + c, w)] : -1;
        const unsigned peers = __match_any_sync(kFull, v);
        if (valid && lane == __ffs(peers) - 1) atomicAdd(&hist[v], __popc(peers));
      }""",
    ),),
    "clahe_tile_lut_without_histogram": ((
        "atomicAdd(&hist[band[r * w + reflect101(x0 + c, w)]], 1);", ";"),),
    "clahe_tile_lut_without_staging": ((
        "if (inside > 0) copy_bytes(", "if (inside < 0) copy_bytes("),),
    "clahe_tile_lut_without_stores": ((
        "    dst[0] = make_float4(out[0], out[1], out[2], out[3]);",
        "    if (scale < 0.0f) dst[0] = make_float4(out[0], out[1], out[2], out[3]);"), (
        "    dst[1] = make_float4(out[4], out[5], out[6], out[7]);",
        "    if (scale < 0.0f) dst[1] = make_float4(out[4], out[5], out[6], out[7]);"),),
    "clahe_blend_without_lut_rows": ((
        "k < 2 * per_row; k += blockDim.x", f"k < 2 * per_row{_NEVER}; k += blockDim.x"),),
    "clahe_blend_without_table": ((
        "k < (tiles_x + 1) * kBins; k += blockDim.x",
        f"k < (tiles_x + 1) * kBins{_NEVER}; k += blockDim.x"),),
    "clahe_blend_without_pixels": ((
        "(k << 4) < e; k += blockDim.x) {\n    const size_t a = k << 4;\n    const size_t first",
        f"(k << 4) < e{_NEVER}; k += blockDim.x) {{\n    const size_t a = k << 4;\n"
        "    const size_t first"),),
}
CLAHE_ABLATIONS["clahe_tile_lut_launch_only"] = sum(
    (CLAHE_ABLATIONS[f"clahe_tile_lut_without_{p}"] for p in ("histogram", "staging", "stores")), ())
CLAHE_ABLATIONS["clahe_blend_launch_only"] = sum(
    (CLAHE_ABLATIONS[f"clahe_blend_without_{p}"] for p in ("lut_rows", "table", "pixels")), ())


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


def _graph_ms(fn, reps: int) -> float:
    """Device ms of one `fn(stream)` launch: `reps` launches on a side
    stream captured in one CUDA graph, the median of three replays after a
    warm-up, over `reps`. Free of the host's cost of a launch, which exceeds
    a CLAHE kernel's time."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(side.cuda_stream)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(reps):
            fn(side.cuda_stream)
    graph.replay()
    times = []
    for _ in range(3):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return float(np.median(times))


def _compare(runs: dict, reps: int, graph=()) -> dict:
    """Each run's median ms over blocks of `reps` event-timed calls in the
    order A, B, ..., B, A twice; for the runs named in `graph` (which take
    the stream to launch on), also their `graph_ms`."""
    for fn in runs.values():
        fn()
    blocks = {k: [] for k in runs}
    order = list(runs) + list(runs)[::-1]
    for _ in range(2):
        for k in order:
            blocks[k].append(_ms(runs[k], reps))
    res = {k: {"median_ms": float(np.median(v)), "blocks_ms": v} for k, v in blocks.items()}
    for k in graph:
        res[k]["graph_ms"] = _graph_ms(runs[k], reps)
    return res


def _stem_weights(gen, c0: int, c1: int, dev) -> dict:
    """Seeded stem tensors of (c0, c1) under the model's keys: conv weights
    of std 1 / sqrt(fan-in), BN statistics away from identity."""
    w = {}
    for b, shape in (("model.0", (c0, 1, 3, 3)), ("model.1", (c1, c0, 3, 3))):
        n = shape[0]
        w[f"{b}.conv.weight"] = torch.randn(shape, generator=gen) / np.sqrt(np.prod(shape[1:]))
        w[f"{b}.bn.weight"] = torch.rand(n, generator=gen) + 0.5
        w[f"{b}.bn.bias"] = torch.randn(n, generator=gen) * 0.3 + 0.1
        w[f"{b}.bn.running_mean"] = torch.randn(n, generator=gen) * 0.2 + 0.3
        w[f"{b}.bn.running_var"] = torch.rand(n, generator=gen) * 1.5 + 0.5
    return {k: v.to(dev).contiguous() for k, v in w.items()}


def _stem_runs(libs, x, weights, stream):
    """Each library's stem launch on x with `weights` (in ``stem._LEAVES``
    order a block), through the argument list its ``stem_abi_version``
    names."""
    from tpu_mslesseg_torch.model import stem

    m, h, w = x.shape
    terms = [weights[f"{b}.{leaf}"] for b in stem._BLOCKS for leaf in stem._LEAVES]
    c0, c1 = stem.instance_of(weights)
    bf16 = int(x.dtype == torch.bfloat16)
    runs, outs = {}, {}
    for name, lib in libs.items():
        fn = lib.stem_forward
        outs[name] = torch.empty((m, h // 4, w // 4, c1), dtype=x.dtype, device=x.device)
        # the scratch where a wide instance lays its weights out: at most 9 c0
        # c1 f32 (version 2: bf16 fragments; 3: also f32 w1; 4: the bf16
        # fragments and 12 c0 + 4 c1 words of the other parameters)
        scratch = torch.empty(9 * c0 * c1, dtype=torch.float32, device=x.device)
        assert scratch.numel() * 4 >= stem.scratch_bytes(c0, c1, bool(bf16))
        tail = [outs[name].data_ptr(), m, h, w, 1e-3, stream]
        # a library without the symbol has the first interface: scale n only
        version = lib.stem_abi_version() if hasattr(lib, "stem_abi_version") else 1
        if version in (2, 3, 4):  # an instance a scale
            fn.argtypes = [P, I] + [P] * 10 + [I, I, P, P, I, I, I, F, P]
            args = [x.data_ptr(), bf16, *(t.data_ptr() for t in terms), c0, c1,
                    scratch.data_ptr(), *tail]
        elif version == 1 and (c0, c1) == (16, 32):
            fn.argtypes = [P, I] + [P] * 10 + [P, I, I, I, F, P]
            args = [x.data_ptr(), bf16, *(t.data_ptr() for t in terms), *tail]
        else:
            raise RuntimeError(f"{name}: stem_abi_version {version} has no ({c0}, {c1})")
        runs[name] = lambda fn=fn, args=args, scratch=scratch: _checked(fn(*args))
    return runs, outs


def _checked(err: int) -> None:
    if err:
        raise RuntimeError(f"kernel launch failed: CUDA error {err}")


def _stem_reference_errors(x, weights, outs, scale: str) -> dict:
    """Each output's largest difference from ``stem_reference`` on x
    (cuDNN in full f32 where x is f32); raises where one is beyond the
    stem's tolerance (f32: atol = rtol = 2e-5; bf16: ``bf16_error_bound``)."""
    from tpu_mslesseg_torch.model import stem
    from tpu_mslesseg_torch.model.yolo11 import create_model

    model, _ = create_model(nc=1, scale=scale, dtype=x.dtype)
    want = stem.stem_reference(model, weights, x).permute(0, 2, 3, 1).float()
    bound = (stem.bf16_error_bound(model, weights, x, want.permute(0, 3, 1, 2))
             .permute(0, 2, 3, 1) if x.dtype == torch.bfloat16 else None)
    errs = {}
    for name, got in outs.items():
        d = (got.float() - want).abs()
        errs[name] = float(d.max())
        if bound is None:
            torch.testing.assert_close(got.float(), want, atol=2e-5, rtol=2e-5,
                                       msg=lambda m, n=name: f"{n}: {m}")
        elif not bool((d <= bound).all()):
            raise AssertionError(f"{name}: beyond stem.bf16_error_bound")
    return errs


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


def _clahe_images(gen, n, h, w, kind, dev):
    imgs = torch.randint(0, 256, (n, h, w), generator=gen, dtype=torch.uint8)
    if kind == "background":
        yy, xx = torch.meshgrid(torch.arange(h), torch.arange(w), indexing="ij")
        imgs = imgs * ((yy - h / 2) ** 2 + (xx - w / 2) ** 2 < 0.5 * h * w / np.pi)
    return imgs.to(dev)


def _clahe_runs(libs, imgs, stream):
    """Each library's tile-LUT kernel on `imgs` (8 x 8 tiles, clip 2.0)."""
    from tpu_mslesseg_torch.preproc import clahe

    n, h, w = imgs.shape
    th, tw, area, limit = clahe.tile_geometry(h, w)
    runs, outs = {}, {}
    for name, lib in libs.items():
        fn = lib.clahe_tile_luts
        fn.argtypes = [P, P, I, I, I, I, I, I, I, I, F, P]
        out = outs[name] = torch.empty((n, 64, 256), device=imgs.device)
        args = [imgs.data_ptr(), out.data_ptr(), n, h, w, 8, 8, th, tw, limit,
                float(clahe.lut_scale(area))]
        runs[name] = lambda st=stream, fn=fn, args=args: fn(*args, st)
    return runs, outs


def _blend_runs(libs, imgs, luts, out_map, stream):
    """Each library's blend kernel on `imgs` and their LUTs."""
    from tpu_mslesseg_torch.preproc import clahe

    n, h, w = imgs.shape
    th, tw, _, _ = clahe.tile_geometry(h, w)
    runs, outs = {}, {}
    for name, lib in libs.items():
        fn = lib.clahe_blend
        fn.argtypes = [P, P, P, P, I, I, I, I, I, I, I, F, F, P]
        out = outs[name] = torch.empty_like(imgs)
        args = [imgs.data_ptr(), luts.data_ptr(), out_map.data_ptr(), out.data_ptr(), n, h, w,
                8, 8, th, tw, float(clahe._recip(th)), float(clahe._recip(tw))]
        runs[name] = lambda st=stream, fn=fn, args=args: fn(*args, st)
    return runs, outs


def _time_clahe(libs, gen, dev, stream):
    """The tile-LUT kernels of `libs` (this tree's, the parent's, the
    variants) on 200 L images of each plane shape, then this tree's blend
    and its ablations beside the plain blend; the kernels also graph-timed."""
    from tpu_mslesseg_torch.preproc import clahe, enhance

    out_map = torch.from_numpy(enhance._LAB_BWD).to(dev)
    lut_libs = {n: lib for n, lib in libs.items() if n.startswith("clahe_tile_lut")}
    blend_libs = {"clahe_blend": libs["clahe_tile_lut"],
                  **{n: lib for n, lib in libs.items() if n.startswith("clahe_blend")}}
    for kind in ("random", "background"):
        for h, w in ((182, 218), (182, 182), (218, 182)):
            imgs = _clahe_images(gen, 200, h, w, kind, dev)
            runs, outs = _clahe_runs(lut_libs, imgs, stream)
            res = _compare(runs, 20, graph=list(runs))
            for name in res:
                res[name]["max_diff"] = float((outs[name] - outs["clahe_tile_lut"]).abs().max())
            print(json.dumps({"kernel": "clahe_tile_lut", "images": kind, "n": 200, "hw": [h, w],
                              "variants": res}), flush=True)
            luts = outs["clahe_tile_lut"]
            runs, outs = _blend_runs(blend_libs, imgs, luts, out_map, stream)
            kernels = list(runs)
            runs["clahe_blend_plain"] = lambda: clahe.clahe_blend_ref(imgs, luts, out_map)
            res = _compare(runs, 20, graph=kernels)
            outs["clahe_blend_plain"] = clahe.clahe_blend_ref(imgs, luts, out_map)
            for name in res:
                res[name]["max_diff"] = float(
                    (outs[name].int() - outs["clahe_blend"].int()).abs().max())
            print(json.dumps({"kernel": "clahe_blend", "images": kind, "n": 200, "hw": [h, w],
                              "variants": res}), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, help="root of another tree to time beside this one")
    ap.add_argument("--ablate", action="store_true",
                    help="also time the kernels' ablations and the match-any tile LUTs")
    ap.add_argument("--kernels", default="stem,mask_union,clahe",
                    help="comma-separated sources to time: stem, mask_union, clahe")
    ap.add_argument("--stem-scales", default="n",
                    help="comma-separated stem instances to time: n, s, m, l, x")
    ap.add_argument("--stem-dtype", default="bfloat16", choices=("bfloat16", "float32"))
    args = ap.parse_args(argv)
    which = set(args.kernels.split(","))
    if not which <= {"stem", "mask_union", "clahe"}:
        raise SystemExit(f"kernel_ab: unknown kernels {sorted(which)}")
    scales = args.stem_scales.split(",")
    if not set(scales) <= set(STEM_CHANNELS):
        raise SystemExit(f"kernel_ab: unknown stem scales {scales}")
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: needs a CUDA device")
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps({"card": torch.cuda.get_device_name(0), "nvidia_smi": smi}), flush=True)

    # the wider scales' ablations rewrite the instance of the type they are timed in
    wide_ablations, wide_region = (
        (F32_WIDE_ABLATIONS, (STEM_F32_WIDE_BEGIN, STEM_F32_WIDE_END))
        if args.stem_dtype == "float32"
        else (BF16_WIDE_ABLATIONS, (STEM_BF16_WIDE_BEGIN, STEM_BF16_WIDE_END)))
    with tempfile.TemporaryDirectory(prefix="kernel_ab_") as tmp:
        tmp = Path(tmp)
        stem_src = {"stem": CSRC / "stem.cu"} if "stem" in which else {}
        union_src = {"mask_union": CSRC / "mask_union.cu"} if "mask_union" in which else {}
        clahe_src = {"clahe_tile_lut": CSRC / "clahe_tile_lut.cu"} if "clahe" in which else {}
        if args.parent:
            parent = args.parent / "tpu_mslesseg_torch" / "csrc"
            for srcs in (stem_src, union_src, clahe_src):
                for name in list(srcs):
                    srcs[f"{name}_parent"] = parent / srcs[name].name
        if args.ablate:
            for srcs, base, ablations, region in (
                    (stem_src, "stem", ABLATIONS, (STEM_N_BEGIN, STEM_N_END)),
                    (stem_src, "stem", wide_ablations, wide_region),
                    (clahe_src, "clahe_tile_lut", CLAHE_ABLATIONS, None)):
                if not srcs or (ablations is ABLATIONS and "n" not in scales) or (
                        ablations is wide_ablations and scales == ["n"]):
                    continue
                head, body, tail = ablatable(base, srcs[base].read_text(), region)
                for name, subs in ablations.items():
                    src = body
                    for old, new in subs:
                        if src.count(old) != 1:
                            raise RuntimeError(f"{name}: {base}.cu no longer holds {old!r}")
                        src = src.replace(old, new)
                    srcs[name] = tmp / f"{name}.cu"
                    srcs[name].write_text(head + src + tail)
        jobs = [(n, s, tmp) for n, s in {**stem_src, **union_src, **clahe_src}.items()]
        with ThreadPoolExecutor(len(jobs)) as pool:
            libs = dict(pool.map(_build_lib, jobs))

        stream = torch.cuda.current_stream().cuda_stream
        gen = torch.Generator().manual_seed(0)
        torch.backends.cudnn.allow_tf32 = False  # the f32 reference in full f32
        dtype = getattr(torch, args.stem_dtype)
        for scale in scales if stem_src else ():
            # each ablation rewrites the instance it is timed with
            ablated = ABLATIONS if scale == "n" else wide_ablations
            names = [n for n in stem_src if n in ("stem", "stem_parent") or n in ablated]
            weights = _stem_weights(gen, *STEM_CHANNELS[scale], dev)
            for m in (200, 600) if scale == "n" else (200,):
                x = torch.rand((m, 640, 640), generator=gen).to(dev, dtype)
                runs, outs = _stem_runs({n: libs[n] for n in names}, x, weights, stream)
                res = _compare(runs, 5 if scale == "n" else 3)
                ref_err = _stem_reference_errors(
                    x, weights, {n: outs[n] for n in outs if n not in ablated}, scale)
                for n in res:
                    res[n]["max_diff"] = float((outs[n].float() - outs["stem"].float()).abs().max())
                    if n in ref_err:
                        res[n]["max_abs_err_vs_reference"] = ref_err[n]
                    if dtype == torch.bfloat16 and scale != "n" and hasattr(
                            libs[n], "stem_bf16_wide_blocks_per_sm"):
                        res[n]["blocks_per_sm"] = libs[n].stem_bf16_wide_blocks_per_sm(
                            *STEM_CHANNELS[scale])
                print(json.dumps({"kernel": "stem", "scale": scale,
                                  "c0_c1": list(STEM_CHANNELS[scale]), "dtype": args.stem_dtype,
                                  "m": m, "imgsz": 640, "variants": res}), flush=True)
                del x, runs, outs
                torch.cuda.empty_cache()

        for n, keep_share in ((200, 0.75), (600, 0.283)) if union_src else ():
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
        if clahe_src:
            _time_clahe({n: libs[n] for n in clahe_src}, gen, dev, stream)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
