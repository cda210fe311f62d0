"""Smoke run of the PyTorch port (``tpu_mslesseg_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one JSON line (the CLI phases also print the
pipeline's log lines):

0. device: the card's name and power limit; builds the CUDA sources of the
   six kernels (one ``nvcc`` a source, started together; the two CLAHE
   kernels share one): the four that replace the JAX package's Pallas
   kernels, the Conv blocks' fused eval BatchNorm + SiLU
   (``csrc/bn_act.cu``), which replaces the plain version's four passes, and
   NMS's suppression (``csrc/nms.cu``), which keeps on the card the fixpoint
   that the JAX package runs in a ``lax.while_loop`` and the plain version
   from the host.
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
   nothing else was written, that all six kernels launched (the CLAHE
   tile LUTs and blend, the stem, the union, the fused BN + SiLU, NMS's
   suppression), that NMS kept detections, that the volumes on disk equal a
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
   kernels, timed in turns; the three results are equal. Last, the fused
   BN + SiLU on every Conv output of one served forward (one plane's 200
   images of phase 7, the stem on, every BatchNorm's terms away from
   init): each launch against ``bn_act_ref`` within one ulp of bf16 (the
   elements that differ counted: bit-equal is the aim), the launches a
   forward, and all of them timed against the plain passes, with their
   bound (4 bytes an element). NMS's part: the three ``nms_batch`` calls of
   phase 7's dispatch (200 images, 8,400 anchors, K = 300, recorded as the
   predictor made them) through the kernel against the plain suppression,
   keep, indices, boxes and scores bit for bit, with the plain fixpoint's
   steps; each call's suppression timed (the kernel as CUDA-graph replays,
   the plain version by events around its host loop) with its bound (the
   boxes, ``valid`` and ``keep`` once; 14 float32 operations for each pair
   of valid candidates); then ``nms_checks``: the first call at NMS
   confidence 0.001 and with no valid candidate, a chain of 250 links, pairs
   at, one ulp above and one ulp below the thresholds 0.7, 0.3 and 0.45
   (only those above suppress: the comparison in float32), the first
   call's first 50 images and the three calls as one of 600 images (the
   cluster and tile edges of the kernel's grid; each graph-timed), and the
   first call under ``torch.cuda.set_sync_debug_mode("error")``: through the
   kernel no sync, through the plain version (the control) one raised.

9. cli_chain: the orchestrator CLI through the stage chain. A dataset tree
   ``MSLesSeg-Dataset/train`` with four synthetic 182x218x182 patients (a
   60-slice lesion box, so stage 1 keeps 50 lesion slices a plane),
   ``k_folds=2`` (two patients a fold), FLAIR, ``--mejora CLAHE``,
   ``--num_cortes 50``, a ``best.pt`` for 3 planes x 2 folds, in a temporary
   directory; ``ejecutar_pipeline.main([... "--completo", "--sin_rapido"])``
   in-process for axial, coronal and sagital in turn (stage 0 builds the
   GT tree, then stages 1, 3, 4, 6 a plane, and 5, 6, 7 after the third).
   Checks the whole artifact tree, that the consensus waited for the third
   plane, that all six kernels launched, that one patient's stage-1 image
   PNGs equal the same enhancement on the CPU, that its stage-1 label files
   of the first plane equal, byte for byte, ``write_yolo_seg_label_ref``
   (the reference's walk) on each slice's GT PNG (the plain writer's
   seconds, stage 1's seconds a plane and the label bytes are printed
   beside), its stage-3 masks a direct ``SlicePredictor`` call on the same
   enhanced slices and its stage-4
   volumes ``reconstruct_volume`` of them, that each of the six kernels
   agrees with its plain version on that patient's own stage-3 tensors (50
   images a launch, where the earlier phases hold them at 200 and 600; the
   bounds of phases 1, 4 and 5), timed there too, that every consensus volume is
   the vote of the three plane volumes on disk and every patient JSON the
   metrics of the counts of the volume beside it, and that a second run of
   one plane writes nothing. Then stage 3 of one fold again (``limpiar``)
   with ``PIPELINE_DEPTH`` 4 and 1 in turns, timed.
10. cli_default: ``main([... "--completo"])`` for the three planes on a copy
   of phase 9's inputs and stage-1 output: ``rapido`` serves each fold and
   the chain reduces to skips and aggregation. Checks the volume and JSON
   tree and the six launch counts, and reports each patient's Dice against
   phase 9's volumes (bf16 results depend on the batch: the chain serves 50
   slices a call, ``rapido`` 200 a plane) and both phases' stage timings.

11. stem_activation_check, then stem_kernel (scales n, s, m, l, x): the
   branch-free SiLU (of the f32 kernel at n and of the bf16 wide kernel)
   against ``y / (1 + expf(-y))`` on all 2^32
   f32 inputs (no mismatch allowed); the fused stem's instance of every
   published scale, (c0, c1) = (16, 32), (32, 64), (64, 128) for m and for
   l, (96, 192), against
   ``model.0``/``model.1`` of a model of that scale (seeded weights, BN
   statistics perturbed) on 200 random images of 640: f32 within 2e-5, bf16
   within ``stem.bf16_error_bound``; then each instance and its plain
   version timed in both types, and each instance's bytes, operations,
   bound and share of it (``bound`` lines; in f32 b0 and b1 both on the
   f32 pipe).
12. lote_scale_s, lote_scale_m, lote_scale_n: ``ConsensusPredictor.lote``
   at scale s (bf16), at scale m (f32) and at scale n (f32), 640, GC, two of
   phase 2's patients, with ``TPU_MSLESSEG_PALLAS_STEM`` on: the predictor
   is built with the stem's weights, the stem kernel launches once and the
   union kernel launches, the counts cover the volumes, and the consensus
   agrees with the same call with the stem off (Dice at least 0.99). At m
   and n (f32) a line ``lote_scale_<s>_f32_default_flags``: the same call
   under PyTorch's default TF32 flags, saved and restored around it, equals
   the result with TF32 off, every model call's class logits bit for bit
   and every voxel (the program scopes TF32 off for a float32 model itself;
   this script turns it off for the process); with the program's scope
   taken out, the logits differ.
13. train: the train step at full width. YOLO11n-seg at its published
   widths, imgsz 640, bf16 compute (the reference's ``amp``), batch 16 (``accumulate_steps``
   4), ``max_fg`` 64, 64 instance slots with one to five valid, seeded
   weights, 6 passes over 8 fixed synthetic batches (48 micro-steps) through
   ``trainer.train_step``. Checks that every loss part is finite at every
   step, that the optimizer fired at exactly the micro-steps
   ``apply_cadence`` gives, that parameters, EMA and every BatchNorm running
   statistic moved and are finite, and that the last pass's mean total loss
   is below the first pass's. Prints seconds a micro-step (host clock around
   work that ends in ``torch.cuda.synchronize()``, the first three apart)
   and ``torch.cuda.max_memory_allocated()`` beside what earlier phases
   still held when it began. The train step launches none
   of the hand-written kernels (the reference's reaches no Pallas kernel
   either); its launch counts are read like any other path's and are 0.
14. train_f32: five f32 micro-steps (three applies) at imgsz 64, batch 2,
   from the same weights on the same batches on the card and on the CPU.
   Every loss part (box, seg, cls, dfl and the total, each above 0.1 on
   these batches) within rtol 1e-3 at every step; every BatchNorm running
   statistic within 2e-4; every parameter and its EMA by their update
   (after minus initial): within 10% of the leaf's largest update on at
   least 99% of the leaf's elements. The bias group warms from 0 here and
   not from 0.1 (``phase_train_f32`` says why); three BatchNorm biases
   whose gradient is rounding noise are left out.

15. train_cli: train a fold, then serve it. Four synthetic 182x218x182
   patients (phase 9's lesion box), ``k_folds=2``, FLAIR, ``--mejora
   CLAHE``, ``--num_cortes 50``, the stem on, in a temporary directory;
   ``ejecutar_pipeline.main([... "--completo", "--entrenar",
   "--train_secuencial", "--epochs", "3"])`` in-process: per fold the
   dataset on the card, ``batch -1`` resolved by the card's probe (an empty
   cache file), three epochs of YOLO11n-seg at 640 in bf16, rematerialised
   (``TrainConfig.remat``, on by default as the reference's; mosaic, train
   step, validation, ``results.csv``, checkpoints), then ``rapido`` serves
   every patient from the fold's ``best.pt``. Checks each fold's files
   (``args.yaml``, the dataset YAML, ``results.csv`` with three rows of
   finite losses, ``best.pt``, ``last.pt``, ``fitness.json``, and the
   reference's training figures where matplotlib imports, none where it
   does not: a ``train_figures_15`` line says which), the cadence of every
   micro-step, that ``best.pt`` serves through ``SlicePredictor``
   with the fused stem, every volume/JSON pair of the serve, that the serve
   launched all six kernels, and that the same command again trains
   nothing. Prints the batch before and after the dataset rule, the probe's
   peaks, seconds an epoch, a micro-step and a validation pass, images/s,
   the model's ``remat``, the peak memory at the end of each fold's
   training (since the phase began) and the phase's.

16. train_parallel_cli: train every fold at once, then serve. Phase 15's
   inputs and command without ``--train_secuencial`` (the CLI's default for
   a full experiment with no fold trained): ``train_folds_parallel`` builds
   one pool of all patients on the card, resolves ``batch -1`` by one
   fold's probe, and advances both folds micro-step by micro-step (3
   epochs of YOLO11n-seg at 640 in bf16), then ``rapido`` serves every
   patient from its fold's ``best.pt``. Checks that ``stage_timer`` shows
   ``train_paralelo`` and no ``train_fold<k>``, the stacked
   ``_parallel/last.pt`` and every fold's files (three ``results.csv`` rows
   of finite losses; the figures as in phase 15, ``train_figures_16``), every micro-step's cadence and finite losses, that
   the folds took turns, that the pool and validation sets launched
   CLAHE's kernels and the serve all six, each kernel against its plain
   version on fold 1's served weights and a patient's slices (NMS at the
   validation's confidence, 0.001, so the union holds kept boxes), and that the
   same command again trains nothing. Prints the batch, micro-steps an
   epoch, seconds a micro-step and a round of both folds, images/s, seconds
   a validation pass, the phase's seconds, the model's ``remat`` and the
   peak memory at the end of training and the phase's, beside phase 15's.
17. nccl_one_rank: ``init_process_group("nccl", world_size=1)`` through a
   file store: one data-parallel micro-step (YOLO11n-seg, 640, bf16, batch
   16) through the collective path, against the plain micro-step from the
   same state on the same batch, bit for bit, under the deterministic
   modes (the plain step twice first). Two ranks cannot run on one card:
   the CPU tests run them over ``gloo``.
18. demo: the demo on the card. Synthetic 182x218x182 P18 and P39 (phase
   9's lesion box) in a temporary directory; ``configure_logging_demo()``,
   then ``ejecutar_demo_paciente(pid, mejora, entrenar=True, epochs=3)`` for
   both ``DEMO_CASES`` (the CLI's patient mode at full width: YOLO11n-seg,
   640, bf16, the stem on, ``k_folds`` 5, FLAIR, axial, P50: stage 1, the
   patient's fold trained with ``batch -1``, stage 3 through the stage
   chain, then the GIF and the figure). Checks each fold's files, the
   patient's prediction PNGs, volume and JSON, ``demo.log``, that each
   case's stage 3 launched the union kernel and the stem (a
   ``demo_kernels`` line) and that stage 1 and 3 wrote through the native
   PNG writer; the stored masks against a direct ``SlicePredictor`` call
   (equal) and the plain stem, epilogue and union end to end by Dice (at least
   0.99), both stated vacuous in the line where every served mask is
   empty; the stem and the union against their plain versions on that
   call's tensors; at NMS confidence 0.001 the union's masks against the
   plain union's (equal but within 1e-3 of the threshold) and the plain
   stem, epilogue and union's by Dice, at the served threshold and at the median
   logit inside the kept boxes, where positive pixels are required; the
   GIF's frames against the predictions, the figure's slice from
   ``seleccionar_mejor_corte``, and the files or the
   one warning a case as imageio and matplotlib import (a ``viz_18`` line
   says which). Then capacity mode (``entrenar_capacidad.main``, 3 epochs,
   batch 8: finite losses, ``best.pt``, finite metrics, the evaluation's
   union and stem launches, the micro-step's ms), the extras
   (``analizar_resultados`` on the demo's ``results/``,
   ``componer_resultados`` on phase 9's) and the native writer (built,
   100 PNGs of 218x182 with ``encode_gray``'s bytes, host seconds of each).
19. train_remat (run after phase 14): the model's ``remat`` against the
   stored step. YOLO11n-seg, 640, batch 16, ``max_fg`` 64, seeded weights,
   three fixed synthetic batches (each micro-step applies), in bf16 and in
   float32 with torch and cuDNN in their deterministic modes: the loss
   parts, every gradient as the optimizer half begins, every running
   statistic and the parameters and EMA after each micro-step, remat on
   against off, bit for bit, or it raises with the largest difference and
   whether the plain step repeats. Prints each micro-step's peak memory
   for both settings, the median seconds a bf16 micro-step (default modes;
   blocks off, on, on, off) and what ``batch -1`` resolves to (each from an
   empty cache) for scale n and for the widest of x and m whose probes fit,
   with the probes' peaks. No hand-written kernel launches (``train_remat``
   in ``launches_by_path``).

An ``enhancement`` line after phase 2 compares ``enhance_batch`` on the card
with the same call on the CPU for no enhancement, HE, GC, CLAHE and LT on
phase 2's slices: all must be equal (LT floors ``c*log1p(x)``, so a
one-ulp difference between the card's ``log1p`` and the CPU's would show
as a one-level flip).

Then the kernel summary line (per CLAHE dispatch: kernel and plain ms,
the CLAHE kernels' background-heavy ms, the bound and what bounds it;
``launches`` counts phase 6's fold, which those times belong to,
``launches_by_path`` each driven path's (``train_paralelo`` phase 16's,
``demo`` and ``capacidad`` phase 18's, ``train_remat`` phase 19's),
and ``cli_chain`` holds phase 9's
launches with the kernel's and the plain version's ms and the bound for one
patient's three launches of 50 images; the stem's ``scales`` holds phase
11's rows, bf16 with the f32 instance's ms, plain ms, bound and share beside
them; the fused epilogue's ``ms`` is one served forward's, as its
``work`` says; ``library_ms`` is null, as no single
PyTorch call computes any of the six functions: ``torchvision.ops.nms``,
where installed, is a dynamic-shape kernel whose ragged result is another
function, and the card's machine has no torchvision), the card's ``nvidia-smi`` name and power limit,
and last
``{"ok": true, "device": {...}}``. Any failure
raises and the script exits non-zero; without a CUDA device, or outside a
checkout of the repository, it exits non-zero before printing any result.
"""

from __future__ import annotations

import contextlib
import csv
import gc
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import types
import zlib
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
VOL_SHAPE = (182, 218, 182)
PLANES = ("axial", "coronal", "sagital")
PATIENTS = ("P39", "P18", "P07", "P12")  # the last serves 45 slices per plane
FOLD_PATIENTS = ("P1", "P2", "P3", "P4", "P5")  # fold 1 of 5; the last serves 45
CLI_PATIENTS = {"P1": 1, "P2": 1, "P28": 2, "P29": 2}  # patient -> fold of 2
CLI_K_FOLDS = 2
# the CLI phases' lesion box: 60 lesion slices a plane, of which stage 1
# keeps the centred N_PER_PLANE
CLI_LESION = (slice(60, 120), slice(80, 140), slice(60, 120))
CLI_CHECKED = "P2"  # the patient held against the direct calls
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
# the training figures (``train/plots.py``) a fold's directory holds where
# matplotlib imports: fold by fold (phase 15) and every fold at once (phase 16)
PARALLEL_FIGURES = {"results.png", "labels.jpg", "confusion_matrix.png",
                    "confusion_matrix_normalized.png"} | {
    f"{k}{c}.png" for k in ("Box", "Mask") for c in ("P_curve", "R_curve", "F1_curve", "PR_curve")}
SEQUENTIAL_FIGURES = PARALLEL_FIGURES | {
    "train_batch0.jpg", "train_batch1.jpg", "train_batch2.jpg", "val_batch0_labels.jpg",
    "val_batch0_pred.jpg"}
MIN_CHAIN_RAPIDO_DICE = 0.9  # the same patient through the chain and through rapido
STEM_SCALES = ("n", "s", "m", "l", "x")  # every instance of the fused stem
STEM_M = 200  # images a launch there: one plane of a served group
TRAIN_BATCHES = 8  # the fixed set of synthetic batches
TRAIN_PASSES = 6  # passes over it: 48 micro-steps
TRAIN_FIRST = 3  # micro-steps reported apart (cuDNN's choices, allocator growth)
# parameters phase 13 watches: a decayed kernel, a BatchNorm scale and bias,
# the class head's bias
TRAIN_PROBED = ("model.0.conv.weight", "model.2.cv1.bn.weight", "model.9.cv2.bn.bias",
                "model.23.cv3.0.2.bias")
# phase 14, card against CPU in f32 (the limits of the CPU tests that hold the
# port's step against the reference's)
TRAIN_F32_STEPS = 5  # micro-steps; the optimizer fires at 0, 1 and 3
TRAIN_F32_LOSS_RTOL = 1e-3  # every loss part (each above 0.1) at every micro-step
TRAIN_F32_BN_ATOL = 2e-4  # every BatchNorm running statistic
TRAIN_F32_UPDATE_SHARE = 0.1  # an element's update: within this of its leaf's largest
TRAIN_F32_OFF_SHARE = 0.01  # the share of a leaf's elements that may miss that
# BatchNorm biases whose gradient is zero analytically (the train-mode
# BatchNorm of the 1x1 convolution behind them removes a shift) and rounding
# noise numerically: AdamW gives their updates a random sign on either device
TRAIN_F32_NOISE = ("model.10.m.0.attn.pe.bn.bias", "model.10.m.0.attn.proj.bn.bias",
                   "model.10.m.0.ffn.1.bn.bias")
# kernel -> (its CUDA source, the Pallas kernel body it replaces)
KERNEL_SOURCES = {
    "mask_union": ("tpu_mslesseg_torch/csrc/mask_union.cu",
                   "tpu_mslesseg/infer/mask_union_pallas.py:88"),
    "clahe_tile_lut": ("tpu_mslesseg_torch/csrc/clahe_tile_lut.cu",
                       "tpu_mslesseg/preproc/clahe_pallas.py:27"),
    "clahe_blend": ("tpu_mslesseg_torch/csrc/clahe_tile_lut.cu",
                    "tpu_mslesseg/preproc/clahe_pallas.py:86"),
    "stem": ("tpu_mslesseg_torch/csrc/stem.cu", "tpu_mslesseg/model/stem_pallas.py:149"),
    "bn_act": ("tpu_mslesseg_torch/csrc/bn_act.cu", "tpu_mslesseg/model/blocks.py:51"),
    "nms": ("tpu_mslesseg_torch/csrc/nms.cu", "tpu_mslesseg/infer/nms.py:68 lax.while_loop"),
}
KERNELS = tuple(KERNEL_SOURCES)
SOURCES = tuple(dict.fromkeys(Path(src).stem for src, _ in KERNEL_SOURCES.values()))
NOTES = {"clahe_blend": "the reference's blend is the XLA apply outside pallas_call "
                        "(one-hot matmuls on the TPU's MXU), not a Pallas kernel",
         "bn_act": "replaces no Pallas kernel: the reference's Conv block leaves BatchNorm "
                   "and SiLU to XLA, which fuses them; the port's plain version is four "
                   "PyTorch passes (y.float(), batch_norm, silu, .to(dtype))",
         "nms": "replaces no Pallas kernel: the reference's suppression fixpoint is XLA's "
                "lax.while_loop, whose test stays on the device; the port's plain version "
                "runs its steps from the host, one bool read back a step. library_ms: none, "
                "torchvision.ops.nms is not installed and is a sequential, dynamic-shape "
                "kernel"}
# the unit of work of a kernel's `ms`, where it is not one CLAHE dispatch
WORKS = {"bn_act": "one plane's served forward of 200 images of 640 (the stem on): "
                   "every Conv block's epilogue"}
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


def patient_volume(pid: str, lesion=(slice(80, 100), slice(100, 130), slice(70, 110))):
    """The benchmark's synthetic patient (bench.py's fallback recipe), the
    mask a box over `lesion`."""
    rng = np.random.default_rng(zlib.crc32(pid.encode()))
    vol = rng.normal(500, 150, VOL_SHAPE).astype(np.float64)
    mask = np.zeros(VOL_SHAPE)
    mask[lesion] = 1
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
    """Bytes and operations of one fused-stem launch on x [M, S, S] with P2
    `out` of M x S/4 x S/4 positions of c1 channels (c0 = c1 / 2 at every
    published scale): input and P2 once; in bf16, b0 on the f32 pipe and b1
    on the tensor cores; in f32 both on the f32 pipe, so their times add."""
    m, h, w = x.shape
    c1 = out.numel() // (m * (h // 4) * (w // 4))
    c0 = c1 // 2
    b0 = 2.0 * m * (h // 2) * (w // 2) * c0 * 9
    b1 = 2.0 * m * (h // 4) * (w // 4) * c1 * c0 * 9
    if x.element_size() == 4:  # f32
        return work_bound(nbytes(x, out), {"b0_b1_f32_flops": (b0 + b1, F32_FLOPS)})
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


def ulps(torch, got, want):
    """|got - want| in units of the last place of the stored type (bf16 or
    f32), at the larger magnitude of the two."""
    bits = 7 if want.dtype == torch.bfloat16 else 23
    g, w = got.float(), want.float()
    _, e = torch.frexp(torch.maximum(g.abs(), w.abs()))
    ulp = torch.ldexp(torch.ones_like(w), (e - 1 - bits).clamp(min=-126 - bits))
    return (g - w).abs() / ulp


def epilogue_work(calls) -> dict:
    """Bytes and operations of the Conv blocks' fused epilogue over recorded
    calls (conv output, BN terms, act): each conv output read once and each
    result written once; about 4 f32 operations an element for BN and 4
    for SiLU (a negation, expf, a sum, a division), off the tensor cores."""
    moved = sum(2 * y.numel() * y.element_size() for y, _, _ in calls)
    ops = sum(y.numel() * (8.0 if act else 4.0) for y, _, act in calls)
    return work_bound(moved, {"f32_ops": (ops, F32_FLOPS)})


@contextlib.contextmanager
def recording_epilogues(P, calls):
    """For the duration, the Conv blocks' fused epilogue appends a copy of
    each conv output it is handed, with the BN terms and `act`, to `calls`
    before it runs."""
    real = P.bn_act.bn_act

    def record(y, bn, act, out=None):
        terms = types.SimpleNamespace(**{k: getattr(bn, k) for k in
                                         ("running_mean", "running_var", "weight", "bias", "eps")})
        calls.append((y.clone(), terms, act))
        return real(y, bn, act, out)

    with switched(P.bn_act, "bn_act", record):
        yield


def bn_act_checks(torch, P, calls, reps_k: int, reps_p: int) -> dict:
    """The fused epilogue on each recorded call, into a fresh output,
    against its plain version: the elements that differ and the largest
    difference in ulps of the stored type (at most 1, or this raises); then
    all the calls timed, kernel against plain, with their bound: {"errs",
    "work", "ms", "plain_ms", "launches"}."""
    ba = P.bn_act
    outs = [torch.empty_like(y) for y, _, _ in calls]
    errs = {"max_abs_err": 0.0, "max_ulp": 0.0, "elements_differing": 0, "elements": 0}
    for (y, t, act), o in zip(calls, outs):
        got, want = ba.bn_act(y, t, act, out=o), ba.bn_act_ref(y, t, act)
        torch.cuda.synchronize()
        errs["max_abs_err"] = max(errs["max_abs_err"], float((got.float() - want.float()).abs().max()))
        errs["max_ulp"] = max(errs["max_ulp"], float(ulps(torch, got, want).max()))
        errs["elements_differing"] += int((got != want).sum())
        errs["elements"] += got.numel()
        del got, want
    if errs["max_ulp"] > 1.0:
        raise AssertionError(f"the fused BN + SiLU differs from its plain version by more than "
                             f"one ulp: {errs}")

    def run_k():
        for (y, t, act), o in zip(calls, outs):
            ba.bn_act(y, t, act, out=o)

    def run_p():
        for y, t, act in calls:
            ba.bn_act_ref(y, t, act)

    k_ms, p_ms = timed_pair(torch, run_k, run_p, reps_k, reps_p)
    return {"errs": errs, "work": epilogue_work(calls), "ms": float(np.median(k_ms)),
            "plain_ms": float(np.median(p_ms)), "kernel_ms_blocks": k_ms, "plain_ms_blocks": p_ms,
            "launches": len(calls)}


# NMS: the deep chain's links (the plain fixpoint takes about a step a link),
# the thresholds of the pairs at and beside the threshold (0.3 rounds up in
# float32, so it tells a float32 comparison from a float64 one), and the
# float32 operations of an IoU against the threshold (two max, two min, two
# differences and two clamps for the overlap, a product, a sum, a
# difference, a clamp, the division, the comparison)
NMS_CHAIN = 250
NMS_PAIR_THRESHOLDS = (0.7, 0.3, 0.45)
NMS_OPS_PER_PAIR = 14


@contextlib.contextmanager
def recording_nms(P, calls):
    """For the duration, each ``nms_batch`` call of the predictors appends
    {"args": its arguments, "suppress": (top boxes, valid, iou) as its
    suppression got them} to `calls`."""
    real_batch, real_suppress = P.nms.nms_batch, P.nms.suppress

    def batch(*args):
        calls.append({"args": args})
        return real_batch(*args)

    def suppress(top, valid, iou):
        calls[-1]["suppress"] = (top, valid, iou)
        return real_suppress(top, valid, iou)

    with switched(P.predictor, "nms_batch", batch), switched(P.nms, "suppress", suppress):
        yield


def nms_work(top, valid) -> dict:
    """Bytes and operations of one suppression launch: the top boxes and
    `valid` read once, keep written once; an IoU against the threshold for
    each pair of valid candidates (``NMS_OPS_PER_PAIR`` float32 operations,
    the division counted as one), off the tensor cores."""
    n = valid.sum(1).double()
    pairs = float((n * (n - 1) / 2).sum())
    return work_bound(nbytes(top, valid) + valid.numel(),
                      {"f32_ops": (NMS_OPS_PER_PAIR * pairs, F32_FLOPS)})


def nms_against_plain(torch, P, args) -> dict:
    """``nms_batch(*args)`` through the kernel against the same call with
    the plain suppression, both on the card: keep, indices, boxes and scores
    bit for bit, or this raises. Returns the counts and the plain fixpoint's
    steps."""
    steps = []

    def plain(top, valid, iou):
        keep, n = P.nms.suppress_ref_steps(top, valid, iou)
        steps.append(n)
        return keep

    got = P.nms.nms_batch(*args)
    with switched(P.nms, "suppress", plain):
        want = P.nms.nms_batch(*args)
    torch.cuda.synchronize()
    differing = sum(int((g != w).sum()) for g, w in zip(got, want))
    if differing:
        raise AssertionError(f"NMS through the kernel differs from the plain version in "
                             f"{differing} elements (conf {args[2]}, iou {args[3]})")
    keep = got[2]
    return {"images": int(keep.shape[0]), "kept_per_image": float(keep.sum()) / keep.shape[0],
            "plain_steps": steps[0], "elements_differing": 0}


def nms_checks(torch, P, calls, reps_k: int, reps_p: int) -> dict:
    """Each recorded ``nms_batch`` call (``recording_nms``) against the plain
    version (``nms_against_plain``), then its suppression timed: the
    kernel's as CUDA-graph replays (the wrapper's host cost exceeds the
    kernel), the plain version by events around its host loop. Returns
    {"errs", "work", "ms", "plain_ms", "call_ms"}, summed over the calls."""
    errs = {"max_abs_err": 0.0, "elements_differing": 0, "plain_steps": []}
    ms = plain_ms = call_ms = 0.0
    for c in calls:
        read = nms_against_plain(torch, P, c["args"])
        errs["plain_steps"].append(read["plain_steps"])
        top, valid, iou = c["suppress"]
        run_k = lambda: P.nms.suppress(top, valid, iou)
        k_ms, p_ms = timed_pair(torch, run_k, lambda: P.nms.suppress_ref(top, valid, iou),
                                reps_k, reps_p)
        ms += graph_ms(torch, run_k, reps_k)
        plain_ms += float(np.median(p_ms))
        call_ms += float(np.median(k_ms))
    errs["kept_per_image"] = read["kept_per_image"]
    return {"errs": errs, "work": summed([nms_work(*c["suppress"][:2]) for c in calls]),
            "ms": ms, "plain_ms": plain_ms, "call_ms": call_ms}


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



def cli_args(plano: str, *extra) -> list:
    return ["--plano", plano, "--modalidad", "FLAIR", "--num_cortes", str(N_PER_PLANE),
            "--mejora", "CLAHE", "--epochs", str(EPOCHS), "--k_folds", str(CLI_K_FOLDS),
            "--completo", *extra]


def run_cli(orch, root: Path, plano: str, *extra) -> None:
    """The orchestrator's ``main`` in-process from `root`, as ``python -m
    tpu_mslesseg_torch.pipeline.ejecutar_pipeline`` runs it there. A failed
    run raises ``SystemExit(1)``, which ends this script with that code."""
    cwd = os.getcwd()
    os.chdir(root)
    try:
        orch.main(cli_args(plano, *extra))
    finally:
        os.chdir(cwd)


def write_cli_inputs(root: Path, P) -> dict:
    """Phase 9's inputs under `root`: the dataset (FLAIR and mask volumes;
    stage 0 builds ``GT/`` from them) and a ``best.pt`` per plane and fold,
    one seed a plane. Returns {plane: Modelo}."""
    ds = root / "MSLesSeg-Dataset" / "train"
    modelo = {p: P.Modelo(plano=p, num_cortes=N_PER_PLANE, modalidad=["FLAIR"],
                          k_folds=CLI_K_FOLDS, mejora="CLAHE") for p in PLANES}
    for pid in CLI_PATIENTS:
        vol, gt = patient_volume(pid, CLI_LESION)
        P.nifti.save(vol.astype(np.float32), np.eye(4), ds / pid / "T1" / f"{pid}_T1_FLAIR.nii.gz")
        P.nifti.save(gt.astype(np.uint8), np.eye(4), ds / pid / "T1" / f"{pid}_T1_MASK.nii.gz")
    model, _ = P.create_model(nc=1, scale="n")
    for k, p in enumerate(PLANES):
        sd = P.init_variables(model, seed=20 + k)
        for i in range(len(P.STRIDES)):  # no class prior: NMS keeps detections
            sd[f"model.23.cv3.{i}.2.bias"].zero_()
        for fold in sorted(set(CLI_PATIENTS.values())):
            cfg = P.ConfigTrain(modelo=modelo[p], epochs=EPOCHS, fold_test=fold, root=root)
            P.save_checkpoint(cfg.best_ckpt, sd)
    return modelo


def tree(root: Path, *tops) -> set:
    return {p.relative_to(root) for d in tops for p in (root / d).rglob("*") if p.is_file()}


def expected_cli_tree(root: Path, P, modelo, pred_masks: bool) -> tuple:
    """(files under datasets/, files under pred_vols/ and results/) a
    complete three-plane run leaves, and {(pid, plane): slice indices}."""
    exp = f"{modelo['axial'].base_path}_{EPOCHS}epochs"
    kinds = PLANES + ("consenso",)
    data, out, indices = set(), set(), {}
    for pid, fold in CLI_PATIENTS.items():
        for p in PLANES:
            pac = P.Paciente(id=pid, plano=p, modalidad=["FLAIR"],
                             dataset_dir=root / "MSLesSeg-Dataset" / "train")
            ids = indices[pid, p] = pac.indices_a_usar(N_PER_PLANE)
            d = Path("datasets") / modelo[p].base_path / f"fold{fold}" / pid / p
            for i in ids:
                data |= {d / "images" / f"{pid}_FLAIR_{i}.png", d / "GT_masks" / f"{pid}_{i}.png",
                         d / "labels" / f"{pid}_{i}.txt"}
                if pred_masks:
                    data.add(d / "pred_masks" / f"{pid}_FLAIR_{i}.png")
        for k in kinds:
            out |= {Path("pred_vols") / exp / f"fold{fold}" / pid / f"{pid}_{k}.nii.gz",
                    Path("results") / exp / f"fold{fold}" / pid / f"{pid}_{k}_results.json"}
    for k in kinds:
        out.add(Path("results") / exp / f"global_{k}_results.json")
        for fold in set(CLI_PATIENTS.values()):
            out.add(Path("results") / exp / f"fold{fold}" / f"fold{fold}_{k}_results.json")
    return data, out, indices


def check_tree(got: set, want: set, what: str) -> None:
    if got != want:
        raise AssertionError(f"{what}: extra {sorted(map(str, got - want))[:8]}, "
                             f"missing {sorted(map(str, want - got))[:8]}")


def check_volumes_and_jsons(torch, root: Path, P, modelo, dev) -> dict:
    """Every volume on disk is binary and of the GT's shape, every consensus
    is the vote of its three plane volumes, and every patient JSON holds the
    metrics of the counts of the volume beside it. Returns the volumes
    {(pid, kind): uint8 array}."""
    exp = f"{modelo['axial'].base_path}_{EPOCHS}epochs"
    vols = {}
    for pid, fold in CLI_PATIENTS.items():
        gt = P.nifti.load(root / "GT" / "train" / pid / f"{pid}_MASK.nii.gz").data
        if gt.shape != VOL_SHAPE:
            raise AssertionError(f"{pid}: GT of shape {gt.shape}")
        gt_dev = torch.from_numpy(np.ascontiguousarray(gt)).to(dev)
        on_dev = {}
        for k in PLANES + ("consenso",):
            img = P.nifti.load(root / "pred_vols" / exp / f"fold{fold}" / pid / f"{pid}_{k}.nii.gz")
            if img.shape != VOL_SHAPE or not np.isin(img.data, (0, 1)).all() or not img.data.any():
                raise AssertionError(f"{pid}/{k}: not a filled binary volume of the GT's shape")
            if not np.array_equal(img.affine, np.eye(4)):
                raise AssertionError(f"{pid}/{k}: the affine is not the GT's")
            vols[pid, k] = img.data.astype(np.uint8)
            on_dev[k] = torch.from_numpy(vols[pid, k]).to(dev)
            met = json.loads((root / "results" / exp / f"fold{fold}" / pid
                              / f"{pid}_{k}_results.json").read_text())
            want = P.mx.metrics_from_counts(P.mx.confusion_counts(gt_dev, on_dev[k]))
            if json.dumps(met) != json.dumps(want):
                raise AssertionError(f"{pid}/{k}: JSON {met} != metrics of the volume {want}")
        vote = P.consensus_vote(*(on_dev[p] for p in PLANES), 2)
        if not torch.equal(vote, on_dev["consenso"]):
            raise AssertionError(f"{pid}: the consensus is not the vote of the plane volumes")
    return vols


def phase_enhancement(torch, enhance, slices, dev) -> None:
    """``enhance_batch`` on the card against the same call on the CPU, on
    phase 2's slices."""
    differing, px = {}, 0
    for p in PLANES:
        x = torch.from_numpy(slices[p].reshape((-1,) + slices[p].shape[2:]).astype(np.float32))
        px += x.numel()
        for mejora in (None, "HE", "GC", "CLAHE", "LT"):
            card = enhance.enhance_batch(x.to(dev), mejora).cpu()
            host = enhance.enhance_batch(x, mejora)
            key = mejora or "none"
            differing[key] = differing.get(key, 0) + int((card != host).sum())
    emit({"phase": "enhancement", "what": "enhance_batch on the card vs on the CPU",
          "pixels": px, "px_differing": differing})
    if any(differing.values()):
        raise AssertionError(f"enhancement differs between card and CPU: {differing}")


def chain_kernel_checks(torch, P, pred, raw) -> dict:
    """The six kernels against their plain versions at the shapes one
    stage-3 call gives them (`raw`: one patient's slices of one plane on
    the card, `pred` the plane's ``SlicePredictor``), on that call's own
    tensors, and their times there: {kernel: {"errs", "ms", "plain_ms",
    "work"}}. Raises where a kernel disagrees."""
    dev, smodel, out = raw.device, pred.model, {}
    # CLAHE: the L images of the enhancement that stages 1 and 3 run
    bwd = torch.from_numpy(P.enhance._LAB_BWD).to(dev)
    l_img = torch.from_numpy(P.enhance._LAB_FWD).to(dev)[P.enhance.normalize_to_uint8(raw).long()]
    luts, want = P.clahe.clahe_tile_luts(l_img), P.clahe.clahe_tile_luts_ref(l_img)
    got_b, want_b = P.clahe.clahe_blend(l_img, luts, bwd), P.clahe.clahe_blend_ref(l_img, want, bwd)
    torch.cuda.synchronize()
    if not torch.equal(luts, want):
        raise AssertionError("CLAHE LUTs differ from the plain version on a stage-3 call's images")
    if not torch.equal(got_b, want_b):
        raise AssertionError("CLAHE blend differs from the plain version on a stage-3 call's images")
    out["clahe_tile_lut"] = {
        "errs": {"max_abs_err": 0.0}, "work": clahe_work(l_img, luts),
        "ms": graph_ms(torch, lambda: P.clahe.clahe_tile_luts(l_img), 20),
        "plain_ms": cuda_ms(torch, lambda: P.clahe.clahe_tile_luts_ref(l_img), 5)}
    out["clahe_blend"] = {
        "errs": {"max_abs_err": 0.0}, "work": blend_work(l_img, luts, got_b),
        "ms": graph_ms(torch, lambda: P.clahe.clahe_blend(l_img, luts, bwd), 20),
        "plain_ms": cuda_ms(torch, lambda: P.clahe.clahe_blend_ref(l_img, luts, bwd), 5)}
    # the stem's input and the union's, as SlicePredictor.__call__ makes them
    u8 = P.enhance.enhance_for_model(raw, "CLAHE")
    x = pred.lb.apply(P.geometry.to_png_space_batch(u8).to(torch.float32) / 255.0).to(smodel.dtype)
    got, want = P.stem.stem_apply(smodel, pred._stem_w, x), P.stem.stem_reference(smodel, pred._stem_w, x)
    torch.cuda.synchronize()
    errs = stem_errors(torch, P.stem, smodel, pred._stem_w, x, got, want)
    k_ms, p_ms = timed_pair(torch, lambda: P.stem.stem_apply(smodel, pred._stem_w, x),
                            lambda: P.stem.stem_reference(smodel, pred._stem_w, x), 5, 3)
    out["stem"] = {"errs": errs, "work": stem_work(x, got), "ms": float(np.median(k_ms)),
                   "plain_ms": float(np.median(p_ms))}
    rec, epilogues, nms_calls = Recorder(P.mu.mask_union_logits_batch), [], []
    with recording_epilogues(P, epilogues), recording_nms(P, nms_calls), torch.inference_mode():
        P.detect_and_union(smodel, pred.variables, x[..., None], pred.imgsz, pred.conf, pred.iou,
                           pred.max_det, mask_union=rec, stem_w=pred._stem_w)
    out["bn_act"] = bn_act_checks(torch, P, epilogues, 3, 2)
    out["nms"] = nms_checks(torch, P, nms_calls, 20, 3)
    del epilogues, nms_calls
    call, got = rec.last[:5], rec.last[5]
    want = P.mu.mask_union_logits_ref(*call)
    torch.cuda.synchronize()
    errs = check_union(torch, P.mu, call, got, want)
    errs["kept_per_image"] = float(call[3].sum()) / call[3].shape[0]
    k_ms, p_ms = timed_pair(torch, lambda: P.mu.mask_union_logits_batch(*call),
                            lambda: P.mu.mask_union_logits_ref(*call), 10, 3)
    out["mask_union"] = {"errs": errs, "work": union_work(torch, P.mu, *call, got),
                         "ms": float(np.median(k_ms)), "plain_ms": float(np.median(p_ms))}
    return out


def check_labels(P, d: Path, pid: str, ids) -> dict:
    """Every label file stage 1 wrote under `d` (one patient and plane)
    against ``write_yolo_seg_label_ref`` on its slice's GT PNG, byte for
    byte; returns the files' bytes and the seconds of the plain writer and
    of stage 1's writer on the same masks."""
    out = {"files": len(ids), "bytes": 0, "ref_writer_s": 0.0, "writer_s": 0.0}
    with tempfile.TemporaryDirectory(prefix="labels_ref_") as tmp:
        for i in ids:
            gt = P.png.load_gray(d / "GT_masks" / f"{pid}_{i}.png")
            for key, write in (("ref_writer_s", P.labels.write_yolo_seg_label_ref),
                               ("writer_s", P.labels.write_yolo_seg_label)):
                t0 = time.perf_counter()
                write(gt, Path(tmp) / f"{key}.txt")
                out[key] += time.perf_counter() - t0
            got = (d / "labels" / f"{pid}_{i}.txt").read_bytes()
            if got != (Path(tmp) / "ref_writer_s.txt").read_bytes():
                raise AssertionError(f"{d / 'labels'}: slice {i}'s label file differs from "
                                     "write_yolo_seg_label_ref on its GT mask")
            out["bytes"] += len(got)
    return out


def phase_cli_chain(torch, P, root: Path, counters, dev) -> dict:
    """Phase 9: three planes through ``main(... --completo --sin_rapido)``."""
    t0 = time.perf_counter()
    modelo = write_cli_inputs(root, P)
    setup_s = time.perf_counter() - t0
    exp = f"{modelo['axial'].base_path}_{EPOCHS}epochs"
    P.profiling.reset_timings()
    zero_launches(counters)
    plane_s, consensus_after, stage1_s = {}, {}, {}
    for p in PLANES:
        s1, t0 = stage1_total(P), time.perf_counter()
        run_cli(P.orch, root, p, "--sin_rapido")
        torch.cuda.synchronize()
        plane_s[p] = time.perf_counter() - t0
        stage1_s[p] = stage1_total(P) - s1
        consensus_after[p] = sum("consenso" in f.name for f in tree(root, "pred_vols"))
    launches = read_launches(counters)
    timings = P.profiling.timings_summary()
    for k, n in launches.items():
        if n < 1:
            raise AssertionError(f"the CLI's stage chain did not launch the {k} kernel")
    if [consensus_after[p] for p in PLANES] != [0, 0, len(CLI_PATIENTS)]:
        raise AssertionError(f"consensus volumes after each plane: {consensus_after}")

    want_data, want_out, indices = expected_cli_tree(root, P, modelo, pred_masks=True)
    check_tree(tree(root, "datasets"), want_data, "datasets/")
    check_tree(tree(root, "pred_vols", "results"), want_out, "pred_vols/ and results/")
    if any(len(ids) != N_PER_PLANE for ids in indices.values()):
        raise AssertionError("stage 1 did not keep 50 slices a plane")
    vols = check_volumes_and_jsons(torch, root, P, modelo, dev)
    label_bytes = sum((root / f).stat().st_size for f in want_data if f.suffix == ".txt")

    # one patient against the direct calls, plane by plane
    pid, fold = CLI_CHECKED, CLI_PATIENTS[CLI_CHECKED]
    labels_checked = check_labels(
        P, root / "datasets" / modelo[PLANES[0]].base_path / f"fold{fold}" / pid / PLANES[0],
        pid, indices[pid, PLANES[0]])
    smodel, _, imgsz = P.create_model_from_env()
    kept, at_call = 0.0, {}
    for p in PLANES:
        pac = P.Paciente(id=pid, plano=p, modalidad=["FLAIR"], mejora="CLAHE",
                         dataset_dir=root / "MSLesSeg-Dataset" / "train")
        ids = indices[pid, p]
        raw = torch.from_numpy(pac.cortes_imagen_batch(ids, "FLAIR"))
        d = root / "datasets" / modelo[p].base_path / f"fold{fold}" / pid / p
        # stage 1 ran on the card: the same enhancement on the CPU
        host = P.geometry.minmax_to_uint8(
            P.geometry.to_png_space_batch(P.enhance.enhance_batch(raw, "CLAHE"))).numpy()
        for j, i in enumerate(ids):
            if not np.array_equal(P.png.load_gray(d / "images" / f"{pid}_FLAIR_{i}.png"), host[j]):
                raise AssertionError(f"{pid}/{p}: stage-1 image {i} != the CPU's enhancement")
        cfg = P.ConfigTrain(modelo=modelo[p], epochs=EPOCHS, fold_test=fold, root=root)
        pred = P.SlicePredictor(smodel, P.load_checkpoint(cfg.best_ckpt), tuple(raw.shape[1:]),
                                imgsz=imgsz, device=dev)
        if pred._stem_w is None:
            raise AssertionError("the direct predictor did not take the fused stem")
        masks = pred(P.enhance.enhance_for_model(raw.to(dev), "CLAHE"))
        stored = np.stack([P.png.load_pred_png(d / "pred_masks" / f"{pid}_FLAIR_{i}.png")
                           for i in ids])
        if not np.array_equal(stored > 0, masks.cpu().numpy()):
            raise AssertionError(f"{pid}/{p}: stage-3 masks != a direct SlicePredictor call")
        kept += float(masks.float().mean())
        vol = P.reconstruct_volume(VOL_SHAPE, masks.to(torch.float32), p, ids)
        if not np.array_equal(vol.cpu().numpy().astype(np.uint8), vols[pid, p]):
            raise AssertionError(f"{pid}/{p}: stage-4 volume != reconstruct_volume of the masks")
        # the kernels at this call's shapes (stage 3 serves a patient's 50
        # slices a call, the earlier phases 200 or 600)
        at_call[p] = chain_kernel_checks(torch, P, pred, raw.to(dev))
    if not kept > 0:
        raise AssertionError("the checked patient's masks are empty in every plane")

    # a second run of one plane writes nothing
    files = sorted(tree(root, "datasets", "pred_vols", "results"))
    before = [(root / f).stat().st_mtime_ns for f in files]
    t0 = time.perf_counter()
    run_cli(P.orch, root, PLANES[0], "--sin_rapido")
    rerun_s = time.perf_counter() - t0
    if sorted(tree(root, "datasets", "pred_vols", "results")) != files or \
            [(root / f).stat().st_mtime_ns for f in files] != before:
        raise AssertionError("a second run of one plane wrote files")

    # what PIPELINE_DEPTH buys: stage 3 of one fold again, depth 4 and 1 in turns
    depth_s = {4: [], 1: []}
    cfg = P.ConfigPred(modelo=modelo[PLANES[0]], epochs=EPOCHS, k_folds=CLI_K_FOLDS,
                       fold_test=1, root=root)
    for depth in (4, 1, 1, 4):
        with switched(P.gen, "PIPELINE_DEPTH", depth):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = P.gen.ejecutar_flujo_pred(cfg, limpiar=True, device=dev)
            torch.cuda.synchronize()
            depth_s[depth].append(time.perf_counter() - t0)
        if res is not True:
            raise AssertionError(f"stage 3 with limpiar returned {res}")
    P.logging_setup.configure_logging(log_file=None)  # let go of <root>/pipeline.log

    # a patient's three stage-3 calls (one a plane), summed as one unit of work
    per_call = {
        k: {"work": f"stage 3 for one patient: 3 launches of {N_PER_PLANE} images, one a plane",
            "launches_in_the_three_plane_runs": launches[k],
            "max_abs_err": max(at_call[p][k]["errs"]["max_abs_err"] for p in PLANES),
            "ms": sum(at_call[p][k]["ms"] for p in PLANES),
            "plain_ms": sum(at_call[p][k]["plain_ms"] for p in PLANES),
            **{key: v for key, v in summed([at_call[p][k]["work"] for p in PLANES]).items()
               if key in ("bound_ms", "bound_by")}}
        for k in KERNELS}

    emit({"phase": "cli_chain", "mejora": "CLAHE", "patients": len(CLI_PATIENTS),
          "k_folds": CLI_K_FOLDS, "slices_per_plane": N_PER_PLANE, "launches": launches,
          "consensus_volumes_after_each_plane": consensus_after,
          "files": {"datasets": len(want_data), "pred_vols_and_results": len(want_out)},
          "checked_patient": pid, "second_run_wrote_nothing": True,
          "label_files_equal_the_plain_writer": {"plane": PLANES[0], **labels_checked},
          "kernels_vs_plain_at_a_stage3_call": {
              k: {p: at_call[p][k]["errs"] for p in PLANES} for k in KERNELS},
          "kernels_per_patient": per_call,
          "informational": {"setup_s": setup_s, "plane_s": plane_s, "rerun_s": rerun_s,
                            "stage1_s_by_plane": stage1_s, "label_bytes": label_bytes,
                            "ref_writer_s_one_patient_plane": labels_checked["ref_writer_s"],
                            "stage_timings": timings,
                            "stage3_fold_s_by_pipeline_depth": depth_s, **card_label(torch)}})
    return {"modelo": modelo, "vols": vols, "launches": launches, "timings": timings,
            "kernels": per_call}


def stage1_total(P) -> float:
    """Stage 1's seconds so far (``extraer_dataset``'s timer)."""
    return P.profiling.timings_summary().get("extraer_dataset", {}).get("total_s", 0.0)


def phase_cli_default(torch, P, chain_root: Path, root: Path, chain: dict, counters, dev) -> dict:
    """Phase 10: the three planes through ``main(... --completo)`` on a copy
    of phase 9's inputs and stage-1 output."""
    shutil.copytree(chain_root, root, ignore=shutil.ignore_patterns(
        "pred_masks", "pred_vols", "results", "pipeline.log"))
    modelo = chain["modelo"]
    P.profiling.reset_timings()
    zero_launches(counters)
    plane_s = {}
    for p in PLANES:
        t0 = time.perf_counter()
        run_cli(P.orch, root, p)
        torch.cuda.synchronize()
        plane_s[p] = time.perf_counter() - t0
    launches = read_launches(counters)
    timings = P.profiling.timings_summary()
    P.logging_setup.configure_logging(log_file=None)
    for k, n in launches.items():
        if n < 1:
            raise AssertionError(f"the CLI's default path did not launch the {k} kernel")
    folds = sorted(set(CLI_PATIENTS.values()))
    if not all(f"rapido_fold{k}" in timings for k in folds) or \
            any(name.startswith("predicciones_fold") for name in timings):
        raise AssertionError(f"rapido did not serve every fold: {sorted(timings)}")

    want_data, want_out, _ = expected_cli_tree(root, P, modelo, pred_masks=False)
    check_tree(tree(root, "datasets"), want_data, "datasets/ (no prediction PNGs)")
    check_tree(tree(root, "pred_vols", "results"), want_out, "pred_vols/ and results/")
    vols = check_volumes_and_jsons(torch, root, P, modelo, dev)
    dices = {pid: {k: dice(vols[pid, k], chain["vols"][pid, k]) for k in PLANES + ("consenso",)}
             for pid in CLI_PATIENTS}
    worst = min(d["consenso"] for d in dices.values())
    emit({"phase": "cli_default", "mejora": "CLAHE", "patients": len(CLI_PATIENTS),
          "launches": launches, "files": {"pred_vols_and_results": len(want_out)},
          "dice_rapido_vs_chain": dices, "min_consensus_dice": MIN_CHAIN_RAPIDO_DICE,
          "voxels_differing": {pid: {k: int((vols[pid, k] != chain["vols"][pid, k]).sum())
                                     for k in PLANES + ("consenso",)} for pid in CLI_PATIENTS},
          "informational": {"plane_s": plane_s, "stage_timings": timings,
                            "chain_stage_timings": chain["timings"], **card_label(torch)}})
    if worst < MIN_CHAIN_RAPIDO_DICE:
        raise AssertionError(f"rapido vs chain: consensus Dice {worst} below "
                             f"{MIN_CHAIN_RAPIDO_DICE}")
    return {"launches": launches}


def phase_stem_scales(torch, P, gen, dev, card) -> dict:
    """Phase 11: the fused stem's instances of scales n, s, m, l and x against
    ``model.0``/``model.1`` (BN statistics perturbed) at 200 images of 640,
    in f32 and in bf16, each instance's time and bound; first the branch-free
    SiLU (the f32 kernel's at n, the bf16 wide kernel's) against the plain
    one on every f32 input.
    Returns {scale: the bf16 row, with the f32 instance's ms, plain ms, bound
    and share of it}."""
    bad = P.stem.bf16_activation_mismatches(dev)
    emit({"phase": "stem_activation_check", "inputs": 2 ** 32, "mismatches": bad,
          "compared": "silu_branch_free (with its fallback) against y / (1 + expf(-y)), bits"})
    if bad:
        raise AssertionError(f"stem: the branch-free SiLU differs on {bad} f32 inputs")
    x32 = torch.rand((STEM_M, IMGSZ, IMGSZ), generator=gen).to(dev)
    rows = {}
    for scale in STEM_SCALES:
        base, _ = P.create_model(nc=1, scale=scale)
        sd = perturbed_stem(torch, P.fold_gray_stem(P.init_variables(base, seed=7)), 8)
        w = P.stem.stem_weights({k: v.to(dev) for k, v in sd.items()
                                 if k.startswith(("model.0.", "model.1."))})
        c0, c1 = P.stem.instance_of(w)
        del base, sd
        f32_ms = {}
        for dtype in (torch.float32, torch.bfloat16):
            smodel, _ = P.create_model(nc=1, scale=scale, dtype=dtype)
            x = x32.to(dtype)
            before = P.stem.LAUNCHES
            got = P.stem.stem_apply(smodel, w, x)
            want = P.stem.stem_reference(smodel, w, x)
            torch.cuda.synchronize()
            if P.stem.LAUNCHES != before + 1:
                raise AssertionError(f"stem scale {scale}: the wrapper did not launch its kernel")
            if tuple(got.shape) != (STEM_M, c1, IMGSZ // 4, IMGSZ // 4) or got.dtype != dtype:
                raise AssertionError(f"stem scale {scale}: output {tuple(got.shape)} {got.dtype}")
            if not got.is_contiguous(memory_format=torch.channels_last):
                raise AssertionError(f"stem scale {scale}: output is not channels-last")
            errs = stem_errors(torch, P.stem, smodel, w, x, got, want)
            name = str(dtype).removeprefix("torch.")
            emit({"phase": "stem_kernel", "scale": scale, "c0_c1": [c0, c1], "dtype": name,
                  "m": STEM_M, "imgsz": IMGSZ, **errs,
                  "bound": "atol=rtol=2e-5" if dtype == torch.float32
                  else "1 bf16 ulp of the conv sum through BN and SiLU, + 1 of the output"})
            work = stem_work(x, got)
            del got, want
            torch.cuda.empty_cache()
            k_ms, p_ms = timed_pair(torch, lambda: P.stem.stem_apply(smodel, w, x),
                                    lambda: P.stem.stem_reference(smodel, w, x), 5, 3)
            emit({"phase": "timing", "kernel": "stem", "scale": scale, "m": STEM_M,
                  "imgsz": IMGSZ, "dtype": name, "kernel_ms": k_ms, "plain_ms": p_ms, **card})
            ms = float(np.median(k_ms))
            emit_bound("stem", work, ms, 1, f"scale {scale} {name}: one launch of {STEM_M} "
                                            f"random images of {IMGSZ}")
            if dtype == torch.float32:
                f32_ms = {"f32_ms": ms, "f32_plain_ms": float(np.median(p_ms)),
                          "f32_bound_ms": work["bound_ms"], "f32_bound_by": work["bound_by"],
                          "f32_share_of_bound": work["bound_ms"] / ms,
                          "f32_max_abs_err": errs["max_abs_err"], "f32_launches": 1}
            else:
                rows[scale] = {"c0_c1": [c0, c1], "m": STEM_M, "ms": ms,
                               "plain_ms": float(np.median(p_ms)), "bytes": work["bytes"],
                               "bound_ms": work["bound_ms"], "bound_by": work["bound_by"],
                               "share_of_bound": work["bound_ms"] / ms,
                               "max_abs_err": errs["max_abs_err"], **f32_ms}
            del x, smodel
            torch.cuda.empty_cache()
    return rows


def phase_lote_wide(torch, P, slices, idx, gts, counters, dev, scale: str, dtype) -> dict:
    """Phase 12: one served ``ConsensusPredictor.lote`` at `scale` in `dtype`
    (640, GC, two patients) with the fused stem switched on: the predictor
    is built with the stem's weights, the stem kernel launches once, and the
    result is held against the same call with the stem off."""
    model, _ = P.create_model(nc=1, scale=scale, dtype=dtype)
    variables = P.init_variables(model, seed=9)
    for i in range(len(P.STRIDES)):  # no class prior: NMS keeps detections
        variables[f"model.23.cv3.{i}.2.bias"].zero_()
    n_pat = 2
    sl = {p: v[:n_pat] for p, v in slices.items()}
    ix = {p: v[:n_pat] for p, v in idx.items()}
    kw = dict(mejora="GC", imgsz=IMGSZ, umbral=2, per_plane_counts=True, device=dev)
    with switched(P.stem, "ENABLED", True):
        cp_on = P.ConsensusPredictor(model, variables, VOL_SHAPE, **kw)
    with switched(P.stem, "ENABLED", False):
        cp_off = P.ConsensusPredictor(model, variables, VOL_SHAPE, **kw)
    what = f"scale {scale} {str(dtype).removeprefix('torch.')}"
    if cp_on._stem_w is None or cp_off._stem_w is not None:
        raise AssertionError(f"{what}: the switch did not decide the predictor's stem")
    zero_launches(counters)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    counts, cons, vols = cp_on.lote(sl, ix, gts[:n_pat])
    torch.cuda.synchronize()
    lote_s = time.perf_counter() - t0
    launches = read_launches(counters)
    if launches["stem"] != 1 or launches["mask_union"] < 1:
        raise AssertionError(f"{what}: launches {launches}")
    _, off_cons, off_vols = cp_off.lote(sl, ix, gts[:n_pat])
    torch.cuda.synchronize()
    n_vox = int(np.prod(VOL_SHAPE))
    if tuple(cons.shape) != (n_pat,) + VOL_SHAPE or not bool(cons.any()):
        raise AssertionError(f"{what}: the consensus is empty or of the wrong shape")
    for key, c in counts.items():
        if not (bool(torch.isfinite(c).all()) and bool((c.sum(1) == n_vox).all())):
            raise AssertionError(f"{what}: counts of {key} do not cover the volume")
    dices = {k: dice(cons if k == "consenso" else vols[k], off_cons if k == "consenso"
                     else off_vols[k]) for k in PLANES + ("consenso",)}
    emit({"phase": f"lote_scale_{scale}", "scale": scale,
          "dtype": str(dtype).removeprefix("torch."), "patients": n_pat,
          "launches": launches, "dice_stem_on_vs_off": dices, "min_consensus_dice": MIN_DICE,
          "informational": {"lote_s": lote_s, **card_label(torch)}})
    if dices["consenso"] < MIN_DICE:
        raise AssertionError(f"{what}, stem on vs off: consensus Dice {dices} below {MIN_DICE}")
    if dtype == torch.float32:
        lote_default_flags(torch, cp_on, (sl, ix, gts[:n_pat]), (counts, cons, vols), scale)
    return launches


def lote_default_flags(torch, cp, args, want, scale: str) -> None:
    """Phase 12, float32: the same ``lote`` under PyTorch's default TF32
    flags (cuDNN's on, the matrix products' off; this script turns both off
    for the whole process, for the plain versions), saved and restored
    around it, equals the TF32-off result: every model call's class logits
    bit for bit, every voxel and count. The program scopes TF32 off around a
    float32 model itself (ROADMAP C10); with that scope taken out, the same
    call under the default flags gives other logits. Printed on a line of
    its own."""
    from tpu_mslesseg_torch.model import yolo11

    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = (cudnn.allow_tf32, matmul.allow_tf32)
    heads = {}

    def run(name, default: bool):
        logits = heads[name] = []
        hook = cp.model.register_forward_hook(
            lambda module, a, out: logits.append(torch.cat([t.flatten() for t in out["cls"]])))
        if default:
            cudnn.allow_tf32, matmul.allow_tf32 = True, False
        try:
            got = cp.lote(*args)
            torch.cuda.synchronize()
        finally:
            cudnn.allow_tf32, matmul.allow_tf32 = saved
            hook.remove()
        return got

    counts, cons, vols = run("default", True)
    run("tf32_off", False)
    scoped = yolo11.precision_of
    yolo11.precision_of = lambda dtype: contextlib.nullcontext()
    try:
        run("unscoped", True)
    finally:
        yolo11.precision_of = scoped
    same = lambda a, b: len(heads[a]) == len(heads[b]) and all(
        torch.equal(x, y) for x, y in zip(heads[a], heads[b]))
    w_counts, w_cons, w_vols = want
    differ = {k: int((vols[k] != w_vols[k]).sum()) for k in PLANES}
    differ["consenso"] = int((cons != w_cons).sum())
    counts_equal = all(torch.equal(counts[k], w_counts[k]) for k in counts)
    row = {"phase": f"lote_scale_{scale}_f32_default_flags",
           "flags": {"cudnn.allow_tf32": True, "cuda.matmul.allow_tf32": False},
           "model_calls": len(heads["default"]),
           "logits_equal_tf32_off": same("default", "tf32_off"),
           "logits_equal_tf32_off_unscoped": same("unscoped", "tf32_off"),
           "voxels_differing_from_tf32_off": differ, "counts_equal": counts_equal,
           "flags_restored": [cudnn.allow_tf32, matmul.allow_tf32] == list(saved)}
    emit(row)
    if (any(differ.values()) or not counts_equal or not row["logits_equal_tf32_off"]
            or row["logits_equal_tf32_off_unscoped"] or not row["flags_restored"]):
        raise AssertionError(f"scale {scale} float32 under the default flags: {row}")


def expected_figures(phase: int, figures: set) -> set:
    """The figures a fold holds: `figures` where matplotlib imports, none
    where it does not (the engines then warn once and write none); prints
    which of the two this phase expects."""
    have = importlib.util.find_spec("matplotlib") is not None
    emit({"phase": f"train_figures_{phase}", "matplotlib": have,
          "expected": "the reference's figures" if have else "the base set: no figures"})
    return figures if have else set()


def train_state_probe(torch, state) -> dict:
    """Copies of what a train step may move: a few parameters, their EMA
    and every BatchNorm running statistic's sum."""
    sd = state.model.state_dict()
    return {"params": {k: sd[k].detach().clone() for k in TRAIN_PROBED},
            "ema": {k: state.ema[k].clone() for k in TRAIN_PROBED},
            "bn": torch.stack([v.float().sum() for k, v in sd.items() if "running_" in k])}


def phase_train(torch, P, dev, card) -> dict:
    """Phase 13: the train step at full width. YOLO11n-seg, imgsz 640, bf16
    compute (the reference's ``amp``), batch 16 (an optimizer step every four micro-batches
    after the warmup's ramp), ``max_fg`` 64, 64 instance slots with one to
    five valid, seeded weights, TRAIN_PASSES passes over TRAIN_BATCHES fixed
    synthetic batches through ``train_step``."""
    T = P.trainer
    cfg = T.TrainConfig(batch_size=16, imgsz=IMGSZ, max_fg=64, seed=0)
    spe = TRAIN_BATCHES
    if T.accumulate_steps(cfg) != 4:
        raise AssertionError("batch 16 against the nominal 64 must accumulate 4 micro-batches")
    model, _ = P.create_model(nc=1, scale="n", dtype=torch.bfloat16)
    if (model.cfg.scale, model.dtype) != ("n", torch.bfloat16):
        raise AssertionError("the trained model is not YOLO11n-seg in bf16")
    torch.cuda.reset_peak_memory_stats()
    held_before = torch.cuda.memory_allocated()  # what earlier phases still hold
    state = T.init_train_state(model, cfg, spe, device=dev)
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in
                P.synthetic_batch(100 + i, cfg.batch_size, IMGSZ, 64).items()}
               for i in range(TRAIN_BATCHES)]
    before = train_state_probe(torch, state)
    n_steps = TRAIN_PASSES * TRAIN_BATCHES
    step_s, rows, applied = [], [], []
    for i in range(n_steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = T.train_step(state, batches[i % TRAIN_BATCHES])
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        applied.append(bool(metrics.pop("applied")))
        row = {k: float(v) for k, v in metrics.items()}
        if not all(np.isfinite(v) for v in row.values()):
            raise AssertionError(f"micro-step {i}: a loss part is not finite: {row}")
        rows.append(row)
    peak = torch.cuda.max_memory_allocated()
    mask, n_applies, _ = T.apply_cadence(cfg, spe)
    if applied != mask[:n_steps].tolist() or state.applies != int(n_applies[n_steps - 1]):
        raise AssertionError(f"the optimizer fired at {np.nonzero(applied)[0].tolist()}, the "
                             f"cadence gives {np.nonzero(mask[:n_steps])[0].tolist()}")
    after = train_state_probe(torch, state)
    for what in ("params", "ema"):
        for k in TRAIN_PROBED:
            a, b = before[what][k], after[what][k]
            if not bool(torch.isfinite(b).all()) or torch.equal(a, b):
                raise AssertionError(f"{what} {k} did not move, or is not finite")
    if not bool(torch.isfinite(after["bn"]).all()) or \
            int((after["bn"] != before["bn"]).sum()) != after["bn"].numel():
        raise AssertionError("a BatchNorm running statistic did not move, or is not finite")
    for k, v in state.model.state_dict().items():
        if not bool(torch.isfinite(v).all()):
            raise AssertionError(f"{k} is not finite after training")
    mean = lambda key, lo, hi: float(np.mean([r[key] for r in rows[lo:hi]]))
    first = {k: mean(k, 0, TRAIN_BATCHES) for k in rows[0]}
    last = {k: mean(k, n_steps - TRAIN_BATCHES, n_steps) for k in rows[0]}
    fell = 1.0 - last["loss"] / first["loss"]

    def median_s(with_apply: bool):
        ts = [t for t, a in zip(step_s[TRAIN_FIRST:], applied[TRAIN_FIRST:]) if a == with_apply]
        return float(np.median(ts)) if ts else None

    emit({"phase": "train", "model": "YOLO11n-seg", "imgsz": IMGSZ, "dtype": "bfloat16",
          "batch_size": cfg.batch_size, "accumulate": T.accumulate_steps(cfg),
          "max_fg": cfg.max_fg, "slots": 64, "micro_steps": n_steps,
          "fixed_batches": TRAIN_BATCHES, "optimizer_fired_at": np.nonzero(applied)[0].tolist(),
          "applies": state.applies, "lr_bias_weights": list(state.lr),
          "first_pass_mean": first, "last_pass_mean": last, "total_loss_fell_by": fell,
          "kernel_launches": "none: the train step reaches no hand-written kernel",
          "informational": {
              "first_steps_s": step_s[:TRAIN_FIRST],
              "s_per_micro_step_median": float(np.median(step_s[TRAIN_FIRST:])),
              "s_per_micro_step_with_apply_median": median_s(True),
              "s_per_micro_step_without_apply_median": median_s(False),
              "images_per_s": cfg.batch_size / float(np.median(step_s[TRAIN_FIRST:])),
              "max_memory_allocated_bytes": peak,
              "memory_allocated_before_the_phase_bytes": held_before, **card}})
    if not fell > 0:
        raise AssertionError(f"the total loss did not fall: first pass {first['loss']}, "
                             f"last pass {last['loss']}")
    return {"fell": fell}


def phase_train_f32(torch, P, dev) -> None:
    """Phase 14: TRAIN_F32_STEPS f32 micro-steps (three applies) at imgsz 64,
    batch 2, from the same weights on the same batches, on the card and on
    the CPU through the port. The batches' ellipses span a third of the
    image and more, so all four loss parts are above 0.1 and each is held at
    TRAIN_F32_LOSS_RTOL with no absolute allowance. The bias group warms
    from 0 here and not from 0.1: AdamW's first steps move an element by
    the learning rate times its gradient's sign, a rounding-noise gradient
    then moves a bias by 0.1 either way, and the two runs part ways after
    the first apply whatever the device. With every update a few 1e-5 the
    runs stay together, and every parameter and its EMA are held by their
    *update* (after minus initial) against the leaf's largest update."""
    T = P.trainer
    cfg = T.TrainConfig(batch_size=2, imgsz=64, max_fg=8, seed=1, warmup_bias_lr=0.0)
    batches = [P.synthetic_batch(200 + i, 2, 64, 4, max_valid=2, size=(0.3, 0.7))
               for i in range(TRAIN_F32_STEPS)]
    runs = {}
    for name, where in (("card", dev), ("cpu", torch.device("cpu"))):
        model, _ = P.create_model(nc=1, scale="n", dtype=torch.float32)
        state = T.init_train_state(model, cfg, 4, device=where)
        init = {k: v.detach().cpu().clone() for k, v in state.model.named_parameters()}
        rows = [{k: float(v) for k, v in T.train_step(state, b).items()} for b in batches]
        runs[name] = {
            "rows": rows, "init": init, "applies": state.applies,
            "params": {k: v.detach().cpu() for k, v in state.model.named_parameters()},
            "ema": {k: v.cpu() for k, v in state.ema.items()},
            "bn": {k: v.cpu() for k, v in state.model.state_dict().items() if "running_" in k}}
    card, cpu = runs["card"], runs["cpu"]
    fired = [bool(r["applied"]) for r in card["rows"]]
    if fired != [bool(r["applied"]) for r in cpu["rows"]] or card["applies"] != 3 \
            or cpu["applies"] != 3:
        raise AssertionError(f"applies: card {card['applies']} at {fired}, CPU {cpu['applies']}")
    parts = ("loss", "box", "seg", "cls", "dfl")
    worst = {"loss_rel": 0.0, "bn_abs": 0.0, "params_off_share": 0.0, "ema_off_share": 0.0}
    for i, (rc, rh) in enumerate(zip(card["rows"], cpu["rows"])):
        for k in parts:
            if not rh[k] > 0.1:
                raise AssertionError(f"micro-step {i}: the {k} part is {rh[k]}, too small to hold")
            worst["loss_rel"] = max(worst["loss_rel"], abs(rc[k] - rh[k]) / abs(rh[k]))
    for k, v in cpu["bn"].items():
        worst["bn_abs"] = max(worst["bn_abs"], float((card["bn"][k] - v).abs().max()))
    held, worst_leaf = 0, {}
    for what in ("params", "ema"):
        for k, init in cpu["init"].items():
            if k in TRAIN_F32_NOISE:
                continue
            d_cpu, d_card = cpu[what][k] - init, card[what][k] - card["init"][k]
            top = float(d_cpu.abs().max())
            if top < 1e-6:  # a level without foreground: decay alone, below float32's step
                continue
            held += 1
            off = float(((d_card - d_cpu).abs() > TRAIN_F32_UPDATE_SHARE * top).float().mean())
            if off >= worst[f"{what}_off_share"]:
                worst[f"{what}_off_share"], worst_leaf[what] = off, k
    if not all(torch.equal(card["init"][k], v) for k, v in cpu["init"].items()):
        raise AssertionError("the two runs did not start from the same weights")
    emit({"phase": "train_f32", "imgsz": 64, "batch_size": 2, "micro_steps": TRAIN_F32_STEPS,
          "applies": card["applies"], "warmup_bias_lr": cfg.warmup_bias_lr,
          "card": card["rows"], "cpu": cpu["rows"], "leaves_held": held,
          "leaves_left_out": TRAIN_F32_NOISE, "worst_leaf": worst_leaf, **worst,
          "rtol_loss": TRAIN_F32_LOSS_RTOL, "atol_bn": TRAIN_F32_BN_ATOL,
          "update_within": TRAIN_F32_UPDATE_SHARE, "elements_off_at_most": TRAIN_F32_OFF_SHARE})
    if held < 400:
        raise AssertionError(f"only {held} parameter and EMA leaves moved")
    if worst["loss_rel"] > TRAIN_F32_LOSS_RTOL or worst["bn_abs"] > TRAIN_F32_BN_ATOL \
            or worst["params_off_share"] > TRAIN_F32_OFF_SHARE \
            or worst["ema_off_share"] > TRAIN_F32_OFF_SHARE:
        raise AssertionError(f"f32 train steps on the card and on the CPU disagree: {worst}")


TRAIN_CLI_EPOCHS = 3  # phases 15 and 16: epochs a fold
TRAIN_LOSS_COLS = (slice(2, 6), slice(14, 18))  # results.csv: train and val loss columns


def train_cli_args(*extra, secuencial: bool = True) -> list:
    return ["--plano", "axial", "--modalidad", "FLAIR", "--num_cortes", str(N_PER_PLANE),
            "--mejora", "CLAHE", "--epochs", str(TRAIN_CLI_EPOCHS), "--k_folds",
            str(CLI_K_FOLDS), "--completo", "--entrenar",
            *(["--train_secuencial"] if secuencial else []), *extra]


def write_train_tree(root: Path, P):
    """Phases 15 and 16's inputs: 4 synthetic patients (FLAIR and mask), 2
    folds. Returns (dataset dir, Modelo)."""
    ds = root / "MSLesSeg-Dataset" / "train"
    for pid in CLI_PATIENTS:
        vol, gt = patient_volume(pid, CLI_LESION)
        P.nifti.save(vol.astype(np.float32), np.eye(4), ds / pid / "T1" / f"{pid}_T1_FLAIR.nii.gz")
        P.nifti.save(gt.astype(np.uint8), np.eye(4), ds / pid / "T1" / f"{pid}_T1_MASK.nii.gz")
    return ds, P.Modelo(plano="axial", num_cortes=N_PER_PLANE, modalidad=["FLAIR"],
                        k_folds=CLI_K_FOLDS, mejora="CLAHE")


def served_tree(modelo, folds) -> set:
    """The serve's files after training: each patient's volume and JSON,
    each fold's and the global JSON."""
    exp = f"{modelo.base_path}_{TRAIN_CLI_EPOCHS}epochs"
    want = {Path(d) / exp / f"fold{f}" / pid / f"{pid}_axial{suffix}"
            for pid, f in CLI_PATIENTS.items()
            for d, suffix in (("pred_vols", ".nii.gz"), ("results", "_results.json"))}
    want |= {Path("results") / exp / f"fold{f}" / f"fold{f}_axial_results.json" for f in folds}
    want.add(Path("results") / exp / "global_axial_results.json")
    return want


def timed_wrapper(torch, fn, record):
    """`fn` with the seconds of each call, the card synchronised on both
    sides, passed to `record(seconds, args, result)`."""
    def wrapped(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        torch.cuda.synchronize()
        record(time.perf_counter() - t0, a, out)
        return out
    return wrapped


def phase_train_cli(torch, P, root: Path, counters, dev, card) -> dict:
    """Phase 15: ``main([... "--completo", "--entrenar", "--train_secuencial",
    "--epochs", "3"])`` on a tree of 4 synthetic patients, 2 folds: each fold
    trained at full width with ``batch -1``, then every patient served from
    the fold's ``best.pt``; a second run trains nothing."""
    ds, modelo = write_train_tree(root, P)
    rec = {"auto": [], "peaks": [], "folds": [], "steps": [], "val_s": [], "serve": [],
           "train_peak": []}

    def auto(*a, **kw):
        free, probes = torch.cuda.mem_get_info()[0], len(rec["peaks"])
        b = real_auto(*a, **kw)
        rec["auto"].append({"batch": b, "free_bytes": free, "probed": len(rec["peaks"]) > probes})
        return b

    def peak(*a, **kw):
        rec["peaks"].append((a[4], real_peak(*a, **kw)))
        return rec["peaks"][-1][1]

    def step_record(sec, a, out):
        state = a[0]
        rec["steps"].append({"fold": len(rec["folds"]) + 1, "step": state.step - 1,
                             "applied": bool(out["applied"]), "s": sec, "cfg": state.cfg,
                             "spe": state.steps_per_epoch, "remat": state.model.remat,
                             "model": (str(state.model.dtype).removeprefix("torch."),
                                       state.model.cfg.scale, state.cfg.imgsz)})

    def serve(*a, **kw):
        before = read_launches(counters)
        ok = real_rapido(*a, **kw)
        torch.cuda.synchronize()
        after = read_launches(counters)
        rec["serve"].append({k: after[k] - before[k] for k in after})
        return ok

    real_auto, real_rapido = P.autobatch.auto_batch_size, P.rapido.ejecutar_fold_rapido
    real_peak = P.autobatch.probe_peak
    wrappers = [
        (P.autobatch, "auto_batch_size", auto),
        (P.autobatch, "probe_peak", peak),
        (P.engine, "train_fold", timed_wrapper(
            torch, P.engine.train_fold, lambda sec, a, out: (
                rec["folds"].append((sec, out)),
                rec["train_peak"].append(torch.cuda.max_memory_allocated())))),
        (P.trainer, "train_step", timed_wrapper(torch, P.trainer.train_step, step_record)),
        (P.validate, "run_validation", timed_wrapper(
            torch, P.validate.run_validation, lambda sec, a, out: rec["val_s"].append(sec))),
        (P.rapido, "ejecutar_fold_rapido", serve),
    ]
    cache = root / "autobatch.json"  # empty: the probe runs on the card
    with contextlib.ExitStack() as stack:
        for module, name, fn in wrappers:
            stack.enter_context(switched(module, name, fn))
        old_cache = os.environ.get("TPU_MSLESSEG_AUTOBATCH_CACHE")
        os.environ["TPU_MSLESSEG_AUTOBATCH_CACHE"] = str(cache)
        stack.callback(lambda: os.environ.pop("TPU_MSLESSEG_AUTOBATCH_CACHE") if old_cache is None
                       else os.environ.update(TPU_MSLESSEG_AUTOBATCH_CACHE=old_cache))
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        held_before = torch.cuda.memory_allocated()
        zero_launches(counters)
        t0 = time.perf_counter()
        cwd = os.getcwd()
        os.chdir(root)
        try:
            P.orch.main(train_cli_args())
        finally:
            os.chdir(cwd)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = read_launches(counters)
        peak = torch.cuda.max_memory_allocated()
        P.logging_setup.configure_logging(log_file=None)

        # every fold: its artifacts, three epochs of finite losses, the cadence
        folds = sorted(set(CLI_PATIENTS.values()))
        fold_figures = expected_figures(15, SEQUENTIAL_FIGURES)
        if len(rec["folds"]) != len(folds):
            raise AssertionError(f"{len(rec['folds'])} folds trained, not {len(folds)}")
        epoch_s, rows_by_fold = {}, {}
        for k, (_, summary) in zip(folds, rec["folds"]):
            cfg_k = P.ConfigTrain(modelo=modelo, epochs=TRAIN_CLI_EPOCHS, fold_test=k, root=root)
            fold = cfg_k.fold_dir
            have = {str(p.relative_to(fold)) for p in fold.rglob("*") if p.is_file()}
            want = {"args.yaml", f"{modelo.model_string}.yaml", "results.csv", "weights/best.pt",
                    "weights/last.pt", "weights/fitness.json"} | fold_figures
            if have != want:
                raise AssertionError(f"fold {k}: files {sorted(have)}, want {sorted(want)}")
            with open(fold / "results.csv") as f:
                rows = list(csv.reader(f))[1:]
            if [r[0] for r in rows] != [str(e) for e in range(1, TRAIN_CLI_EPOCHS + 1)]:
                raise AssertionError(f"fold {k}: results.csv epochs {[r[0] for r in rows]}")
            for r in rows:
                losses = [float(v) for c in TRAIN_LOSS_COLS for v in r[c]]
                if not all(np.isfinite(losses)) or not all(v > 0 for v in losses[:4]):
                    raise AssertionError(f"fold {k}: losses {losses} in results.csv")
            times = [float(r[1]) for r in rows]
            epoch_s[k] = [times[0]] + [b - a for a, b in zip(times, times[1:])]
            rows_by_fold[k] = rows
            steps = [s for s in rec["steps"] if s["fold"] == folds.index(k) + 1]
            mask, _, _ = P.trainer.apply_cadence(steps[0]["cfg"], steps[0]["spe"])
            if [s["applied"] for s in steps] != mask[: len(steps)].tolist() or \
                    [s["step"] for s in steps] != list(range(len(steps))):
                raise AssertionError(f"fold {k}: the optimizer fired off the cadence")
            if len(steps) != TRAIN_CLI_EPOCHS * summary["steps_per_epoch"]:
                raise AssertionError(f"fold {k}: {len(steps)} micro-steps")
            # best.pt serves: SlicePredictor on the fold's first patient
            pid = next(p for p, f in CLI_PATIENTS.items() if f == k)
            pac = P.Paciente(id=pid, plano="axial", modalidad=["FLAIR"], mejora="CLAHE",
                             dataset_dir=ds)
            raw = torch.from_numpy(pac.cortes_imagen_batch(pac.indices_a_usar(N_PER_PLANE),
                                                           "FLAIR"))
            smodel, _, imgsz = P.create_model_from_env()
            pred = P.SlicePredictor(smodel, P.load_checkpoint(cfg_k.best_ckpt),
                                    tuple(raw.shape[1:]), imgsz=imgsz, device=dev)
            masks = pred(P.enhance.enhance_for_model(raw.to(dev), "CLAHE"))
            if tuple(masks.shape) != tuple(raw.shape) or pred._stem_w is None:
                raise AssertionError(f"fold {k}: best.pt did not serve through SlicePredictor")
        trained = {s["model"] for s in rec["steps"]}
        if trained != {("bfloat16", "n", IMGSZ)}:
            raise AssertionError(f"trained {trained}, not YOLO11n-seg in bf16 at {IMGSZ}")
        probe = rec["auto"][0]
        if not probe["probed"] or [b for b, _ in rec["peaks"][:2]] != list(P.autobatch.PROBES):
            raise AssertionError(f"batch -1 was not resolved by the card's probe: {rec}")

        # the serve: every volume/JSON pair, all six kernels launched
        check_tree(tree(root, "pred_vols", "results"), served_tree(modelo, folds),
                   "phase 15: pred_vols/, results/")
        serve_launches = {k: sum(r[k] for r in rec["serve"]) for k in KERNELS}
        for k, n in serve_launches.items():
            if n < 1:
                raise AssertionError(f"the serve after training did not launch the {k} kernel")

        # the same command again trains nothing
        stamps = {p: p.stat().st_mtime_ns for p in (root / "trains").rglob("*") if p.is_file()}
        os.chdir(root)
        try:
            P.orch.main(train_cli_args())
        finally:
            os.chdir(cwd)
            P.logging_setup.configure_logging(log_file=None)
        if len(rec["folds"]) != len(folds) or \
                {p: p.stat().st_mtime_ns for p in (root / "trains").rglob("*")
                 if p.is_file()} != stamps:
            raise AssertionError("a second run trained again")

    step_s = [s["s"] for s in rec["steps"]]
    later = [s["s"] for s in rec["steps"] if s["step"] > 0]
    batch = rec["folds"][0][1]["batch_size"]
    figures = {"run_s": run_s, "fold_s": [sec for sec, _ in rec["folds"]],
               "batch": batch, "micro_steps_per_epoch": rec["folds"][0][1]["steps_per_epoch"],
               "s_per_micro_step_median": float(np.median(later)) if later else None,
               "s_per_validation_pass": rec["val_s"],
               "images_per_s": batch / float(np.median(later)) if later else None,
               "max_memory_allocated_bytes": peak, "train_peak_bytes": rec["train_peak"],
               "remat": sorted({s["remat"] for s in rec["steps"]})}
    emit({"phase": "train_cli", "model": "YOLO11n-seg", "trained": sorted(trained),
          "patients": len(CLI_PATIENTS), "k_folds": CLI_K_FOLDS, "epochs": TRAIN_CLI_EPOCHS,
          "summaries": [s for _, s in rec["folds"]], "launches": launches,
          "serve_launches": serve_launches, "second_run_trained_nothing": True,
          "best_pt_served_by_slice_predictor": True,
          "batch_probe": rec["auto"], "budget_fraction": P.autobatch.DEFAULT_FRACTION,
          "batch_before_dataset_rule": probe["batch"], "batch_after_dataset_rule": batch,
          "probe_peaks_bytes": rec["peaks"], "micro_steps": len(step_s),
          "optimizer_fired_at": {k: [s["step"] for s in rec["steps"]
                                     if s["applied"] and s["fold"] == i + 1]
                                 for i, k in enumerate(folds)},
          "informational": {
              "run_s": run_s, "fold_s": [sec for sec, _ in rec["folds"]], "epoch_s": epoch_s,
              "first_micro_step_s": [s["s"] for s in rec["steps"] if s["step"] == 0],
              "s_per_micro_step_median": float(np.median(later)) if later else None,
              "s_per_validation_pass": rec["val_s"],
              "images_per_s": batch / float(np.median(later)) if later else None,
              "max_memory_allocated_bytes": peak, "remat": figures["remat"],
              "train_peak_bytes": rec["train_peak"],
              "memory_allocated_before_the_phase_bytes": held_before, **card}})
    return {"launches": launches, "figures": figures}


def phase_train_parallel_cli(torch, P, root: Path, counters, dev, card, sequential) -> dict:
    """Phase 16: ``main([... "--completo", "--entrenar", "--epochs", "3"])``
    without ``--train_secuencial`` on phase 15's inputs: both folds trained
    at once (``train_folds_parallel``: one shared pool on the card, both
    folds' micro-steps in turns), then served from their ``best.pt``; each
    kernel against its plain version on the served weights; a second run
    trains nothing. `sequential` holds phase 15's figures, printed beside
    this phase's."""
    ds, modelo = write_train_tree(root, P)
    rec = {"auto": [], "init": [], "steps": [], "val_s": [], "serve": [], "train": []}

    def auto(*a, **kw):
        b = real_auto(*a, **kw)
        rec["auto"].append(b)
        return b

    def init(model, cfg, spe, folds, *a, **kw):
        rec["init"].append({"batch": cfg.batch_size, "spe": spe, "folds": list(folds)})
        states = real_init(model, cfg, spe, folds, *a, **kw)
        owner.update({id(st): f for f, st in states.items()})
        return states

    def step_record(sec, a, out):
        state = a[0]
        rec["steps"].append({"fold": owner[id(state)], "step": state.step - 1, "s": sec,
                             "applied": bool(out["applied"]), "cfg": state.cfg,
                             "spe": state.steps_per_epoch,
                             "finite": all(bool(torch.isfinite(out[k])) for k in
                                           P.trainer.LOSS_PARTS), "remat": state.model.remat,
                             "model": (str(state.model.dtype).removeprefix("torch."),
                                       state.model.cfg.scale, state.cfg.imgsz)})

    def train(*a, **kw):
        before = read_launches(counters)
        out = real_train(*a, **kw)
        torch.cuda.synchronize()
        after = read_launches(counters)
        rec["train"].append({k: after[k] - before[k] for k in after})
        rec["train_peak"] = torch.cuda.max_memory_allocated()
        return out

    def serve(*a, **kw):
        before = read_launches(counters)
        ok = real_rapido(*a, **kw)
        torch.cuda.synchronize()
        after = read_launches(counters)
        rec["serve"].append({k: after[k] - before[k] for k in after})
        return ok

    def fold_by_fold(*a, **kw):
        raise AssertionError("phase 16 trained fold by fold")

    owner = {}
    real_auto, real_init = P.autobatch.auto_batch_size, P.fold_parallel.init_multi_fold_state
    real_rapido = P.rapido.ejecutar_fold_rapido
    real_train = timed_wrapper(torch, P.engine_parallel.train_folds_parallel,
                               lambda sec, a, out: rec.setdefault("train_s", []).append(sec))
    wrappers = [
        (P.autobatch, "auto_batch_size", auto),
        (P.fold_parallel, "init_multi_fold_state", init),
        (P.fold_parallel, "fold_step", timed_wrapper(torch, P.fold_parallel.fold_step,
                                                     step_record)),
        (P.engine_parallel, "train_folds_parallel", train),
        (P.validate, "run_validation", timed_wrapper(
            torch, P.validate.run_validation, lambda sec, a, out: rec["val_s"].append(sec))),
        (P.rapido, "ejecutar_fold_rapido", serve),
        (P.engine, "train_fold", fold_by_fold),
    ]
    cache = root / "autobatch.json"  # empty: the probe runs on the card
    cwd = os.getcwd()
    with contextlib.ExitStack() as stack:
        for module, name, fn in wrappers:
            stack.enter_context(switched(module, name, fn))
        old_cache = os.environ.get("TPU_MSLESSEG_AUTOBATCH_CACHE")
        os.environ["TPU_MSLESSEG_AUTOBATCH_CACHE"] = str(cache)
        stack.callback(lambda: os.environ.pop("TPU_MSLESSEG_AUTOBATCH_CACHE") if old_cache is None
                       else os.environ.update(TPU_MSLESSEG_AUTOBATCH_CACHE=old_cache))
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        held_before = torch.cuda.memory_allocated()
        P.profiling.reset_timings()
        zero_launches(counters)
        t0 = time.perf_counter()
        os.chdir(root)
        try:
            P.orch.main(train_cli_args(secuencial=False))
        finally:
            os.chdir(cwd)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = read_launches(counters)
        peak = torch.cuda.max_memory_allocated()
        stages = P.profiling.timings_summary()
        P.logging_setup.configure_logging(log_file=None)

        if "train_paralelo" not in stages or [k for k in stages if k.startswith("train_fold")]:
            raise AssertionError(f"stage 2 did not run as train_paralelo alone: {sorted(stages)}")
        folds = sorted(set(CLI_PATIENTS.values()))
        if len(rec["init"]) != 1 or rec["init"][0]["folds"] != [f - 1 for f in folds]:
            raise AssertionError(f"the folds' states: {rec['init']}")
        spe, batch = rec["init"][0]["spe"], rec["init"][0]["batch"]
        out_dir = P.ConfigTrain(modelo=modelo, epochs=TRAIN_CLI_EPOCHS, fold_test=1,
                                root=root).output_dir
        if not (out_dir / "_parallel" / "last.pt").is_file():
            raise AssertionError("no stacked resume point _parallel/last.pt")
        fold_figures = expected_figures(16, PARALLEL_FIGURES)
        for k in folds:
            fold = out_dir / f"fold{k}"
            have = {str(p.relative_to(fold)) for p in fold.rglob("*") if p.is_file()}
            want = {"args.yaml", f"{modelo.model_string}.yaml", "results.csv", "weights/best.pt",
                    "weights/last.pt", "weights/fitness.json"} | fold_figures
            if have != want:
                raise AssertionError(f"fold {k}: files {sorted(have)}, want {sorted(want)}")
            with open(fold / "results.csv") as f:
                rows = list(csv.reader(f))[1:]
            if [r[0] for r in rows] != [str(e) for e in range(1, TRAIN_CLI_EPOCHS + 1)]:
                raise AssertionError(f"fold {k}: results.csv epochs {[r[0] for r in rows]}")
            for r in rows:
                losses = [float(v) for c in TRAIN_LOSS_COLS for v in r[c]]
                if not all(np.isfinite(losses)) or not all(v > 0 for v in losses[:4]):
                    raise AssertionError(f"fold {k}: losses {losses} in results.csv")
            steps = [s for s in rec["steps"] if s["fold"] == k - 1]
            mask, _, _ = P.trainer.apply_cadence(steps[0]["cfg"], steps[0]["spe"])
            if [s["applied"] for s in steps] != mask[: len(steps)].tolist() or \
                    [s["step"] for s in steps] != list(range(len(steps))):
                raise AssertionError(f"fold {k}: the optimizer fired off the cadence")
            if len(steps) != TRAIN_CLI_EPOCHS * spe or not all(s["finite"] for s in steps):
                raise AssertionError(f"fold {k}: {len(steps)} micro-steps, or a loss not finite")
        # the folds take turns at every micro-step
        if [s["fold"] for s in rec["steps"][:2 * spe]] != [0, 1] * spe:
            raise AssertionError("the folds did not take turns micro-step by micro-step")
        trained = {s["model"] for s in rec["steps"]}
        if trained != {("bfloat16", "n", IMGSZ)}:
            raise AssertionError(f"trained {trained}, not YOLO11n-seg in bf16 at {IMGSZ}")
        if len(rec["auto"]) != 1:
            raise AssertionError("batch -1 was not resolved once by the card's probe")
        for k in ("clahe_tile_lut", "clahe_blend"):
            if rec["train"][0][k] < 1:
                raise AssertionError(f"the shared pool and validation sets did not launch {k}")

        check_tree(tree(root, "pred_vols", "results"), served_tree(modelo, folds),
                   "phase 16: pred_vols/, results/")
        serve_launches = {k: sum(r[k] for r in rec["serve"]) for k in KERNELS}
        for k, n in serve_launches.items():
            if n < 1:
                raise AssertionError(f"the serve after training did not launch the {k} kernel")

        # each kernel against its plain version on fold 1's served weights
        pid = next(p for p, f in CLI_PATIENTS.items() if f == 1)
        pac = P.Paciente(id=pid, plano="axial", modalidad=["FLAIR"], mejora="CLAHE",
                         dataset_dir=ds)
        raw = torch.from_numpy(pac.cortes_imagen_batch(pac.indices_a_usar(N_PER_PLANE),
                                                       "FLAIR")).to(dev)
        smodel, _, imgsz = P.create_model_from_env()
        best = P.ConfigTrain(modelo=modelo, epochs=TRAIN_CLI_EPOCHS, fold_test=1,
                             root=root).best_ckpt
        # at the validation's confidence, 0.001: three epochs from seeded
        # weights keep no detection at the serve's 0.25, and the union kernel
        # is held on kept boxes
        pred = P.SlicePredictor(smodel, P.load_checkpoint(best), tuple(raw.shape[1:]),
                                imgsz=imgsz, conf=0.001, device=dev)
        if pred._stem_w is None:
            raise AssertionError("the best.pt of the fold-parallel run did not build the stem")
        checks = chain_kernel_checks(torch, P, pred, raw)
        if not checks["mask_union"]["errs"]["kept_per_image"] > 0:
            raise AssertionError("no detection kept to hold the union kernel on")

        stamps = {p: p.stat().st_mtime_ns for p in (root / "trains").rglob("*") if p.is_file()}
        os.chdir(root)
        try:
            P.orch.main(train_cli_args(secuencial=False))
        finally:
            os.chdir(cwd)
            P.logging_setup.configure_logging(log_file=None)
        if len(rec["init"]) != 1 or {p: p.stat().st_mtime_ns for p in (root / "trains").rglob("*")
                                     if p.is_file()} != stamps:
            raise AssertionError("a second run trained again")

    later = [s["s"] for s in rec["steps"] if s["step"] > 0]
    rounds = [a["s"] + b["s"] for a, b in zip(rec["steps"][2::2], rec["steps"][3::2])]
    figures = {"run_s": run_s, "train_paralelo_s": rec["train_s"][0], "batch": batch,
               "micro_steps_per_epoch": spe,
               "s_per_micro_step_median": float(np.median(later)),
               "s_per_micro_step_of_all_folds_median": float(np.median(rounds)),
               "s_per_validation_pass": rec["val_s"],
               "images_per_s": len(folds) * batch / float(np.median(rounds)),
               "max_memory_allocated_bytes": peak, "train_peak_bytes": rec["train_peak"],
               "remat": sorted({s["remat"] for s in rec["steps"]})}
    emit({"phase": "train_parallel_cli", "model": "YOLO11n-seg", "trained": sorted(trained),
          "patients": len(CLI_PATIENTS), "k_folds": CLI_K_FOLDS, "epochs": TRAIN_CLI_EPOCHS,
          "stages": sorted(stages), "launches": launches, "train_launches": rec["train"][0],
          "serve_launches": serve_launches, "second_run_trained_nothing": True,
          "kernels_vs_plain": {k: v["errs"] for k, v in checks.items()},
          "batch_probe": rec["auto"], "micro_steps": len(rec["steps"]),
          "optimizer_fired_at": {k: [s["step"] for s in rec["steps"]
                                     if s["applied"] and s["fold"] == k - 1] for k in folds},
          "informational": {"fold_parallel": figures, "sequential_phase_15": sequential,
                            "memory_allocated_before_the_phase_bytes": held_before, **card}})
    return {"launches": launches, "checks": checks}


def phase_nccl_one_rank(torch, P, dev, card) -> None:
    """Phase 17: one rank of ``nccl`` (a file store in a temporary
    directory): one data-parallel micro-step at YOLO11n-seg, 640, bf16,
    batch 16, through the collective path (``DataAxis`` over the one rank,
    the sequential engine's semantics: BatchNorm statistics, loss
    normalisers and gradients all-reduced), against the plain micro-step
    from the same state on the same batch, bit for bit (the optimizer fires
    at this first micro-step). cuDNN and torch in their deterministic modes
    for the phase; the plain step is run twice first to show it repeats."""
    import torch.distributed as dist

    T = P.trainer
    cfg = T.TrainConfig(batch_size=16, imgsz=IMGSZ, max_fg=64, seed=3)
    model, _ = P.create_model(nc=1, scale="n", dtype=torch.bfloat16)
    sd = P.init_variables(model, cfg.seed)
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in P.synthetic_batch(300, cfg.batch_size, IMGSZ, 64).items()}

    def step(axis):
        m, _ = P.create_model(nc=1, scale="n", dtype=torch.bfloat16)
        state = T.init_train_state(m, cfg, 4, variables=sd, device=dev)
        out = T.train_step(state, batch, axis)
        torch.cuda.synchronize()
        return out, state

    def same(a, b) -> list:
        (ma, sa), (mb, sb) = a, b
        diff = [k for k in ("loss",) + T.LOSS_PARTS if not torch.equal(ma[k], mb[k])]
        if ma["applied"] != mb["applied"]:
            diff.append("applied")
        da, db = sa.state_dict(), sb.state_dict()
        for part in ("model", "ema"):
            diff += [f"{part}:{k}" for k in da[part] if not torch.equal(da[part][k], db[part][k])]
        for i, st in da["optimizer"]["state"].items():
            diff += [f"opt:{i}:{k}" for k, v in st.items()
                     if not torch.equal(v, db["optimizer"]["state"][i][k])]
        return diff

    flags = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
             torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled())
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        plain = step(None)
        again = step(None)
        repeats = same(plain, again)
        with tempfile.TemporaryDirectory(prefix="chip_smoke_nccl_") as tmp:
            torch.cuda.set_device(dev)
            dist.init_process_group("nccl", init_method=f"file://{tmp}/store", world_size=1,
                                    rank=0)
            try:
                if dist.get_backend() != "nccl" or P.distributed.process_count() != 1:
                    raise AssertionError("not one rank of nccl")
                axis = P.mesh.DataAxis(dist.group.WORLD, (0,), 0, True)
                collective = step(axis)
            finally:
                dist.destroy_process_group()
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = flags[:2]
        torch.use_deterministic_algorithms(flags[2], warn_only=flags[3])
    if repeats:
        raise AssertionError(f"the plain step does not repeat bit for bit: {repeats[:10]}")
    differs = same(plain, collective)
    if differs:
        raise AssertionError(f"the one-rank collective step differs from the plain one: "
                             f"{differs[:10]} ({len(differs)} in all)")
    if not plain[0]["applied"] or not all(bool(torch.isfinite(plain[0][k]))
                                          for k in T.LOSS_PARTS):
        raise AssertionError("the compared step did not apply, or a loss part is not finite")
    emit({"phase": "nccl_one_rank", "backend": "nccl", "world_size": 1,
          "model": "YOLO11n-seg", "imgsz": IMGSZ, "dtype": "bfloat16",
          "batch_size": cfg.batch_size, "optimizer_fired": True,
          "plain_repeats_bit_for_bit": True, "collective_equals_plain_bit_for_bit": True,
          "loss": {k: float(plain[0][k]) for k in ("loss",) + T.LOSS_PARTS},
          "note": "two ranks cannot be run on one card: the two-rank steps are the CPU "
                  "tests' (tests/test_torch_port_distributed.py, gloo)", **card})


# ---- phase 19: rematerialised training against the stored step ------------
REMAT_STEPS = 3  # micro-steps compared; the warmup's first gaps are 1, so each applies
REMAT_TIMED = 8  # timed micro-steps a block, after one untimed; blocks off, on, on, off
REMAT_POOL = 32  # synthetic slices of the batch -1 probes' dataset
REMAT_WIDE = ("x", "m")  # the widest scale whose probes fit, x first


def remat_run(torch, P, dev, cfg, sd, dtype, remat: bool, batches) -> list:
    """A fresh state from `sd` through one micro-step a batch, the model
    built with `remat`. Per micro-step: the loss parts, whether it applied,
    the gradients as the optimizer half began, then the running statistics,
    the parameters and the EMA, and the micro-step's peak memory above what
    was allocated before it."""
    T = P.trainer
    model, _ = P.create_model(nc=1, scale="n", dtype=dtype, remat=remat)
    state = T.init_train_state(model, cfg, len(batches), variables=sd, device=dev)
    grads, rows = [], []
    real = T.optimizer_step

    def read_grads(st):
        grads.append({n: p.grad.clone() for n, p in st.model.named_parameters()})
        return real(st)

    with switched(T, "optimizer_step", read_grads):
        for batch in batches:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            m = T.train_step(state, batch)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - base
            rows.append({
                "parts": {k: m[k].clone() for k in ("loss",) + T.LOSS_PARTS},
                "applied": bool(m["applied"]), "grads": grads[-1],
                "stats": {k: v.clone() for k, v in state.model.state_dict().items()
                          if "running_" in k},
                "params": {n: p.detach().clone() for n, p in state.model.named_parameters()},
                "ema": {k: v.clone() for k, v in state.ema.items()}, "peak": peak})
    return rows


def remat_differences(plain: list, remat: list) -> list:
    """(micro-step, what, key, largest absolute difference) for every
    tensor in which the two runs differ."""
    diffs = []
    for i, (a, b) in enumerate(zip(plain, remat)):
        if a["applied"] != b["applied"]:
            diffs.append((i, "applied", "", float("nan")))
        for what in ("parts", "grads", "stats", "params", "ema"):
            for k, v in a[what].items():
                if not b[what][k].equal(v):
                    diffs.append((i, what, k, float((b[what][k].float() - v.float()).abs().max())))
    return diffs


def remat_step_s(torch, P, dev, cfg, sd, remat: bool, batches) -> list:
    """Seconds of REMAT_TIMED bf16 micro-steps (host clock around work that
    ends in a synchronise) of a fresh state, after one untimed."""
    T = P.trainer
    model, _ = P.create_model(nc=1, scale="n", dtype=torch.bfloat16, remat=remat)
    state = T.init_train_state(model, cfg, len(batches), variables=sd, device=dev)
    T.train_step(state, batches[0])
    out = []
    for i in range(REMAT_TIMED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        T.train_step(state, batches[(i + 1) % len(batches)])
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
    return out


def remat_pool(torch, P, dev):
    """REMAT_POOL synthetic 218x182 slices with one to three elliptic
    lesions each, as stage 2's dataset (``data.slice_dataset``) at IMGSZ."""
    rng = np.random.default_rng(19)
    h, w = 218, 182
    imgs = rng.integers(20, 120, (REMAT_POOL, h, w), dtype=np.uint8)
    masks = np.zeros((REMAT_POOL, h, w), np.uint8)
    yy, xx = np.mgrid[0:h, 0:w]
    for i in range(REMAT_POOL):
        for _ in range(int(rng.integers(1, 4))):
            cy, cx = rng.uniform(40, h - 40), rng.uniform(40, w - 40)
            ry, rx = rng.uniform(5, 20, 2)
            masks[i][((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 < 1] = 1
    imgs[masks > 0] = 220
    meta = [("S0", "FLAIR", i) for i in range(REMAT_POOL)]
    return P.tdata.slice_dataset(torch.from_numpy(imgs).to(dev), masks, meta, train_size=IMGSZ)


def remat_batch(torch, P, dev, pool, scale: str, remat: bool) -> dict:
    """``autobatch.auto_batch_size`` for a bf16 model of `scale` built with
    `remat` on `pool`, with the probe's peaks (the cache is the caller's
    empty file, so both probes run)."""
    model, _ = P.create_model(nc=1, scale=scale, dtype=torch.bfloat16, remat=remat)
    cfg = P.trainer.TrainConfig(imgsz=IMGSZ, max_fg=64, remat=remat)
    acfg = P.augment.AugConfig(imgsz=IMGSZ, max_inst=pool.max_inst, mosaic=True)
    peaks = []
    real = P.autobatch.probe_peak

    def probe(*a, **kw):
        peaks.append((a[4], real(*a, **kw)))
        return peaks[-1][1]

    gc.collect()  # what an earlier probe left is free for this one's budget
    torch.cuda.empty_cache()
    free = torch.cuda.mem_get_info()[0]
    try:
        with switched(P.autobatch, "probe_peak", probe):
            batch = P.autobatch.auto_batch_size(model, cfg, pool, acfg, device=dev)
    except torch.cuda.OutOfMemoryError as e:
        return {"batch": None, "out_of_memory": str(e).splitlines()[0], "probe_peaks_bytes": peaks,
                "free_bytes": free}
    if [b for b, _ in peaks] != list(P.autobatch.PROBES):
        raise AssertionError(f"scale {scale}, remat {remat}: batch -1 was not probed: {peaks}")
    return {"batch": batch, "probe_peaks_bytes": peaks, "free_bytes": free}


def phase_train_remat(torch, P, dev, card) -> None:
    """Phase 19: the model's ``remat`` (stage 2's default) against the
    stored step at full width: YOLO11n-seg, imgsz 640, batch 16, ``max_fg``
    64, seeded weights, REMAT_STEPS fixed synthetic batches, in bf16 and in
    float32 (TF32 off), with torch and cuDNN in their deterministic modes:
    every loss part, every gradient as the optimizer half begins, every
    running statistic and the parameters and EMA after each micro-step (each
    applies) equal, bit for bit. Then, for both settings: each micro-step's
    peak memory, the median seconds a bf16 micro-step (default modes, blocks
    off, on, on, off), and what ``batch -1`` resolves to for scale n and the
    widest scale of REMAT_WIDE whose probes fit, each from an empty cache."""
    T = P.trainer
    cfg = T.TrainConfig(batch_size=16, imgsz=IMGSZ, max_fg=64, seed=4)
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in
                P.synthetic_batch(400 + i, cfg.batch_size, IMGSZ, 64).items()}
               for i in range(REMAT_STEPS)]
    model, _ = P.create_model(nc=1, scale="n", dtype=torch.bfloat16)
    sd = P.init_variables(model, cfg.seed)
    del model
    flags = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
             torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled())
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    torch.use_deterministic_algorithms(True, warn_only=True)
    compared, failures = {}, []
    try:
        for dtype in (torch.bfloat16, torch.float32):
            name = str(dtype).removeprefix("torch.")
            runs = {remat: remat_run(torch, P, dev, cfg, sd, dtype, remat, batches)
                    for remat in (False, True)}
            diffs = remat_differences(runs[False], runs[True])
            row = {"micro_steps": REMAT_STEPS,
                   "applied": [r["applied"] for r in runs[True]],
                   "loss": [float(r["parts"]["loss"]) for r in runs[True]],
                   "tensors_compared_a_step": sum(len(runs[True][0][w]) for w in
                                                  ("parts", "grads", "stats", "params", "ema")),
                   "differing": len(diffs), "peak_bytes_off": [r["peak"] for r in runs[False]],
                   "peak_bytes_on": [r["peak"] for r in runs[True]]}
            if diffs:
                again = remat_differences(runs[False], remat_run(torch, P, dev, cfg, sd, dtype,
                                                                 False, batches))
                row.update(largest=max(diffs, key=lambda d: d[3]), first=diffs[:10],
                           plain_repeats_bit_for_bit=not again)
                failures.append(name)
            if not all(r["applied"] for r in runs[True]) or not all(
                    bool(torch.isfinite(v)) for r in runs[True] for v in r["parts"].values()):
                failures.append(f"{name}: a micro-step did not apply, or a loss is not finite")
            compared[name] = row
            del runs
            torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = flags[:2]
        torch.use_deterministic_algorithms(flags[2], warn_only=flags[3])
    if failures:
        emit({"phase": "train_remat", "compared": compared, **card})
        raise AssertionError(f"remat on and off differ: {failures}")

    step_s = {False: [], True: []}
    for remat in (False, True, True, False):
        step_s[remat] += remat_step_s(torch, P, dev, cfg, sd, remat, batches)
        torch.cuda.empty_cache()

    pool = remat_pool(torch, P, dev)
    resolved = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_remat_") as tmp:
        old_cache = os.environ.get("TPU_MSLESSEG_AUTOBATCH_CACHE")
        os.environ["TPU_MSLESSEG_AUTOBATCH_CACHE"] = str(Path(tmp) / "autobatch.json")
        try:
            for scale in ("n",) + REMAT_WIDE:
                resolved[scale] = {f"remat_{'on' if r else 'off'}": remat_batch(
                    torch, P, dev, pool, scale, r) for r in (False, True)}
                if scale != "n" and all(v["batch"] for v in resolved[scale].values()):
                    break
        finally:
            if old_cache is None:
                os.environ.pop("TPU_MSLESSEG_AUTOBATCH_CACHE")
            else:
                os.environ["TPU_MSLESSEG_AUTOBATCH_CACHE"] = old_cache
    del pool
    torch.cuda.empty_cache()
    wide = next((s for s in REMAT_WIDE if s in resolved and
                 all(v["batch"] for v in resolved[s].values())), None)
    if resolved["n"]["remat_off"]["batch"] is None or resolved["n"]["remat_on"]["batch"] is None:
        raise AssertionError(f"batch -1 at scale n did not resolve: {resolved['n']}")
    median = {r: float(np.median(v)) for r, v in step_s.items()}
    emit({"phase": "train_remat", "model": "YOLO11n-seg", "imgsz": IMGSZ,
          "batch_size": cfg.batch_size, "max_fg": cfg.max_fg,
          "bit_for_bit": {k: v["differing"] == 0 for k, v in compared.items()},
          "deterministic_modes": True, "compared": compared,
          "rematerialised_layers": list(P.YOLO11Seg.REMAT_LAYERS),
          "bf16_s_per_micro_step_median": {"remat_off": median[False], "remat_on": median[True]},
          "bf16_s_per_micro_step": {"remat_off": step_s[False], "remat_on": step_s[True]},
          "time_ratio_on_over_off": median[True] / median[False],
          "batch_minus_1": resolved, "widest_scale_resolved": wide,
          "budget_fraction": P.autobatch.DEFAULT_FRACTION, **card})


# ---- phase 18: the demo, capacity mode, the extras, the native writer ------
DEMO_EPOCHS = 3  # epochs a demo fold and of the capacity run
DEMO_FOLD = {"P39": 4, "P18": 2}  # the demo patients' folds of 5
NATIVE_PNGS = 100  # stage-1-sized PNGs the native writer and encode_gray each write
CHECK_CONF = 0.001  # NMS confidence of the kernel checks (the validation's, as phase 16)


def write_demo_tree(root: Path, P) -> Path:
    """The demo subset's stand-in: P18 and P39 as synthetic 182x218x182
    FLAIR and mask volumes (phase 9's writer and lesion box). Returns the
    dataset dir."""
    ds = root / "MSLesSeg-Dataset" / "train"
    for pid in DEMO_FOLD:
        vol, gt = patient_volume(pid, CLI_LESION)
        P.nifti.save(vol.astype(np.float32), np.eye(4), ds / pid / "T1" / f"{pid}_T1_FLAIR.nii.gz")
        P.nifti.save(gt.astype(np.uint8), np.eye(4), ds / pid / "T1" / f"{pid}_T1_MASK.nii.gz")
    return ds


def importable(name: str) -> bool:
    return importlib.util.find_spec(name) is not None


def masks_near_threshold(k_logits, p_logits, t) -> dict:
    """The masks of kernel logits against those of plain logits at threshold
    `t`: they may differ only where the plain logit lies within
    ``NEAR_THRESHOLD`` of `t`. Raises beyond it."""
    differ = (k_logits > t) != (p_logits > t)
    worst = float((p_logits - t).abs()[differ].max()) if bool(differ.any()) else 0.0
    out = {"threshold": float(t), "positive_pixels": int((k_logits > t).sum()),
           "positive_pixels_plain": int((p_logits > t).sum()),
           "pixels_differing": int(differ.sum()), "worst_plain_logit_from_threshold": worst}
    if worst >= NEAR_THRESHOLD:
        raise AssertionError(f"plain-union masks differ away from the threshold: {out}")
    return out


def held_or_vacuous(positive: int) -> str:
    return "held" if positive else "vacuous: every mask is empty"


def demo_stage3_checks(torch, P, pred, u8, stored) -> dict:
    """One demo patient's stage-3 masks (`stored`, from its PNGs) against a
    direct `pred` call on the same enhanced slices `u8` (kernels on: equal),
    and the whole plain path (plain stem, epilogue and union) at the served
    confidence by its Dice; both are vacuous where every served mask is
    empty, and the returned dict says so. Then at NMS confidence
    ``CHECK_CONF``, which keeps boxes after three epochs of training: each
    kernel against its plain version on that call's own tensors (within its
    bound); the union's masks against the plain union's by the
    near-threshold rule, and the whole plain path's by their Dice, at the
    served threshold and at the median plain logit inside the kept boxes,
    which has positive pixels whatever the training learnt (required).
    Raises where one fails."""
    smodel, out = pred.model, {}
    masks = pred(u8)
    if not np.array_equal(stored, masks.cpu().numpy()):
        raise AssertionError("stage-3 masks != a direct SlicePredictor call")
    x = pred.lb.apply(P.geometry.to_png_space_batch(u8).to(torch.float32) / 255.0).to(smodel.dtype)
    got, want = P.stem.stem_apply(smodel, pred._stem_w, x), P.stem.stem_reference(smodel, pred._stem_w, x)
    torch.cuda.synchronize()
    out["stem"] = stem_errors(torch, P.stem, smodel, pred._stem_w, x, got, want)
    del got, want
    ys, xs = P.predictor.proto_grid(pred.lb, x.device)
    with switched(P.bn_act, "bn_act", P.bn_act.bn_act_ref), torch.inference_mode():
        served = P.detect_and_union(smodel, pred.variables, x[..., None], pred.imgsz, pred.conf,
                                    pred.iou, pred.max_det, mask_union=P.mu.mask_union_logits_ref)
    plain = P.geometry.from_png_space_batch(P.predictor._bilinear_sample(served, ys, xs)
                                            > pred.mask_thresh)
    out["served_conf"] = {"conf": pred.conf, "positive_pixels": int(masks.sum()),
                          "stored_equal_direct_and_plain_dice": held_or_vacuous(int(masks.sum())),
                          "plain_path_dice": dice(plain, masks),
                          "plain_path_pixels_differing": int((plain != masks).sum())}
    if out["served_conf"]["plain_path_dice"] < MIN_DICE:
        raise AssertionError(f"plain stem and union vs stage 3: {out['served_conf']} below {MIN_DICE}")

    rec, rec_plain = Recorder(P.mu.mask_union_logits_batch), Recorder(P.mu.mask_union_logits_ref)
    with torch.inference_mode():
        P.detect_and_union(smodel, pred.variables, x[..., None], pred.imgsz, CHECK_CONF, pred.iou,
                           pred.max_det, mask_union=rec, stem_w=pred._stem_w)
        with switched(P.bn_act, "bn_act", P.bn_act.bn_act_ref):
            P.detect_and_union(smodel, pred.variables, x[..., None], pred.imgsz, CHECK_CONF,
                               pred.iou, pred.max_det, mask_union=rec_plain)
    call, got = rec.last[:5], rec.last[5]
    want = P.mu.mask_union_logits_ref(*call)
    torch.cuda.synchronize()
    union = out["mask_union"] = check_union(torch, P.mu, call, got, want)
    union.update({"conf": CHECK_CONF, "kept_per_image": float(call[3].sum()) / call[3].shape[0]})
    boxed = want[want > P.mu._NEG / 2]  # the pixels that a kept box holds
    if boxed.numel() == 0:
        raise AssertionError(f"no kept box at NMS confidence {CHECK_CONF}")
    union["boxed_logit_quartiles"] = torch.quantile(
        boxed, torch.tensor([0.25, 0.5, 0.75], device=boxed.device)).tolist()
    k_logits, p_logits, path_logits = (P.predictor._bilinear_sample(u, ys, xs)
                                       for u in (got, want, rec_plain.last[5]))
    path = out["plain_path_at_check_conf"] = {
        "slices_whose_nms_keep_differs": int((rec_plain.last[3] != call[3]).any(dim=1).sum())}
    for name, t in (("served_threshold", pred.mask_thresh),
                    ("median_boxed_logit", float(boxed.median()))):
        union[name] = masks_near_threshold(k_logits, p_logits, t)
        union[name]["check"] = held_or_vacuous(union[name]["positive_pixels"])
        path[name] = {"threshold": float(t), "positive_pixels": int((path_logits > t).sum()),
                      "dice": dice(path_logits > t, k_logits > t),
                      "pixels_differing": int(((path_logits > t) != (k_logits > t)).sum())}
        path[name]["check"] = held_or_vacuous(path[name]["positive_pixels"])
        if path[name]["dice"] < MIN_DICE:
            raise AssertionError(f"plain stem and union at conf {CHECK_CONF}: {path} below {MIN_DICE}")
    if not union["median_boxed_logit"]["positive_pixels"] or \
            not path["median_boxed_logit"]["positive_pixels"]:
        raise AssertionError(f"no positive pixel at the median boxed logit: {union}, {path}")
    return out


def phase_demo(torch, P, root: Path, counters, dev, card, global_rows) -> dict:
    """Phase 18: the demo's two cases through ``ejecutar_demo_paciente(...,
    entrenar=True, epochs=3)`` (the CLI's patient mode: stage 1, one fold
    trained, stage 3 through the stage chain, then the GIF and the figure),
    the capacity mode, the extras and the native PNG writer."""
    import logging

    t_phase = time.perf_counter()
    ds = write_demo_tree(root, P)
    setup_s = time.perf_counter() - t_phase
    stage3, batches, rec_s = [], [], {}

    def serve(*a, **kw):
        before = read_launches(counters)
        out = real_serve(*a, **kw)
        torch.cuda.synchronize()
        after = read_launches(counters)
        stage3.append({k: after[k] - before[k] for k in after})
        return out

    def native_batch(paths, imgs, *a, **kw):
        batches.append(len(paths))
        return real_batch(paths, imgs, *a, **kw)

    real_serve, real_batch = P.gen.ejecutar_predicciones_pipeline, P.native.write_gray_png_batch
    viz = {"imageio": importable("imageio"), "matplotlib": importable("matplotlib")}
    warned = []  # the demo's warnings, in order
    handler = logging.Handler(logging.WARNING)
    handler.emit = lambda record: warned.append(record.getMessage()) \
        if record.levelno == logging.WARNING else None  # not the HEADER level above it
    demo_logger = logging.getLogger("ejecutar_demo")
    cwd = os.getcwd()
    with contextlib.ExitStack() as stack:
        stack.enter_context(switched(P.gen, "ejecutar_predicciones_pipeline", serve))
        stack.enter_context(switched(P.native, "write_gray_png_batch", native_batch))
        old_cache = os.environ.get("TPU_MSLESSEG_AUTOBATCH_CACHE")
        os.environ["TPU_MSLESSEG_AUTOBATCH_CACHE"] = str(root / "autobatch.json")
        stack.callback(lambda: os.environ.pop("TPU_MSLESSEG_AUTOBATCH_CACHE") if old_cache is None
                       else os.environ.update(TPU_MSLESSEG_AUTOBATCH_CACHE=old_cache))
        os.chdir(root)
        stack.callback(os.chdir, cwd)
        stack.callback(P.logging_setup.configure_logging, log_file=None)
        P.logging_setup.configure_logging(log_file=None)
        P.logging_setup.configure_logging_demo()
        demo_logger.addHandler(handler)
        stack.callback(demo_logger.removeHandler, handler)
        zero_launches(counters)
        for case in P.demo.DEMO_CASES:
            n_warn = len(warned)
            t0 = time.perf_counter()
            P.demo.ejecutar_demo_paciente(case["paciente_id"], case["mejora"], True, DEMO_EPOCHS)
            torch.cuda.synchronize()
            rec_s[case["paciente_id"]] = {"s": time.perf_counter() - t0,
                                          "warnings": warned[n_warn:]}
        launches = read_launches(counters)
    if not (root / "demo.log").is_file():
        raise AssertionError("configure_logging_demo wrote no demo.log")
    if len(stage3) != len(P.demo.DEMO_CASES):
        raise AssertionError(f"stage 3 ran {len(stage3)} times for {len(P.demo.DEMO_CASES)} cases")
    for k in ("mask_union", "stem"):
        if any(s[k] < 1 for s in stage3):
            raise AssertionError(f"a demo case's stage 3 did not launch the {k} kernel: {stage3}")
    if not batches:
        raise AssertionError("the demo wrote no PNG batch through the native writer")
    emit({"phase": "demo_kernels", "launches": launches,
          "stage3_launches": {c["paciente_id"]: s for c, s in zip(P.demo.DEMO_CASES, stage3)},
          "native_png_batches": len(batches), "native_pngs": sum(batches)})

    # each case: the fold's files, stage 3's artifacts, the kernels, the viz
    smodel, _, imgsz = P.create_model_from_env()
    cases = {}
    for case in P.demo.DEMO_CASES:
        pid, mejora = case["paciente_id"], case["mejora"]
        modelo = P.Modelo(plano="axial", num_cortes="P50", modalidad=["FLAIR"], k_folds=5,
                          mejora=mejora)
        cfg = P.ConfigTrain(modelo=modelo, epochs=DEMO_EPOCHS, fold_test=DEMO_FOLD[pid], root=root)
        have = {str(p.relative_to(cfg.fold_dir)) for p in cfg.fold_dir.rglob("*") if p.is_file()}
        want = {"args.yaml", "results.csv", "weights/best.pt", "weights/last.pt",
                "weights/fitness.json"}
        if not want <= have:
            raise AssertionError(f"{pid}: fold {DEMO_FOLD[pid]} lacks {sorted(want - have)}")
        with open(cfg.fold_dir / "results.csv") as f:
            rows = list(csv.reader(f))[1:]
        losses = [float(v) for r in rows for v in r[TRAIN_LOSS_COLS[0]]]
        if len(rows) != DEMO_EPOCHS or not all(np.isfinite(losses)):
            raise AssertionError(f"{pid}: results.csv {rows}")
        exp = f"{modelo.base_path}_{DEMO_EPOCHS}epochs"
        fold = f"fold{DEMO_FOLD[pid]}"
        for f in (root / "pred_vols" / exp / fold / pid / f"{pid}_axial.nii.gz",
                  root / "results" / exp / fold / pid / f"{pid}_axial_results.json"):
            if not f.is_file():
                raise AssertionError(f"{pid}: no {f.relative_to(root)}")
        base = P.gif.prediction_dir(modelo, pid, root)
        preds = sorted(base.glob("pred_masks/*.png"))
        ids = sorted(int(p.stem.rsplit("_", 1)[1]) for p in preds)
        if not ids:
            raise AssertionError(f"{pid}: stage 3 wrote no pred_masks")
        pac = P.Paciente(id=pid, plano="axial", modalidad=["FLAIR"], mejora=mejora, dataset_dir=ds)
        u8 = P.enhance.enhance_for_model(
            torch.from_numpy(pac.cortes_imagen_batch(ids, "FLAIR")).to(dev), mejora)
        stored = np.stack([P.png.load_pred_png(base / "pred_masks" / f"{pid}_FLAIR_{i}.png")
                           for i in ids]) > 0
        pred = P.SlicePredictor(smodel, P.load_checkpoint(cfg.best_ckpt), tuple(u8.shape[1:]),
                                imgsz=imgsz, device=dev)
        if pred._stem_w is None:
            raise AssertionError(f"{pid}: the direct predictor did not take the fused stem")
        checks = demo_stage3_checks(torch, P, pred, u8, stored)

        # the viz: frames and slice computed here; files where the libraries import
        frames, fps, gif_path = P.gif.preparar_gif(modelo, pid, DEMO_EPOCHS, root=root)
        if len(frames) != len(preds):
            raise AssertionError(f"{pid}: {len(frames)} GIF frames for {len(preds)} predictions")
        idx, slice_dsc, _ = P.figure.seleccionar_mejor_corte(
            P.gif.collect_slices(base, pid, "FLAIR"))
        fig_path = gif_path.parent / f"{pid}_FLAIR_{idx}.png"
        case_warned = rec_s[pid]["warnings"]
        want_gif = viz["imageio"]
        want_fig = viz["imageio"] and viz["matplotlib"]
        if gif_path.is_file() != want_gif or fig_path.is_file() != want_fig:
            raise AssertionError(f"{pid}: GIF written {gif_path.is_file()}, figure written "
                                 f"{fig_path.is_file()} with {viz}")
        if len(case_warned) != (0 if want_fig else 1) or \
                any("Visualización no generada" not in w for w in case_warned):
            raise AssertionError(f"{pid}: viz warnings {case_warned} with {viz}")
        if not want_gif and (root / "visualizaciones").exists():
            raise AssertionError(f"{pid}: the viz wrote files without imageio")
        cases[pid] = {"mejora": mejora, "fold": DEMO_FOLD[pid], "slices": len(ids),
                      "s": rec_s[pid]["s"], "stage3_vs_plain": checks, "gif_frames": len(frames),
                      "gif_fps": fps, "figure_slice": idx, "figure_slice_dsc": slice_dsc,
                      "figure_slice_check": held_or_vacuous(
                          checks["served_conf"]["positive_pixels"]),
                      "results": json.loads((root / "results" / exp / fold / pid /
                                             f"{pid}_axial_results.json").read_text())}
    branch = ("gif_and_figure_written" if viz["imageio"] and viz["matplotlib"] else
              "gif_written_figure_warned" if viz["imageio"] else "one_warning_per_case_nothing_written")
    emit({"phase": "viz_18", "imports": viz, "branch": branch,
          "warnings": {pid: r["warnings"] for pid, r in rec_s.items()}})
    emit({"phase": "demo", "model": "YOLO11n-seg", "imgsz": imgsz, "dtype": str(smodel.dtype),
          "epochs": DEMO_EPOCHS, "k_folds": 5, "cases": cases, "demo_log": True,
          "informational": {"setup_s": setup_s, **card}})

    # capacity mode on the same two patients
    rec = {}

    def capture(*a, **kw):
        rec["res"] = real_cap(*a, **kw)
        return rec["res"]

    real_cap = P.capacidad.ejecutar_capacidad
    zero_launches(counters)
    t0 = time.perf_counter()
    with contextlib.ExitStack() as stack:
        stack.enter_context(switched(P.capacidad, "ejecutar_capacidad", capture))
        os.chdir(root)
        stack.callback(os.chdir, cwd)
        met = P.capacidad.main(["--epochs", str(DEMO_EPOCHS), "--batch", "8", "--dataset", str(ds)])
    torch.cuda.synchronize()
    cap_s = time.perf_counter() - t0
    cap_launches = read_launches(counters)
    res = rec["res"]
    losses = [v for e in res["perdidas"] for v in e.values()]
    if len(res["perdidas"]) != DEMO_EPOCHS or not all(np.isfinite(losses)):
        raise AssertionError(f"capacity mode: losses {res['perdidas']}")
    if not (root / res["pesos"]).is_file():
        raise AssertionError("capacity mode wrote no best.pt")
    if set(met) != {"DSC", "AUC", "Precision", "Recall"} or \
            not all(np.isfinite(list(met.values()))):
        raise AssertionError(f"capacity mode: metrics {met}")
    if cap_launches["mask_union"] < 1 or cap_launches["stem"] < 1:
        raise AssertionError(f"capacity mode's evaluation launched {cap_launches}")
    emit({"phase": "capacidad", "epochs": DEMO_EPOCHS, "batch": res["batch"], "metrics": met,
          "losses": res["perdidas"], "launches": cap_launches,
          "micro_step_ms_warm_epochs": res["paso_ms"], "run_s": cap_s, **card})

    # the extras: the demo tree's per-patient JSONs, phase 10's global ones
    resumen = P.analizar.analizar_resultados(root / "results")
    if {k.split("/")[0] for k in resumen} != {c["mejora"] for c in P.demo.DEMO_CASES}:
        raise AssertionError(f"analizar_resultados: {resumen}")
    if not global_rows or any(set(r) < {"Mejora", "Config", "Plano", "DSC"} for r in global_rows):
        raise AssertionError(f"componer_resultados: {global_rows}")
    emit({"phase": "extras", "analizar_resultados": resumen, "componer_resultados": global_rows})

    # the native PNG writer: built here, the same bytes as encode_gray
    if not P.native.available():
        raise AssertionError(f"the native PNG writer did not build: {P.native.build_error}")
    gen = np.random.default_rng(18)
    imgs = (gen.random((NATIVE_PNGS, VOL_SHAPE[1], VOL_SHAPE[0])) ** 3 * 255).astype(np.uint8)
    out = root / "native_pngs"
    out.mkdir()
    paths = [out / f"{i}.png" for i in range(NATIVE_PNGS)]
    t0 = time.perf_counter()
    ok = P.native.write_gray_png_batch(paths, imgs)
    native_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for i, a in enumerate(imgs):  # the fallback: encode_gray, one file at a time
        (out / f"e{i}.png").write_bytes(P.png.encode_gray(a))
    encode_s = time.perf_counter() - t0
    if not ok or any(p.read_bytes() != (out / f"e{i}.png").read_bytes()
                     for i, p in enumerate(paths)):
        raise AssertionError("the native writer's PNGs differ from encode_gray's")
    emit({"phase": "native_png", "built": True, "pngs": NATIVE_PNGS,
          "shape": list(imgs.shape[1:]), "equal_bytes": True,
          "host_s_native_batch_write": native_s, "host_s_encode_gray_write": encode_s,
          "phase_s": time.perf_counter() - t_phase, **card})
    return {"launches": launches, "capacity_launches": cap_launches}


def phase_nms(torch, P, calls, dev) -> dict:
    """Phase 8's NMS checks beyond the dispatch's own three calls (`calls`,
    from ``recording_nms``), kernel against plain bit for bit: the first
    call's boxes and scores at NMS confidence ``CHECK_CONF`` (the
    validation's: nearly every candidate valid) and at 1.0 (none valid); a
    chain of ``NMS_CHAIN`` links among 8,400 anchors (the plain fixpoint
    must take a step a link); pairs of boxes at, one ulp above and one
    ulp below each of ``NMS_PAIR_THRESHOLDS``, whose second box must go only
    above it (the comparison in float32); the first call's first 50 images
    (a patient's plane in stage 3) and the three calls' 600 images as one
    call (a GC dispatch's shared-weight batch), each suppression also
    graph-timed. Then that call under
    ``torch.cuda.set_sync_debug_mode("error")``: through the kernel it
    raises nothing; through the plain version, the control, it raises."""
    boxes, scores, conf, iou, max_det = calls[0]["args"]
    read = {"conf_0.001": nms_against_plain(torch, P, (boxes, scores, CHECK_CONF, iou, max_det)),
            "none_valid": nms_against_plain(torch, P, (boxes, scores, 1.0, iou, max_det))}
    for name, args in (
            ("b50", (boxes[:50], scores[:50], conf, iou, max_det)),
            ("b600", (torch.cat([c["args"][0] for c in calls]),
                      torch.cat([c["args"][1] for c in calls]), conf, iou, max_det))):
        read[name] = nms_against_plain(torch, P, args)
        seen = []
        with switched(P.nms, "suppress", lambda *a: seen.append(a) or P.nms.suppress_ref(*a)):
            P.nms.nms_batch(*args)
        read[name]["kernel_ms"] = graph_ms(torch, lambda a=seen[0]: P.nms.suppress(*a), 20)
    if read["none_valid"]["kept_per_image"] != 0.0:
        raise AssertionError("NMS kept a candidate with no valid score")
    b, sc = P.nms_cases.chain(NMS_CHAIN, boxes.shape[1])
    read["chain"] = nms_against_plain(torch, P, (torch.from_numpy(b).to(dev),
                                                 torch.from_numpy(sc).to(dev), 0.25, iou, max_det))
    if read["chain"]["plain_steps"] < NMS_CHAIN:
        raise AssertionError(f"the chain took the plain fixpoint {read['chain']['plain_steps']} "
                             f"steps, not {NMS_CHAIN} or more")
    for thr in NMS_PAIR_THRESHOLDS:
        b, sc, ious = P.nms_cases.threshold_pairs(thr, 30, 7)
        args = (torch.from_numpy(b).to(dev), torch.from_numpy(sc).to(dev), 0.25, thr, max_det)
        read[f"pairs_{thr}"] = nms_against_plain(torch, P, args)
        second = P.nms.nms_batch(*args)[2][0, 1:2 * len(ious):2].cpu().numpy()
        if not np.array_equal(second, ious <= np.float32(thr)):
            raise AssertionError(f"pairs at {thr}: the suppression does not compare the IoU "
                                 "with the threshold in float32")
    torch.cuda.synchronize()
    control = "did not raise"
    torch.cuda.set_sync_debug_mode("error")
    try:
        P.nms.nms_batch(*calls[0]["args"])
        try:
            with switched(P.nms, "suppress", P.nms.suppress_ref):
                P.nms.nms_batch(*calls[0]["args"])
        except RuntimeError as err:
            control = str(err).splitlines()[0]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    if control == "did not raise":
        raise AssertionError("the plain NMS raised nothing under sync-debug mode: the check "
                             "sees no sync")
    read["sync_debug_error_mode"] = {"kernel": "no sync", "plain_control": control}
    read["torchvision_importable"] = importable("torchvision")
    return read


def phase_bn_act(torch, P, smodel, x, dev, card) -> dict:
    """The last part of phase 8: the Conv blocks' fused BN + SiLU
    (``model/bn_act.py``) on every Conv output of one served forward of
    YOLO11n-seg at 640 in bf16 (the stem on; `x` one plane's 200
    letterboxed images), every BatchNorm's terms away from init: each
    launch against the plain version (within one ulp of bf16, the elements
    that differ counted), the launches a forward, and all of them timed
    against the plain passes with their bound (4 bytes an element)."""
    sd = P.init_variables(smodel, seed=7)
    gen = torch.Generator().manual_seed(8)
    for k, v in sd.items():
        if k.endswith(".bn.running_var"):
            v.copy_(torch.rand(v.shape, generator=gen) * 3 + 1e-4)
        elif k.endswith((".bn.running_mean", ".bn.bias")):
            v.copy_(torch.randn(v.shape, generator=gen) * 0.5)
        elif k.endswith(".bn.weight"):
            v.copy_(1 + 0.3 * torch.randn(v.shape, generator=gen))
    variables = P.predictor.prepare_variables(smodel, sd, dev)
    calls = []
    before = P.bn_act.LAUNCHES
    with recording_epilogues(P, calls), torch.inference_mode():
        P.detect_and_union(smodel, variables, x[..., None], IMGSZ, 0.25, 0.7, 300,
                           stem_w=P.stem.stem_weights(variables))
    torch.cuda.synchronize()
    launches = P.bn_act.LAUNCHES - before
    if launches != len(calls) or launches < 1:
        raise AssertionError(f"a served forward launched the fused epilogue {launches} times "
                             f"for {len(calls)} Conv blocks")
    checks = bn_act_checks(torch, P, calls, 3, 2)
    what = f"one served forward of {x.shape[0]} images of {IMGSZ}: {launches} launches"
    emit_bound("bn_act", checks["work"], checks["ms"], launches, what)
    emit({"phase": "timing", "kernel": "bn_act", "work": what, "dtype": "bfloat16",
          "launches_per_forward": launches,
          "channels": sorted({int(y.shape[1]) for y, _, _ in calls}),
          "maps": sorted({f"{y.shape[2]}x{y.shape[3]}" for y, _, _ in calls}),
          "nchw_launches": sum(bool(y.is_contiguous()) for y, _, _ in calls),
          "without_act": sum(not act for _, _, act in calls),
          **checks["errs"], "kernel_ms": checks["kernel_ms_blocks"],
          "plain_ms": checks["plain_ms_blocks"],
          "share_of_bound": checks["work"]["bound_ms"] / checks["ms"], **card})
    return checks


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
    from tpu_mslesseg_torch.core import geometry, profiling
    from tpu_mslesseg_torch.evalx import metrics as mx
    from tpu_mslesseg_torch.infer import mask_union as mu
    from tpu_mslesseg_torch.infer import nms
    from tpu_mslesseg_torch.infer.consensus3 import ConsensusPredictor
    from tpu_mslesseg_torch.infer.predictor import SlicePredictor, detect_and_union
    from tpu_mslesseg_torch.infer.reconstruct import consensus_vote, reconstruct_volume
    from tpu_mslesseg_torch.io import nifti, png
    from tpu_mslesseg_torch.model import bn_act, stem
    from tpu_mslesseg_torch.model.yolo11 import (
        STRIDES, YOLO11Seg, create_model, create_model_from_env, fold_gray_stem, init_variables,
    )
    from tpu_mslesseg_torch.pipeline import ejecutar_pipeline as orch
    from tpu_mslesseg_torch.pipeline import labels, logging_setup, rapido
    from tpu_mslesseg_torch.pipeline.modelo import Modelo
    from tpu_mslesseg_torch.pipeline.paciente import Paciente
    from tpu_mslesseg_torch.pipeline.paths import ConfigPred, ConfigTrain
    from tpu_mslesseg_torch.pipeline.stages import generar_predicciones as gen_stage
    from tpu_mslesseg_torch.preproc import clahe, enhance
    from tpu_mslesseg_torch.tools import nms_cases
    from tpu_mslesseg_torch.tools.train_batches import synthetic_batch as train_batch
    from tpu_mslesseg_torch.core import distributed, mesh
    from tpu_mslesseg_torch.train import (
        augment, autobatch, engine, engine_parallel, fold_parallel, trainer, validate,
    )
    from tpu_mslesseg_torch.train import data as tdata
    from tpu_mslesseg_torch.train.checkpoint import load_checkpoint, save_checkpoint
    from tpu_mslesseg_torch.demo import ejecutar_demo, entrenar_capacidad
    from tpu_mslesseg_torch.extras import analizar_pacientes_dsc, componer_resultados
    from tpu_mslesseg_torch.infer import predictor
    from tpu_mslesseg_torch.io import native
    from tpu_mslesseg_torch.viz import figure, gif

    # the port's modules the CLI phases use
    P = types.SimpleNamespace(
        Modelo=Modelo, Paciente=Paciente, ConfigTrain=ConfigTrain, ConfigPred=ConfigPred,
        nifti=nifti, png=png, create_model=create_model,
        create_model_from_env=create_model_from_env, init_variables=init_variables,
        STRIDES=STRIDES, save_checkpoint=save_checkpoint, load_checkpoint=load_checkpoint,
        mx=mx, consensus_vote=consensus_vote, reconstruct_volume=reconstruct_volume,
        geometry=geometry, enhance=enhance, SlicePredictor=SlicePredictor,
        profiling=profiling, orch=orch, gen=gen_stage, logging_setup=logging_setup,
        mu=mu, stem=stem, clahe=clahe, bn_act=bn_act, detect_and_union=detect_and_union,
        ConsensusPredictor=ConsensusPredictor, fold_gray_stem=fold_gray_stem,
        trainer=trainer, synthetic_batch=train_batch, autobatch=autobatch, engine=engine,
        validate=validate, rapido=rapido, engine_parallel=engine_parallel,
        fold_parallel=fold_parallel, distributed=distributed, mesh=mesh,
        demo=ejecutar_demo, capacidad=entrenar_capacidad, analizar=analizar_pacientes_dsc,
        native=native, gif=gif, figure=figure, predictor=predictor, labels=labels, nms=nms,
        nms_cases=nms_cases, YOLO11Seg=YOLO11Seg, augment=augment, tdata=tdata,
    )

    dev = torch.device(DEVICE)
    # full f32 in the plain versions' matmuls and convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_label(torch)
    # each kernel's launch count: (module, counter)
    counters = {"mask_union": (mu, "LAUNCHES"), "clahe_tile_lut": (clahe, "LAUNCHES"),
                "clahe_blend": (clahe, "BLEND_LAUNCHES"), "stem": (stem, "LAUNCHES"),
                "bn_act": (bn_act, "LAUNCHES"), "nms": (nms, "LAUNCHES")}
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
    gc_launches = read_launches(counters)  # the GC path: the union, the epilogue, NMS
    launches = gc_launches["mask_union"]
    if launches < 1:
        raise AssertionError("the main path did not launch the mask-union kernel")
    if gc_launches["nms"] != launches:
        raise AssertionError(f"the main path launched NMS {gc_launches['nms']} times for "
                             f"{launches} union launches")

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

    phase_enhancement(torch, enhance, slices, dev)

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
            nms_calls = []  # phase 8's NMS inputs: what this dispatch's nms_batch calls get
            with recording_nms(P, nms_calls):
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

    # NMS's suppression on the dispatch's three nms_batch calls (a plane each)
    if len(nms_calls) != len(PLANES):
        raise AssertionError(f"{len(nms_calls)} nms_batch calls in a per-plane lote")
    nms_calls = dict(zip(PLANES, nms_calls))
    nms_read = {p: nms_against_plain(torch, P, c["args"]) for p, c in nms_calls.items()}
    time_dispatch(
        "nms",
        {p: ((lambda c=c["suppress"]: nms.suppress(*c)),
             (lambda c=c["suppress"]: nms.suppress_ref(*c))) for p, c in nms_calls.items()},
        20, 3, lambda p: nms_work(*nms_calls[p]["suppress"][:2]),
        lambda p: {"n": int(nms_calls[p]["args"][1].shape[0]),
                   "anchors": int(nms_calls[p]["args"][1].shape[1]),
                   "k": int(nms_calls[p]["suppress"][1].shape[1]), "conf": nms_calls[p]["args"][2],
                   "valid_per_image": float(nms_calls[p]["suppress"][1].sum())
                   / nms_calls[p]["suppress"][1].shape[0], **nms_read[p]},
        graph=True,
    )
    emit({"phase": "nms_checks", "inputs": "the first plane's call of phase 7's dispatch, a "
          "chain, pairs at the threshold, 50 and 600 images",
          **phase_nms(torch, P, list(nms_calls.values()), dev)})
    del nms_calls

    time_dispatch(
        "stem",
        {p: ((lambda x=x, w=stem_w[p]: stem.stem_apply(smodel, w, x)),
             (lambda x=x, w=stem_w[p]: stem.stem_reference(smodel, w, x)))
         for p, x in stem_x.items()},
        5, 3, lambda p: stem_work(stem_x[p], stem.stem_apply(smodel, stem_w[p], stem_x[p])),
        lambda p: {"m": int(stem_x[p].shape[0]), "imgsz": IMGSZ, **stem_inputs[p]},
    )
    epilogue_x = stem_x[PLANES[0]]  # the last part of phase 8: one plane's served input
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
    del x
    torch.cuda.empty_cache()

    # the Conv blocks' fused BN + SiLU on every Conv output of one served forward
    epilogue = phase_bn_act(torch, P, smodel, epilogue_x, dev, card)
    timing["bn_act"] = (epilogue["ms"], epilogue["plain_ms"])
    works["bn_act"] = epilogue["work"]
    max_err["bn_act"] = epilogue["errs"]["max_abs_err"]
    del epilogue_x, epilogue
    torch.cuda.empty_cache()

    # ---- phases 9 and 10: the orchestrator CLI ----------------------------
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_") as tmp:
        chain = phase_cli_chain(torch, P, Path(tmp) / "chain", counters, dev)
        default = phase_cli_default(torch, P, Path(tmp) / "chain", Path(tmp) / "default",
                                    chain, counters, dev)
        # phase 18's results table: the global JSONs of phase 9's three planes
        global_rows = componer_resultados.componer_resultados(Path(tmp) / "chain" / "results")
    torch.cuda.empty_cache()

    # ---- phases 11 and 12: the stem at every scale, served at s, m and n ---
    stem_scales = phase_stem_scales(torch, P, gen, dev, card)
    for row in stem_scales.values():
        max_err["stem"] = max(max_err["stem"], row["max_abs_err"], row["f32_max_abs_err"])
    scale_s_launches = phase_lote_wide(torch, P, slices, idx, gts, counters, dev, "s",
                                       torch.bfloat16)
    torch.cuda.empty_cache()
    scale_m_launches = phase_lote_wide(torch, P, slices, idx, gts, counters, dev, "m",
                                       torch.float32)
    torch.cuda.empty_cache()
    scale_n_launches = phase_lote_wide(torch, P, slices, idx, gts, counters, dev, "n",
                                       torch.float32)
    torch.cuda.empty_cache()

    # ---- phases 13 and 14: the train step ----------------------------------
    zero_launches(counters)
    phase_train(torch, P, dev, card)
    train_launches = read_launches(counters)  # the train step holds no kernel: all 0
    torch.cuda.empty_cache()
    phase_train_f32(torch, P, dev)
    torch.cuda.empty_cache()

    # ---- phase 19: rematerialised training against the stored step ---------
    zero_launches(counters)
    phase_train_remat(torch, P, dev, card)
    remat_launches = read_launches(counters)  # the train step holds no kernel: all 0
    torch.cuda.empty_cache()

    # ---- phase 15: train a fold through the CLI, then serve it -------------
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        train_cli = phase_train_cli(torch, P, Path(tmp), counters, dev, card)
    torch.cuda.empty_cache()

    # ---- phase 16: train every fold at once through the CLI, then serve ----
    with tempfile.TemporaryDirectory(prefix="chip_smoke_parallel_") as tmp:
        train_par = phase_train_parallel_cli(torch, P, Path(tmp), counters, dev, card,
                                             train_cli["figures"])
    for name in KERNELS:
        max_err[name] = max(max_err[name], train_par["checks"][name]["errs"]["max_abs_err"])
    torch.cuda.empty_cache()

    # ---- phase 17: one rank of nccl, the collective step against the plain --
    phase_nccl_one_rank(torch, P, dev, card)
    torch.cuda.empty_cache()

    # ---- phase 18: the demo, capacity mode, the extras, the native writer ---
    with tempfile.TemporaryDirectory(prefix="chip_smoke_demo_") as tmp:
        demo = phase_demo(torch, P, Path(tmp), counters, dev, card, global_rows)
    torch.cuda.empty_cache()

    by_path = {"lote_gc": gc_launches, "rapido_fold": fold_launches,
               "cli_chain": chain["launches"], "cli_default": default["launches"],
               "lote_scale_s": scale_s_launches, "lote_scale_m_f32": scale_m_launches,
               "lote_scale_n_f32": scale_n_launches,
               "train": train_launches, "train_remat": remat_launches,
               "train_cli_then_serve": train_cli["launches"],
               "train_paralelo": train_par["launches"], "demo": demo["launches"],
               "capacidad": demo["capacity_launches"]}

    for name in KERNELS:
        max_err[name] = max(max_err[name], chain["kernels"][name]["max_abs_err"])
    # `launches`, `ms`, `plain_ms` and the bound are the rapido fold's (phase
    # 6: two dispatches, timed a dispatch in phase 8); `cli_chain` holds the
    # same for phase 9, whose stage 3 launches on 50 images a call
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": source, "replaces": replaces,
         "launches": fold_launches[name],
         "launches_by_path": {k: v[name] for k, v in by_path.items()},
         "max_abs_err": max_err[name],
         "ms": timing[name][0], "plain_ms": timing[name][1],
         "bound_ms": works[name]["bound_ms"], "bound_by": works[name]["bound_by"],
         "library_ms": None, "work": WORKS.get(name, dispatch),
         "cli_chain": chain["kernels"][name],
         **({"scales": stem_scales} if name == "stem" else {}),
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
