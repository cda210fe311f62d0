"""The demo's kernel-against-plain check over other training runs.

    python -m tpu_mslesseg_torch.tools.demo_drift [--seeds 0 1 2]
        [--tails log1p_exp softplus] [--out FILE]

Run from the root of a checkout on a machine with a card. ``chip_smoke.py``
phase 18 trains the demo's two cases for three epochs and then holds the
whole plain path (cuDNN's stem, ``bn_act_ref``, ``mask_union_logits_ref``)
against the kernel path at NMS confidence 0.001 by their Dice, at least
0.99 at the served threshold and at the median boxed logit. This tool
trains the same cases the same way (``ejecutar_demo_paciente`` on phase 18's
synthetic P39 and P18, in a temporary experiment tree) for each training
seed (``TrainConfig.seed``) and each form of the BCE tail: ``log1p_exp``,
``log1p(exp(-|x|))`` as ``train/losses.py`` has it, and ``softplus``, the
same value as one ``F.softplus`` (its backward rounds otherwise). It then
serves each case's ``best.pt`` four ways at that confidence:

- ``kernel``: bf16, the fused stem, the epilogue and union kernels;
- ``kernel_no_stem``: the same with cuDNN's stem;
- ``plain``: bf16, phase 18's plain path;
- ``f32``: float32 and plain, TF32 off: what both bf16 paths are read against.

For each pair of runs it prints the slices whose NMS keep differs (as phase
18 counts them: by candidate, so a reordering counts; their indices and
each run's kept boxes on them), those whose count of kept boxes differs, and the Dice and differing
pixels of their masks at the served threshold and at the median boxed logit
(phase 18's thresholds: the kernel run's median for the pairs with it, the
float32 run's for the others). One JSON line a case, also written to
``--out`` where it is given.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import os
import sys
import tempfile
import time
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[2]
RUNS = ("kernel", "kernel_no_stem", "plain", "f32")
PAIRS = (("kernel", "plain"), ("kernel", "f32"), ("plain", "f32"),
         ("kernel_no_stem", "plain"), ("kernel", "kernel_no_stem"))


def softplus_bce(logits, labels):
    """``losses.sigmoid_bce`` with its tail as one ``F.softplus``."""
    return (logits + logits.abs()) * 0.5 - logits * labels + F.softplus(-logits.abs())


def serve_runs(cs, P, pred, model32, variables, x) -> dict:
    """The four runs of `pred`'s model, and of `model32` on the same
    checkpoint `variables`, on letterboxed slices `x` [M, S, S] f32 at
    ``cs.CHECK_CONF``: each run's NMS keep [M, K], its union logits sampled
    to PNG space [M, h, w] and the median of its boxed logits."""
    ys, xs = P.predictor.proto_grid(pred.lb, x.device)
    vars32 = {k: v.float() if v.is_floating_point() else v for k, v in
              P.predictor.prepare_variables(model32, variables, x.device).items()}
    plain = functools.partial(cs.switched, P.bn_act, "bn_act", P.bn_act.bn_act_ref)
    setups = {
        "kernel": (pred.model, pred.variables, pred._stem_w, P.mu.mask_union_logits_batch,
                   contextlib.nullcontext),
        "kernel_no_stem": (pred.model, pred.variables, None, P.mu.mask_union_logits_batch,
                           contextlib.nullcontext),
        "plain": (pred.model, pred.variables, None, P.mu.mask_union_logits_ref, plain),
        "f32": (model32, vars32, None, P.mu.mask_union_logits_ref, plain),
    }
    out = {}
    for name, (model, variables, stem_w, union, ctx) in setups.items():
        rec = cs.Recorder(union)
        with ctx(), torch.inference_mode():
            P.predictor.detect_and_union(model, variables, x.to(model.dtype)[..., None],
                                         pred.imgsz, cs.CHECK_CONF, pred.iou, pred.max_det,
                                         mask_union=rec, stem_w=stem_w)
        logits = rec.last[5]
        boxed = logits[logits > P.mu._NEG / 2]
        out[name] = {"keep": rec.last[3],
                     "logits": P.predictor._bilinear_sample(logits, ys, xs),
                     "median_boxed": float(boxed.median()) if boxed.numel() else None}
    return out


def compare(cs, runs: dict, a: str, b: str, served_t: float) -> dict:
    """Run `a` against run `b`: the slices whose keep differs and the masks'
    Dice at the served threshold and at the median boxed logit."""
    ka, kb = runs[a]["keep"], runs[b]["keep"]
    differ = (ka != kb).any(dim=1).nonzero().flatten().tolist()
    median = runs[a if a == "kernel" else b]["median_boxed"]
    counts = ka.sum(1) != kb.sum(1)
    out = {"slices_whose_keep_differs": len(differ), "slices": differ,
           "slices_whose_kept_count_differs": int(counts.sum()),
           "kept_on_them": {a: [int(ka[i].sum()) for i in differ],
                            b: [int(kb[i].sum()) for i in differ]}}
    for tname, t in (("served_threshold", served_t), ("median_boxed_logit", median)):
        if t is None:
            out[tname] = None
            continue
        ma, mb = runs[a]["logits"] > t, runs[b]["logits"] > t
        per_slice = (ma != mb).flatten(1).sum(1)
        out[tname] = {"threshold": t, "dice": cs.dice(ma, mb),
                      "pixels_differing": int(per_slice.sum()),
                      "positive_pixels": [int(ma.sum()), int(mb.sum())],
                      "pixels_differing_on_keep_slices": int(per_slice[differ].sum())}
    return out


def train_and_read(cs, P, root: Path, ds: Path, dev, model32) -> list[dict]:
    """Phase 18's two demo cases trained in `root`, each case's four runs
    compared."""
    rows = []
    for case in P.demo.DEMO_CASES:
        pid, mejora = case["paciente_id"], case["mejora"]
        P.demo.ejecutar_demo_paciente(pid, mejora, True, cs.DEMO_EPOCHS)
        modelo = P.Modelo(plano="axial", num_cortes="P50", modalidad=["FLAIR"], k_folds=5,
                          mejora=mejora)
        cfg = P.ConfigTrain(modelo=modelo, epochs=cs.DEMO_EPOCHS, fold_test=cs.DEMO_FOLD[pid],
                            root=root)
        base = P.gif.prediction_dir(modelo, pid, root)
        ids = sorted(int(p.stem.rsplit("_", 1)[1]) for p in base.glob("pred_masks/*.png"))
        pac = P.Paciente(id=pid, plano="axial", modalidad=["FLAIR"], mejora=mejora,
                         dataset_dir=ds)
        u8 = P.enhance.enhance_for_model(
            torch.from_numpy(pac.cortes_imagen_batch(ids, "FLAIR")).to(dev), mejora)
        smodel, _, imgsz = P.create_model_from_env()
        variables = P.load_checkpoint(cfg.best_ckpt)
        pred = P.SlicePredictor(smodel, variables, tuple(u8.shape[1:]), imgsz=imgsz, device=dev)
        if pred._stem_w is None and dev.type == "cuda":
            raise AssertionError(f"{pid}: the predictor did not take the fused stem")
        x = pred.lb.apply(P.geometry.to_png_space_batch(u8).to(torch.float32) / 255.0)
        runs = serve_runs(cs, P, pred, model32, variables, x)
        rows.append({"patient": pid, "mejora": mejora, "slices": len(ids),
                     "kept": {r: int(runs[r]["keep"].sum()) for r in RUNS},
                     "median_boxed_logit": {r: runs[r]["median_boxed"] for r in RUNS},
                     **{f"{a}_vs_{b}": compare(cs, runs, a, b, pred.mask_thresh)
                        for a, b in PAIRS}})
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--tails", nargs="+", default=["log1p_exp", "softplus"],
                    choices=["log1p_exp", "softplus"])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("demo_drift: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    os.environ.update(cs.SERVING_ENV)
    from tpu_mslesseg_torch import _build
    from tpu_mslesseg_torch.core import geometry
    from tpu_mslesseg_torch.demo import ejecutar_demo
    from tpu_mslesseg_torch.infer import mask_union as mu
    from tpu_mslesseg_torch.infer import predictor
    from tpu_mslesseg_torch.infer.predictor import SlicePredictor
    from tpu_mslesseg_torch.io import nifti
    from tpu_mslesseg_torch.model import bn_act
    from tpu_mslesseg_torch.model.yolo11 import create_model, create_model_from_env
    from tpu_mslesseg_torch.pipeline import logging_setup
    from tpu_mslesseg_torch.pipeline.modelo import Modelo
    from tpu_mslesseg_torch.pipeline.paciente import Paciente
    from tpu_mslesseg_torch.pipeline.paths import ConfigTrain
    from tpu_mslesseg_torch.pipeline.stages import train as train_stage
    from tpu_mslesseg_torch.preproc import enhance
    from tpu_mslesseg_torch.train import losses
    from tpu_mslesseg_torch.train.checkpoint import load_checkpoint
    from tpu_mslesseg_torch.viz import gif

    P = argparse.Namespace(
        geometry=geometry, demo=ejecutar_demo, mu=mu, predictor=predictor,
        SlicePredictor=SlicePredictor, nifti=nifti, bn_act=bn_act,
        create_model_from_env=create_model_from_env, Modelo=Modelo, Paciente=Paciente,
        ConfigTrain=ConfigTrain, enhance=enhance, load_checkpoint=load_checkpoint, gif=gif)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.load_all(cs.SOURCES)
    card = cs.card_label(torch)
    dev = torch.device(cs.DEVICE)
    model32 = create_model(nc=1, scale="n", dtype=torch.float32)[0].to(dev)
    tails = {"log1p_exp": losses.sigmoid_bce, "softplus": softplus_bce}
    cwd = os.getcwd()
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory() as tmp, \
            open(args.out or os.devnull, "w") as log:
        os.environ["TPU_MSLESSEG_AUTOBATCH_CACHE"] = str(Path(tmp) / "autobatch.json")
        for seed in args.seeds:
            for tail in args.tails:
                root = Path(tmp) / f"seed{seed}_{tail}"
                root.mkdir()
                ds = cs.write_demo_tree(root, P)
                t0 = time.perf_counter()
                with contextlib.ExitStack() as stack:
                    stack.enter_context(cs.switched(losses, "sigmoid_bce", tails[tail]))
                    stack.enter_context(cs.switched(
                        train_stage, "TrainConfig",
                        functools.partial(train_stage.TrainConfig, seed=seed)))
                    os.chdir(root)
                    stack.callback(os.chdir, cwd)
                    logging_setup.configure_logging(log_file=None)
                    rows = train_and_read(cs, P, root, ds, dev, model32)
                for row in rows:
                    line = json.dumps({"tool": "demo_drift", "seed": seed, "tail": tail,
                                       "s": time.perf_counter() - t0, **row, **card})
                    print(line, flush=True)
                    log.write(line + "\n")
                    log.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
