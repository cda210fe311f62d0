"""Modo capacidad: entrena sobre TODOS los pacientes de la demo y evalúa
sobre la distribución de entrenamiento (no es validación cruzada).

Port of ``tpu_mslesseg/demo/entrenar_capacidad.py``. Existe porque la demo
solo trae 2 pacientes: la validación cruzada real con n=1 por fold no puede
generalizar, mientras que este modo demuestra el stack completo
(entrenamiento → predicción fusionada → reconstrucción → métricas).

The reference's flags and defaults. Where the reference runs each epoch as
one compiled scan program, the port runs the same epochs through the
training engine's micro-step loop (``train/engine.run_epoch``: the epoch's
indices, the augmentation draws, ``train_step`` with its optimizer cadence
and EMA), the mosaic on until ``epochs - close_mosaic``. The step time is
taken over the warm epochs (every epoch after the first, which meets cuDNN's
algorithm choices and the allocator's growth), each ended by
``torch.cuda.synchronize()`` on the card. The EMA weights are saved as
``trains_capacidad/<mejora>/weights/best.pt``, the port's checkpoint format
(a state_dict), where the reference writes a JAX ``best.ckpt``. Then
`evaluar_capacidad` serves them (``SlicePredictor``, ``reconstruct_volume``,
``compute_metrics``), as the reference's lines :110-127 do.

It runs on the CUDA card; without one it fails before any work, and never
trains on the CPU unless a caller of `ejecutar_capacidad` names it.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import torch

from tpu_mslesseg_torch.core.device import exigir, kernels_de
from tpu_mslesseg_torch.evalx import metrics as mx
from tpu_mslesseg_torch.infer.predictor import SlicePredictor
from tpu_mslesseg_torch.infer.reconstruct import reconstruct_volume
from tpu_mslesseg_torch.model import stem
from tpu_mslesseg_torch.model.yolo11 import create_model
from tpu_mslesseg_torch.pipeline.logging_setup import get_logger
from tpu_mslesseg_torch.pipeline.paciente import Paciente, listar_pacientes
from tpu_mslesseg_torch.preproc import enhance
from tpu_mslesseg_torch.train import augment, checkpoint, engine, trainer
from tpu_mslesseg_torch.train import data as tdata

logger = get_logger(__file__)


def evaluar_capacidad(model, variables, paciente_eval: str, mejora, dataset,
                      imgsz: int = 640, device="cuda"):
    """The reference's evaluation tail: `paciente_eval`'s axial FLAIR lesion
    slices (at most 50) enhanced, served by `model` with `variables` (a
    state_dict), rebuilt into a volume and scored against its mask. Returns
    (volume on `device`, metrics dict)."""
    dev = torch.device(device)
    p = Paciente(id=paciente_eval, plano="axial", modalidad=["FLAIR"], dataset_dir=dataset)
    idx = p.indices_a_usar(50)
    raw = torch.from_numpy(p.cortes_imagen_batch(idx, "FLAIR")).to(dev)
    imgs = enhance.enhance_for_model(raw, mejora)
    pred = SlicePredictor(model, variables, slice_hw=tuple(imgs.shape[1:]), imgsz=imgsz,
                          device=dev)
    masks = pred(imgs)
    vol = reconstruct_volume(p.gt_mask.shape, masks, "axial", idx)
    return vol, mx.compute_metrics(torch.as_tensor(p.gt_mask, device=dev), vol)


def ejecutar_capacidad(dataset, mejora="GC", epochs: int = 100, batch: int = 8,
                       amp: bool = True, paciente_eval: str = "P39", imgsz: int = 640,
                       device="cuda") -> dict:
    """Train YOLO11n-seg on every patient of `dataset` (axial, FLAIR, 50
    slices a patient) on `device`, save the EMA weights under the working
    directory's ``trains_capacidad/<mejora>/weights/best.pt`` and evaluate
    `paciente_eval`. Returns {"metricas", "perdidas" (each epoch's mean loss
    parts), "paso_ms" (a warm micro-step, None with one epoch), "batch",
    "pesos"}."""
    # the kernels of the training and of the evaluation, built before either
    dev = exigir(device, kernels_de(mejora, stem=stem.ENABLED, union=True))

    pacientes = listar_pacientes(dataset)
    logger.header(f"\n💪 Modo capacidad: entrenando con {pacientes}.")

    cfg = trainer.TrainConfig(
        epochs=epochs, batch_size=batch, close_mosaic=10, max_fg=48, amp=amp, imgsz=imgsz,
    )
    train_set = tdata.build_dataset(
        pacientes, "axial", ["FLAIR"], mejora, 50, dataset, train_size=cfg.imgsz, device=dev
    )
    dtype = torch.bfloat16 if cfg.amp else torch.float32
    logger.info(f"🎛️ Precisión de cómputo: {'bf16 (AMP)' if cfg.amp else 'f32'}.")
    model, _ = create_model(nc=1, scale="n", dtype=dtype)
    steps = max(len(train_set) // cfg.batch_size, 1)
    state = trainer.init_train_state(model, cfg, steps, device=dev)
    acfg = {m: augment.AugConfig(imgsz=cfg.imgsz, max_inst=train_set.max_inst, mosaic=m)
            for m in (True, False)}
    dd = train_set.as_dict()

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    history, n_steps, t_steps = [], 0, 0.0
    for epoch in range(1, cfg.epochs + 1):
        mosaic = epoch <= cfg.epochs - cfg.close_mosaic
        sync()
        t0 = time.perf_counter()
        history.append(engine.run_epoch(state, dd, len(train_set), acfg[mosaic]))
        sync()
        if epoch > 1:
            t_steps += time.perf_counter() - t0
            n_steps += steps
        if epoch % 20 == 0 or epoch == cfg.epochs:
            line = {k: history[-1][k] for k in ("box", "seg", "cls", "dfl")}
            logger.info(f"🏋️ Epoch {epoch}/{cfg.epochs}: {line}")
    step_ms = 1000 * t_steps / n_steps if n_steps else None
    if step_ms is not None:
        logger.info(
            f"⏱️ Paso de entrenamiento: {step_ms:.1f} ms "
            f"(batch {cfg.batch_size}, {'bf16' if cfg.amp else 'f32'})."
        )

    out = Path("trains_capacidad") / mejora / "weights"
    served = state.served_state_dict()
    checkpoint.save_checkpoint(out / "best.pt", served)
    logger.info(f"💾 Pesos guardados en {out}.")

    serve_model, _ = create_model(nc=1, scale="n", dtype=dtype)
    _, met = evaluar_capacidad(serve_model, served, paciente_eval, mejora, dataset,
                            imgsz=cfg.imgsz, device=dev)
    logger.info(f"📏 {paciente_eval} (distribución de entrenamiento): {met}")
    return {"metricas": met, "perdidas": history, "paso_ms": step_ms,
            "batch": cfg.batch_size, "pesos": str(out / "best.pt")}


def main(argv=None):
    parser = argparse.ArgumentParser(description="Demo modo capacidad.")
    parser.add_argument("--epochs", type=int, default=100)
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--paciente_eval", default="P39")
    parser.add_argument("--mejora", default="GC")
    parser.add_argument("--dataset", default="MSLesSeg-Dataset/train")
    parser.add_argument(
        "--no_amp", action="store_true",
        help="f32 puro (por defecto bf16 mixto, como el entrenamiento real).",
    )
    args = parser.parse_args(argv if argv is not None else sys.argv[1:])
    res = ejecutar_capacidad(
        args.dataset, mejora=args.mejora, epochs=args.epochs, batch=args.batch,
        amp=not args.no_amp, paciente_eval=args.paciente_eval,
    )
    return res["metricas"]


if __name__ == "__main__":
    main()
