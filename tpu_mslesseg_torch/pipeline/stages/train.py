"""Stage 2 — training: fine-tune YOLO11-seg on each fold.

Port of ``tpu_mslesseg/pipeline/stages/train.py``. Reference:
``scripts/train.py``. The same CLI and artifacts (``weights/best.pt`` and
``last.pt``, ``results.csv``, ``args.yaml``, the dataset YAML, a skip when
the fold is trained); the fold's subsets are built on the device instead of
copied to disk, and the loop is ``train/engine.py``; ``--paralelo`` trains
every fold at once (``train/engine_parallel.py``). Everything runs on the
CUDA card; ``device="cpu"`` is for callers that ask for it, as the tests
do. Under ``torchrun`` (or the JAX package's ``TPU_MSLESSEG_*`` variables)
each rank drives one card: one fold's batch is split over all ranks, and
``--paralelo`` lays the ranks out as a (fold, data) grid
(``core/mesh.py``).

Run:  python -m tpu_mslesseg_torch.pipeline.stages.train --plano axial \
          --modalidad FLAIR --num_cortes P50 --fold_test 1 --epochs 50
      python -m tpu_mslesseg_torch.pipeline.stages.train --plano axial \
          --modalidad FLAIR --num_cortes P50 --paralelo --epochs 50
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import torch

from tpu_mslesseg_torch.core import distributed, mesh
from tpu_mslesseg_torch.core.device import exigir
from tpu_mslesseg_torch.model.yolo11 import create_model
from tpu_mslesseg_torch.pipeline import yaml_out
from tpu_mslesseg_torch.pipeline.logging_setup import get_logger
from tpu_mslesseg_torch.pipeline.modelo import Modelo
from tpu_mslesseg_torch.pipeline.paciente import listar_pacientes
from tpu_mslesseg_torch.pipeline.paths import (
    ConfigTrain,
    eliminar_directorio,
    existe_modelo_entrenado,
)
from tpu_mslesseg_torch.preproc.slices import int_o_percentil, resolver_num_cortes
from tpu_mslesseg_torch.train import data as tdata
from tpu_mslesseg_torch.train import engine, engine_parallel, fold_parallel
from tpu_mslesseg_torch.train.trainer import TrainConfig

logger = get_logger(__file__)


def _compute_dtype(cfg: TrainConfig):
    """bf16 compute under ``amp`` (the reference's), float32 otherwise."""
    return torch.bfloat16 if cfg.amp else torch.float32


def _escribir_dataset_yaml(fold_dir, modelo, dataset_dir, patients, fold, k_folds):
    """The fold's dataset YAML, ``<model_string>.yaml`` in the fold dir (the
    reference archives its generated data YAML there): its keys
    (path/train/val/names/nc), with the fold split as train and val. Rank 0
    writes it."""
    if not distributed.is_main_process():
        return
    train_ids, test_ids = tdata.fold_patient_split(patients, fold, k_folds)
    yaml_out.write(Path(fold_dir) / f"{modelo.model_string}.yaml", {
        "path": str(Path(dataset_dir).resolve()),
        "train": sorted(train_ids),
        "val": sorted(test_ids),
        "names": ["lesion"],
        "nc": 1,
    })


def ejecutar_flujo_train(config: ConfigTrain, limpiar=False, verbose=False,
                         train_cfg: TrainConfig = None, scale: str = "n", device="cuda"):
    if verbose:
        logger.header(f"\n🏋️ Entrenando fold {config.fold_test} "
                      f"({config.modelo.model_string}, {config.epochs} epochs).")
    if limpiar:
        if verbose:
            logger.info("♻️ Limpiando entrenamiento previo.")
        config.limpiar_entrenamiento()

    if existe_modelo_entrenado(config.modelo, config.epochs, config.fold_test,
                               root=config.root) and engine.entrenamiento_exitoso(config.fold_dir):
        logger.skip(f"⏩ Modelo del fold {config.fold_test} ya entrenado.")
        return None

    dev = exigir(device)
    config.verificar_paths()
    # several ranks split the fold's batch (the reference's data mesh over
    # every device); one process uses one card
    axis = None
    if distributed.process_count() > 1:
        axis = mesh.make_grid(fold_parallel=1).data_axis(global_batch=True)
        logger.info(f"🕸️ Data-parallel: {distributed.process_count()} rangos.")
    distributed.advertir_una_gpu(dev)
    num_cortes, _ = resolver_num_cortes(
        num_cortes=config.modelo.num_cortes, input_dir=config.dataset_entrada,
        plano=config.modelo.plano, modalidad=config.modelo.modalidad,
    )
    # the stage's default batch is -1, as the reference's
    cfg = train_cfg or TrainConfig(epochs=config.epochs, batch_size=-1,
                                   pretrained=resolver_pretrained())
    model, _ = create_model(nc=1, scale=scale, dtype=_compute_dtype(cfg))
    patients = listar_pacientes(config.dataset_entrada)
    _escribir_dataset_yaml(config.fold_dir, config.modelo, config.dataset_entrada, patients,
                           config.fold_test, config.modelo.k_folds)
    summary = engine.train_fold(
        model=model, fold_test=config.fold_test, patients=patients,
        plano=config.modelo.plano, modalidades=config.modelo.modalidad,
        mejora=config.modelo.mejora, num_cortes=num_cortes,
        dataset_dir=config.dataset_entrada, output_dir=config.fold_dir, cfg=cfg,
        k_folds=config.modelo.k_folds, device=dev, axis=axis,
    )
    logger.info(f"✅ Entrenamiento del fold {config.fold_test} completado: {summary}")
    return True


def parsear_args(argv=None):
    parser = argparse.ArgumentParser(description="Entrenar YOLO11-seg por fold.")
    parser.add_argument("--plano", required=True, choices=["axial", "coronal", "sagital"])
    parser.add_argument(
        "--modalidad", nargs="+", choices=["T1", "T2", "FLAIR"],
        default=["T1", "T2", "FLAIR"],
    )
    parser.add_argument("--num_cortes", type=int_o_percentil, required=True)
    parser.add_argument("--mejora", default=None, choices=["HE", "CLAHE", "GC", "LT"])
    parser.add_argument("--epochs", type=int, default=50)
    parser.add_argument("--k_folds", type=int, default=5)
    group = parser.add_mutually_exclusive_group(required=True)
    group.add_argument("--fold_test", type=int)
    group.add_argument(
        "--paralelo", action="store_true",
        help="Entrenar todos los folds a la vez (train/engine_parallel.py; con varios "
             "rangos, una rejilla (fold, data)).",
    )
    parser.add_argument(
        "--batch", type=int, default=-1,
        help="Tamaño de batch; -1 (por defecto, como la referencia) = el mayor que cabe "
             "en la memoria de la GPU (sondeo de un paso real, train/autobatch.py).",
    )
    parser.add_argument(
        "--imgsz", type=int, default=640,
        help="Lado de la entrada de red (divisible por 32).",
    )
    parser.add_argument("--scale", default="n", choices=["n", "s", "m", "l", "x"])
    parser.add_argument(
        "--no_amp", action="store_true",
        help="Entrenar en f32 puro (por defecto: bf16 mixto, como el AMP del flujo de "
             "referencia).",
    )
    parser.add_argument(
        "--pretrained", default="auto",
        help="Pesos base para warm-start (referencia ConfigTrain.py:139: yolo11n-seg.pt en "
             "el cwd, args.yaml pretrained: true). 'auto' usa ./yolo11n-seg.pt si existe; "
             "'no' entrena desde cero; cualquier otra cosa es una ruta a un .pt de "
             "ultralytics (model/import_pt.py).",
    )
    parser.add_argument("--limpiar", action="store_true")
    return parser.parse_args(argv if argv is not None else sys.argv[1:])


def resolver_pretrained(pretrained: str = "auto") -> str:
    """The warm-start weights' path: the reference's base weights live at
    ``yolo11n-seg.pt`` in the working directory."""
    if pretrained == "no":
        return ""
    if pretrained == "auto":
        p = Path("yolo11n-seg.pt")
        if p.is_file():
            logger.info(f"🧬 Pesos base detectados: {p}.")
            return str(p)
        return ""
    if not Path(pretrained).is_file():
        raise FileNotFoundError(f"Pesos base no encontrados: {pretrained}")
    return pretrained


def ejecutar_train_paralelo(modelo, epochs, train_cfg=None, scale="n", limpiar=False,
                            device="cuda"):
    """Every fold at once on `device`: skipped when every fold is trained,
    redone from scratch with `limpiar`. Over several ranks the folds lay out
    on a (fold, data) grid (``fold_parallel.plan_fold_mesh``)."""
    config = ConfigTrain(modelo=modelo, epochs=epochs, fold_test=1)
    config.verificar_paths()
    fold_dirs = [config.output_dir / f"fold{k}" for k in range(1, modelo.k_folds + 1)]
    if limpiar:
        # the stacked resume point goes too: a cleaned run starts at epoch 1
        if distributed.is_main_process():
            for d in fold_dirs + [config.output_dir / engine_parallel.STACKED.parent]:
                eliminar_directorio(d)
        distributed.barrier()
    elif all(engine.entrenamiento_exitoso(d) for d in fold_dirs):
        logger.skip("⏩ Todos los folds ya entrenados.")
        return None

    dev = exigir(device)
    world = distributed.process_count()
    fold_par, k_pad = fold_parallel.plan_fold_mesh(world, modelo.k_folds)
    grid = mesh.make_grid(fold_parallel=fold_par) if world > 1 else None
    logger.info(
        f"🕸️ Rejilla fold-parallel: fold={fold_par} x data={world // fold_par} "
        f"({modelo.k_folds} folds -> {k_pad} con relleno)."
        if grid is not None else "🕸️ Un dispositivo: los folds se turnan en cada paso.")
    distributed.advertir_una_gpu(dev)
    num_cortes, _ = resolver_num_cortes(
        num_cortes=modelo.num_cortes, input_dir=config.dataset_entrada,
        plano=modelo.plano, modalidad=modelo.modalidad,
    )
    cfg = train_cfg or TrainConfig(epochs=epochs, batch_size=-1,
                                   pretrained=resolver_pretrained())
    model, _ = create_model(nc=1, scale=scale, dtype=_compute_dtype(cfg))
    pacientes = listar_pacientes(config.dataset_entrada)
    for k in range(1, modelo.k_folds + 1):
        _escribir_dataset_yaml(config.output_dir / f"fold{k}", modelo, config.dataset_entrada,
                               pacientes, k, modelo.k_folds)
    return engine_parallel.train_folds_parallel(
        model=model, patients=pacientes, plano=modelo.plano, modalidades=modelo.modalidad,
        mejora=modelo.mejora, num_cortes=num_cortes, dataset_dir=config.dataset_entrada,
        output_root=config.output_dir, cfg=cfg, k_folds=modelo.k_folds, grid=grid,
        device=dev,
    )


def main(argv=None):
    args = parsear_args(argv)
    distributed.maybe_initialize()
    modelo = Modelo(
        plano=args.plano, num_cortes=args.num_cortes, modalidad=args.modalidad,
        k_folds=args.k_folds, mejora=args.mejora,
    )
    cfg = TrainConfig(epochs=args.epochs, batch_size=args.batch, amp=not args.no_amp,
                      imgsz=args.imgsz, pretrained=resolver_pretrained(args.pretrained))
    if args.paralelo:
        ejecutar_train_paralelo(modelo, args.epochs, train_cfg=cfg, scale=args.scale,
                                limpiar=args.limpiar)
        return
    config = ConfigTrain(modelo=modelo, epochs=args.epochs, fold_test=args.fold_test)
    ejecutar_flujo_train(config, limpiar=args.limpiar, verbose=True, train_cfg=cfg,
                         scale=args.scale)


def ejecutar_train_pipeline(modelo, epochs=50, fold_test=1, limpiar=False, train_cfg=None,
                            scale="n", device="cuda"):
    config = ConfigTrain(modelo=modelo, epochs=epochs, fold_test=fold_test)
    return ejecutar_flujo_train(config, limpiar=limpiar, train_cfg=train_cfg, scale=scale,
                                device=device)


if __name__ == "__main__":
    main()
