"""Pipeline orchestrator: sequences the eight stages.

Port of ``tpu_mslesseg/pipeline/ejecutar_pipeline.py``. Reference:
``ejecutar_pipeline.py`` — same CLI vocabulary
(``--plano --modalidad --num_cortes --mejora --epochs --k_folds
--fold_test/--paciente_id --umbral_consenso --completo --entrenar
--limpiar``), same modes (full experiment vs single patient), same
consensus gating (only when all three planes' volumes exist), same
incremental-resume behavior (every stage skips existing artifacts).

Everything that computes runs on the CUDA device; there is no fallback to
the CPU (``device="cpu"`` exists for callers that ask for it, as the tests
do). Stage 2 of a full experiment with no fold trained trains every fold at
once (``stages/train.ejecutar_train_paralelo``), as the reference does by
default; patient mode, ``--train_secuencial`` and a partly trained
experiment train fold by fold. Under ``torchrun --nproc_per_node N`` (or the
JAX package's ``TPU_MSLESSEG_*`` variables) each rank drives one card and
training spreads over them (``core/distributed.py``).

Run:  python -m tpu_mslesseg_torch.pipeline.ejecutar_pipeline --completo \
          --plano axial --modalidad FLAIR --num_cortes P50 --epochs 50
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

from tpu_mslesseg_torch.core import distributed
from tpu_mslesseg_torch.core.device import exigir
from tpu_mslesseg_torch.pipeline.logging_setup import configure_logging, get_logger
from tpu_mslesseg_torch.pipeline.modelo import Modelo
from tpu_mslesseg_torch.pipeline.paciente import Paciente, calcular_fold, listar_pacientes
from tpu_mslesseg_torch.pipeline.paths import existe_modelo_entrenado
from tpu_mslesseg_torch.pipeline.stages import (
    eval as eval_stage,
    extraer_dataset,
    generar_consenso,
    generar_predicciones,
    promediar_folds,
    reconstruir_volumen,
    setup as setup_stage,
    train as train_stage,
)
from tpu_mslesseg_torch.preproc.slices import int_o_percentil

logger = get_logger(__file__)

PLANOS_ANATOMICOS = ("axial", "coronal", "sagital")


def verificar_folds_consenso(modelo, epochs, folds, root=None) -> bool:
    """Consensus gate: every fold must have all three plane volumes on disk
    (reference ``ejecutar_pipeline.py:114-138``)."""
    root = Path(root) if root else Path.cwd()
    base = root / "pred_vols" / f"{modelo.base_path}_{epochs}epochs"
    for k in folds:
        fold_dir = base / f"fold{k}"
        if not fold_dir.is_dir():
            return False
        try:
            pacientes = listar_pacientes(fold_dir)
        except FileNotFoundError:
            return False
        for pid in pacientes:
            for plano in PLANOS_ANATOMICOS:
                if not (fold_dir / pid / f"{pid}_{plano}.nii.gz").exists():
                    return False
    return True


def folds_del_experimento(k_folds: int, paciente_id=None) -> list:
    """The folds one invocation touches: the patient's single fold in
    patient mode, all k in full mode. Shared by the orchestrator's
    stage loop."""
    return (
        [calcular_fold(paciente_id, k_folds)]
        if paciente_id
        else list(range(1, k_folds + 1))
    )


def folds_sin_entrenar(modelo, epochs: int, folds) -> list:
    """Folds without trained weights — the orchestrator's own stage-2
    training condition."""
    return [k for k in folds if not existe_modelo_entrenado(modelo, epochs, k)]


def ejecutar_pipeline(
    modelo: Modelo,
    epochs: int = 50,
    paciente: Paciente | None = None,
    entrenar: bool = False,
    limpiar: bool = False,
    umbral_consenso: int = 2,
    train_cfg=None,
    train_paralelo: bool = True,
    rapido: bool = False,
    device="cuda",
):
    """Full pipeline for one experiment config (or one patient).

    ``rapido``: serve stages 3-6 through the fused consensus path
    (pipeline/rapido.py) instead of the per-stage chain — same artifacts
    minus the prediction-PNG intermediates. Patient mode serves one
    patient; full mode serves each fold's patients 4 per dispatch and the
    chain stages reduce to skips + fold-level aggregation. Everything that
    computes runs on `device`."""
    from tpu_mslesseg_torch.core.profiling import stage_timer

    device = exigir(device)

    # Stage 0: dataset setup
    with stage_timer("setup"):
        setup_stage.ejecutar_setup_pipeline()

    # Stage 1: slice extraction
    with stage_timer("extraer_dataset"):
        extraer_dataset.ejecutar_dataset_pipeline(
            modelo, paciente=paciente, k_folds=modelo.k_folds, limpiar=limpiar,
            device=device,
        )

    folds = folds_del_experimento(
        modelo.k_folds, paciente.id if paciente is not None else None
    )

    # Stage 2: training (optional; skipped per fold when weights exist).
    # A full experiment with no fold trained trains all folds at once;
    # patient mode, --train_secuencial and a partly trained experiment train
    # fold by fold (the per-fold skip is finer-grained).
    untrained = folds_sin_entrenar(modelo, epochs, folds)
    if (
        entrenar and paciente is None and train_paralelo
        and len(folds) > 1 and len(untrained) == len(folds)
    ):
        with stage_timer("train_paralelo"):
            train_stage.ejecutar_train_paralelo(modelo, epochs, train_cfg=train_cfg,
                                                limpiar=limpiar, device=device)
    else:
        for k in folds:
            if existe_modelo_entrenado(modelo, epochs, k):
                logger.skip(f"⏩ Modelo del fold {k} ya entrenado.")
                continue
            if not entrenar:
                logger.warning(
                    f"⚠️ Fold {k} sin modelo entrenado y --entrenar no indicado."
                )
                continue
            with stage_timer(f"train_fold{k}"):
                train_stage.ejecutar_train_pipeline(
                    modelo, epochs=epochs, fold_test=k, limpiar=limpiar,
                    train_cfg=train_cfg, device=device,
                )

    # Patient fast path: stages 3-6 through the consensus predictor (volumes
    # + metrics straight off the device; falls back to the stage chain when
    # a precondition is missing)
    if rapido and paciente is not None:
        from tpu_mslesseg_torch.pipeline import rapido as rapido_mod

        with stage_timer("rapido"):
            ok = rapido_mod.ejecutar_paciente_rapido(
                modelo, paciente, epochs=epochs, k_folds=modelo.k_folds,
                umbral=umbral_consenso, limpiar=limpiar, device=device,
            )
        if ok:
            logger.header("\n🏁 Pipeline completado (vía rápida).")
            return

    # Full-experiment fast path: each fold's stages 3-6 per-patient work
    # as multi-patient dispatches (4 patients each). Folds it serves skip
    # the prediction stage below; the
    # remaining stages see their artifacts on disk and reduce to skips +
    # fold-level aggregation. Falls back to the chain per fold.
    folds_rapido = set()
    if rapido and paciente is None:
        from tpu_mslesseg_torch.pipeline import rapido as rapido_mod

        for k in folds:
            if not existe_modelo_entrenado(modelo, epochs, k):
                continue
            with stage_timer(f"rapido_fold{k}"):
                ok = rapido_mod.ejecutar_fold_rapido(
                    modelo, epochs=epochs, k_folds=modelo.k_folds,
                    fold_test=k, umbral=umbral_consenso, limpiar=limpiar,
                    device=device,
                )
            if ok:
                folds_rapido.add(k)

    # Stages 3-4: prediction + reconstruction
    for k in folds:
        if not existe_modelo_entrenado(modelo, epochs, k):
            logger.warning(f"⚠️ Sin modelo para el fold {k}; se omiten predicciones.")
            continue
        if k not in folds_rapido:
            with stage_timer(f"predicciones_fold{k}"):
                generar_predicciones.ejecutar_predicciones_pipeline(
                    modelo, epochs=epochs, k_folds=modelo.k_folds,
                    fold_test=None if paciente is not None else k,
                    paciente=paciente, limpiar=limpiar, device=device,
                )
        with stage_timer(f"reconstrucciones_fold{k}"):
            reconstruir_volumen.ejecutar_reconstrucciones_pipeline(
                modelo, epochs=epochs, k_folds=modelo.k_folds,
                fold_test=None if paciente is not None else k,
                paciente=paciente,
                limpiar=limpiar and k not in folds_rapido, device=device,
            )

    # Stage 6: per-plane evaluation
    for k in folds:
        with stage_timer(f"eval_fold{k}"):
            eval_stage.ejecutar_eval_pipeline(
                modelo, epochs=epochs, k_folds=modelo.k_folds,
                fold_test=None if paciente is not None else k,
                paciente=paciente,
                limpiar=limpiar and k not in folds_rapido, device=device,
            )

    # Stage 5+6: consensus + consensus eval (full-experiment only, gated on
    # all three planes being reconstructed)
    if paciente is None and verificar_folds_consenso(modelo, epochs, folds):
        for k in folds:
            with stage_timer(f"consenso_fold{k}"):
                generar_consenso.ejecutar_consenso_pipeline(
                    modelo, epochs=epochs, k_folds=modelo.k_folds, fold_test=k,
                    umbral=umbral_consenso,
                    limpiar=limpiar and k not in folds_rapido, device=device,
                )
            with stage_timer(f"eval_consenso_fold{k}"):
                eval_stage.ejecutar_eval_pipeline(
                    modelo, epochs=epochs, k_folds=modelo.k_folds, fold_test=k,
                    plano_forzado="consenso",
                    limpiar=limpiar and k not in folds_rapido, device=device,
                )
    elif paciente is None:
        logger.info(
            "ℹ️ Consenso omitido: faltan volúmenes de alguno de los tres planos."
        )

    # Stage 7: cross-fold aggregation (full-experiment only)
    if paciente is None:
        with stage_timer("promediar_folds"):
            promediar_folds.ejecutar_promediar_folds_pipeline(
                modelo, epochs=epochs, k_folds=modelo.k_folds
            )
            if verificar_folds_consenso(modelo, epochs, folds):
                promediar_folds.ejecutar_promediar_folds_pipeline(
                    modelo, epochs=epochs, k_folds=modelo.k_folds,
                    plano_forzado="consenso",
                )

    logger.header("\n🏁 Pipeline completado.")


def parsear_args(argv=None):
    parser = argparse.ArgumentParser(
        description="Pipeline completo YOLO-MSLesSeg (PyTorch/CUDA)."
    )
    parser.add_argument("--plano", required=True, choices=list(PLANOS_ANATOMICOS))
    parser.add_argument(
        "--modalidad", nargs="+", choices=["T1", "T2", "FLAIR"],
        default=["T1", "T2", "FLAIR"],
    )
    parser.add_argument("--num_cortes", type=int_o_percentil, required=True)
    parser.add_argument("--mejora", default=None, choices=["HE", "CLAHE", "GC", "LT"])
    parser.add_argument("--epochs", type=int, default=50)
    parser.add_argument("--k_folds", type=int, default=5)
    parser.add_argument("--umbral_consenso", type=int, default=2, choices=[2, 3])
    group = parser.add_mutually_exclusive_group(required=True)
    group.add_argument("--completo", action="store_true")
    group.add_argument("--paciente_id", type=str)
    parser.add_argument("--entrenar", action="store_true")
    parser.add_argument(
        "--train_secuencial", action="store_true",
        help="Entrenar los folds uno a uno (por defecto, en modo completo sin ningún "
             "fold entrenado: todos a la vez).",
    )
    parser.add_argument("--limpiar", action="store_true")
    parser.add_argument(
        "--rapido", action="store_true",
        help="Servir predicción+reconstrucción+consenso+evaluación por la "
             "vía fusionada en la GPU (modo paciente: un paciente; modo "
             "completo: 4 pacientes por despacho); mismos "
             "artefactos sin los PNG intermedios. Por defecto en modo "
             "--completo; en modo paciente es opcional porque los extras "
             "de visualización leen los PNG de predicción.",
    )
    parser.add_argument(
        "--sin_rapido", action="store_true",
        help="Forzar la cadena de etapas clásica (escribe los PNG de "
             "predicción intermedios).",
    )
    return parser.parse_args(argv if argv is not None else sys.argv[1:])


def resolver_rapido(args) -> bool:
    """The ``--rapido`` default:
    ON for ``--completo`` (the orchestrator never consumes the
    prediction-PNG intermediates there, and every fold falls back to the
    stage chain automatically on a missing precondition), OFF for
    patient mode unless explicitly requested (the GIF/best-slice viz
    extras read ``pred_masks/*.png``, which the fused path does not
    write — a patient needing them later can regenerate by running the
    prediction stage standalone). ``--sin_rapido`` forces the chain."""
    if args.sin_rapido:
        return False
    return args.rapido or args.completo


def main(argv=None):
    args = parsear_args(argv)
    modelo = Modelo(
        plano=args.plano, num_cortes=args.num_cortes, modalidad=args.modalidad,
        k_folds=args.k_folds, mejora=args.mejora,
    )
    distributed.maybe_initialize()
    configure_logging(log_file="pipeline.log")
    paciente = None
    if args.paciente_id:
        paciente = Paciente(
            id=args.paciente_id, plano=modelo.plano, modalidad=modelo.modalidad,
            mejora=modelo.mejora, dataset_dir="MSLesSeg-Dataset/train",
        )
    try:
        ejecutar_pipeline(
            modelo=modelo, epochs=args.epochs, paciente=paciente,
            entrenar=args.entrenar, limpiar=args.limpiar,
            umbral_consenso=args.umbral_consenso,
            train_paralelo=not args.train_secuencial,
            rapido=resolver_rapido(args),
        )
    except Exception as e:
        logger.error(f"❌ Error en el pipeline: {e}")
        raise SystemExit(1)


if __name__ == "__main__":
    main()
