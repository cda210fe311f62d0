"""Stage 5 — consensus voting: three plane volumes -> majority-vote volume.

Port of ``tpu_mslesseg/pipeline/stages/generar_consenso.py``. Reference:
``scripts/generar_consenso.py``. The vote
``(axial+coronal+sagital) >= umbral`` runs as one device op; output is
uint8 with the axial volume's affine, shape-validated against GT.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from tpu_mslesseg_torch.core.device import es_fallo_de_dispositivo, exigir
from tpu_mslesseg_torch.infer.reconstruct import consensus_vote
from tpu_mslesseg_torch.io import nifti
from tpu_mslesseg_torch.pipeline.logging_setup import evaluate_results, get_logger, log_fold_status
from tpu_mslesseg_torch.pipeline.modelo import Modelo
from tpu_mslesseg_torch.pipeline.paciente import Paciente, listar_pacientes
from tpu_mslesseg_torch.pipeline.paths import ConfigConsenso
from tpu_mslesseg_torch.preproc.slices import int_o_percentil

logger = get_logger(__file__)


def procesar_paciente_consenso(paciente_id, config: ConfigConsenso, device="cuda"):
    out_path = config.consenso_path(paciente_id)
    if out_path.exists():
        return None  # skip

    vols = config.vol_paths(paciente_id)
    missing = [p for p, path in vols.items() if not path.exists()]
    if missing:
        logger.warning(f"⚠️ Faltan volúmenes {missing} para {paciente_id}.")
        return False

    axial = nifti.load(vols["axial"])
    # the vote only asks `> 0`: the volumes cross in their stored dtype
    planos = [
        torch.from_numpy(np.ascontiguousarray(v.data)).to(device)
        for v in (axial, nifti.load(vols["coronal"]), nifti.load(vols["sagital"]))
    ]
    cons = consensus_vote(*planos, config.umbral).cpu().numpy().astype(np.uint8)

    gt_shape, _ = nifti.load_header(config.gt_path(paciente_id))
    if cons.shape != gt_shape:
        raise ValueError(f"Consenso inválido: {cons.shape} vs {gt_shape}.")
    nifti.save(cons, axial.affine, out_path)
    return True


def ejecutar_flujo_consenso(config: ConfigConsenso, limpiar=False, verbose=False,
                            device="cuda"):
    if verbose:
        target = (
            f"paciente {config.paciente}"
            if config.paciente is not None
            else f"fold {config.fold_test}"
        )
        logger.header(
            f"\n🗳️ Generando consenso (umbral={config.umbral}) para el {target}."
        )

    device = exigir(device)
    if limpiar:
        if verbose:
            logger.info("♻️ Limpiando consensos previos.")
        config.limpiar_consenso()

    config.verificar_paths()

    if config.paciente is not None:
        res = procesar_paciente_consenso(config.paciente.id, config, device=device)
        if res is None:
            logger.skip("⏩ Consenso ya existente.")
        elif res:
            logger.info("✅ Consenso generado.")
        return res

    resultados = []
    for pid in listar_pacientes(config.pred_vols_fold_dir):
        try:
            resultados.append(procesar_paciente_consenso(pid, config, device=device))
        except Exception as e:
            if es_fallo_de_dispositivo(e):
                raise
            logger.warning(f"⚠️ Error en consenso de {pid}, se omite: {e}.")
    estado = evaluate_results(resultados)
    log_fold_status(logger, estado, config.fold_test)
    return estado


def parsear_args(argv=None):
    parser = argparse.ArgumentParser(description="Generar consenso multi-plano.")
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
    group.add_argument("--fold_test", type=int)
    group.add_argument("--paciente_id", type=str)
    parser.add_argument("--limpiar", action="store_true")
    return parser.parse_args(argv if argv is not None else sys.argv[1:])


def main(argv=None):
    args = parsear_args(argv)
    modelo = Modelo(
        plano="consenso", num_cortes=args.num_cortes, modalidad=args.modalidad,
        k_folds=args.k_folds, mejora=args.mejora,
    )
    paciente = None
    if args.paciente_id:
        paciente = Paciente(
            id=args.paciente_id, plano="consenso", modalidad=modelo.modalidad,
            dataset_dir="MSLesSeg-Dataset/train",
        )
    config = ConfigConsenso(
        modelo=modelo, epochs=args.epochs, k_folds=args.k_folds,
        fold_test=args.fold_test, paciente=paciente, umbral=args.umbral_consenso,
    )
    ejecutar_flujo_consenso(config, limpiar=args.limpiar, verbose=True)


def ejecutar_consenso_pipeline(
    modelo, epochs=50, k_folds=5, fold_test=None, paciente=None,
    umbral=2, limpiar=False, device="cuda",
):
    config = ConfigConsenso(
        modelo=modelo, epochs=epochs, k_folds=k_folds, fold_test=fold_test,
        paciente=paciente, umbral=umbral,
    )
    return ejecutar_flujo_consenso(config, limpiar=limpiar, device=device)


if __name__ == "__main__":
    main()
