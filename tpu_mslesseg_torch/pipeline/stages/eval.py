"""Stage 6 — evaluation: volume metrics per patient + fold aggregates.

Port of ``tpu_mslesseg/pipeline/stages/eval.py``. Reference:
``scripts/eval.py``. Same JSON schemas:
* patient: ``{"DSC": x, "AUC": x, "Precision": x, "Recall": x}``
* fold:    ``{metric: {"media": m, "std": s}}`` (population std, 3dp)
The confusion counts are summed on the device (evalx/metrics.py).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

from tpu_mslesseg_torch.core.device import exigir
from tpu_mslesseg_torch.evalx import metrics as mx
from tpu_mslesseg_torch.io import nifti
from tpu_mslesseg_torch.pipeline.logging_setup import get_logger
from tpu_mslesseg_torch.pipeline.modelo import Modelo
from tpu_mslesseg_torch.pipeline.paciente import Paciente, listar_pacientes
from tpu_mslesseg_torch.pipeline.paths import ConfigEval
from tpu_mslesseg_torch.preproc.slices import int_o_percentil

logger = get_logger(__file__)


def escribir_json(dic, path):
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        json.dump(dic, f)


def leer_json(path):
    with open(path) as f:
        return json.load(f)


def calcular_metricas(gt_vol_path, pred_vol_path, device="cuda") -> dict:
    pred = nifti.load(pred_vol_path)
    gt = nifti.load(gt_vol_path)
    if pred.shape != gt.shape:
        logger.warning(
            f"⚠️ Reconstrucción inválida: {Path(pred_vol_path).name} "
            f"{pred.shape} vs {gt.shape}"
        )
        return {}
    # the counts only ask `> 0`: the volumes cross in their stored dtype.
    # NaN AUC -> serialized as NaN like the reference's json.dump(np.nan)
    return mx.compute_metrics(
        torch.from_numpy(np.ascontiguousarray(gt.data)).to(device),
        torch.from_numpy(np.ascontiguousarray(pred.data)).to(device),
    )


def procesar_paciente_eval(config: ConfigEval, paths_dir=None, modo_fold=False,
                           device="cuda"):
    if paths_dir is None:
        paths_dir = config.paths_paciente(config.paciente.id)
    rj = paths_dir["results_json"]
    if rj.exists():
        return leer_json(rj) if modo_fold else None
    if not Path(paths_dir["pred_vol"]).exists():
        logger.warning(f"⚠️ Sin volumen predicho: {paths_dir['pred_vol']}.")
        return {}
    met = calcular_metricas(paths_dir["gt_vol"], paths_dir["pred_vol"], device=device)
    if met:  # never memoize a failed computation: fixing the volume must
        escribir_json(met, rj)  # allow re-evaluation without --limpiar
    return met


def calcular_promedio(metricas_dic: dict) -> dict:
    if not metricas_dic:
        raise ValueError("El diccionario de métricas está vacío.")
    return {
        metric: {
            "media": float(np.round(np.nanmean(vals), 3)),
            "std": float(np.round(np.nanstd(vals), 3)),
        }
        for metric, vals in metricas_dic.items()
    }


def calcular_metricas_fold(config: ConfigEval, device="cuda"):
    out_path = config.results_fold_json
    if out_path.exists():
        return None  # skip

    try:
        pacientes = (
            listar_pacientes(config.pred_vols_fold_dir)
            if config.pred_vols_fold_dir.is_dir()
            else []
        )
    except FileNotFoundError:
        pacientes = []
    acumulado = {}
    for pid in pacientes:
        paths = config.paths_paciente(pid)
        if not paths["pred_vol"].exists():
            logger.warning(f"⚠️ Sin volumen predicho para {pid}.")
            continue
        met = procesar_paciente_eval(config, paths, modo_fold=True, device=device)
        if not met:
            logger.warning(f"⚠️ No se encontraron métricas del paciente {pid}.")
            continue
        for k, v in met.items():
            acumulado.setdefault(k, []).append(v)

    if not acumulado:
        # a fold without predictions must warn and continue, not abort the
        # experiment (the reference's warn-and-skip contract)
        logger.warning(
            f"⚠️ Fold {config.fold_test} sin volúmenes evaluables; se omite."
        )
        return False
    stats = calcular_promedio(acumulado)
    escribir_json(stats, out_path)
    return stats


def ejecutar_flujo_eval(config: ConfigEval, limpiar=False, verbose=False,
                        device="cuda"):
    if verbose:
        target = (
            f"paciente {config.paciente}"
            if config.paciente is not None
            else f"fold {config.fold_test}"
        )
        logger.header(f"\n📏 Evaluando ({config.plano}) el {target}.")

    device = exigir(device)
    if limpiar:
        if verbose:
            logger.info("♻️ Limpiando resultados previos.")
        config.limpiar_resultados()

    config.verificar_paths()

    if config.paciente is not None:
        res = procesar_paciente_eval(config, device=device)
        if res is None:
            logger.skip("⏩ Métricas ya calculadas.")
        else:
            logger.info(f"✅ Métricas: {res}")
        return res

    res = calcular_metricas_fold(config, device=device)
    if res is None:
        logger.skip(f"⏩ Fold {config.fold_test} ya evaluado.")
    elif res:
        logger.info(f"🆗 Fold {config.fold_test} evaluado.")
    return res


def parsear_args(argv=None):
    parser = argparse.ArgumentParser(description="Evaluar volúmenes predichos.")
    parser.add_argument(
        "--plano", required=True, choices=["axial", "coronal", "sagital", "consenso"]
    )
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
    group.add_argument("--paciente_id", type=str)
    parser.add_argument("--limpiar", action="store_true")
    return parser.parse_args(argv if argv is not None else sys.argv[1:])


def main(argv=None):
    args = parsear_args(argv)
    modelo = Modelo(
        plano=args.plano, num_cortes=args.num_cortes, modalidad=args.modalidad,
        k_folds=args.k_folds, mejora=args.mejora,
    )
    paciente = None
    if args.paciente_id:
        paciente = Paciente(
            id=args.paciente_id, plano=modelo.plano, modalidad=modelo.modalidad,
            dataset_dir="MSLesSeg-Dataset/train",
        )
    config = ConfigEval(
        modelo=modelo, epochs=args.epochs, k_folds=args.k_folds,
        fold_test=args.fold_test, paciente=paciente,
    )
    ejecutar_flujo_eval(config, limpiar=args.limpiar, verbose=True)


def ejecutar_eval_pipeline(
    modelo, epochs=50, k_folds=5, fold_test=None, paciente=None,
    plano_forzado=None, limpiar=False, device="cuda",
):
    config = ConfigEval(
        modelo=modelo, epochs=epochs, k_folds=k_folds, fold_test=fold_test,
        paciente=paciente, plano_forzado=plano_forzado,
    )
    return ejecutar_flujo_eval(config, limpiar=limpiar, device=device)


if __name__ == "__main__":
    main()
