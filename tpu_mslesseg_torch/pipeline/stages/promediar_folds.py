"""Stage 7 — cross-fold aggregation: fold JSONs -> global experiment JSON.

Port of ``tpu_mslesseg/pipeline/stages/promediar_folds.py`` (host only).

Reference: ``scripts/promediar_folds.py``. Averages each fold's per-metric
mean; std across folds uses the *sample* std (ddof=1,
``promediar_folds.py:132``). Accepts both fold-format entries
(``{"media": m, "std": s}``) and patient-format scalars.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from tpu_mslesseg_torch.pipeline.logging_setup import get_logger
from tpu_mslesseg_torch.pipeline.modelo import Modelo
from tpu_mslesseg_torch.pipeline.paths import ConfigEval
from tpu_mslesseg_torch.pipeline.stages.eval import escribir_json, leer_json
from tpu_mslesseg_torch.preproc.slices import int_o_percentil

logger = get_logger(__file__)


def agregar_metricas_fold(acumulado: dict, metricas_fold: dict):
    for metrica, valor in metricas_fold.items():
        if isinstance(valor, dict) and "media" in valor:
            acumulado.setdefault(metrica, []).append(valor["media"])
        else:
            acumulado.setdefault(metrica, []).append(valor)


def leer_metricas_folds(config: ConfigEval) -> dict:
    acumulado = {}
    for path in config.fold_jsons():
        if not path.exists():
            raise FileNotFoundError(f"Falta el JSON del fold: {path}")
        agregar_metricas_fold(acumulado, leer_json(path))
    return acumulado


def calcular_resumen_experimento(acumulado: dict) -> dict:
    return {
        metrica: {
            "media": float(np.round(np.nanmean(vals), 3)),
            "std": float(np.round(np.nanstd(vals, ddof=1), 3)) if len(vals) > 1 else 0.0,
        }
        for metrica, vals in acumulado.items()
    }


def procesar_resultados(config: ConfigEval):
    out_path = config.global_json
    if out_path.exists():
        return None  # skip
    resumen = calcular_resumen_experimento(leer_metricas_folds(config))
    escribir_json(resumen, out_path)
    return resumen


def ejecutar_flujo_promediar(config: ConfigEval, verbose=False):
    if verbose:
        logger.header(f"\n🧮 Promediando folds ({config.plano}).")
    try:
        # early precondition (reference ConfigEval.py:370-399): all k fold
        # JSONs must exist before averaging
        config.verificar_paths_experimento()
        res = procesar_resultados(config)
    except FileNotFoundError as e:
        # incomplete experiment: aggregate later, don't abort the pipeline
        logger.warning(f"⚠️ Promediado omitido: {e}")
        return False
    if res is None:
        logger.skip("⏩ Resumen global ya existente.")
    else:
        logger.info(f"🆗 Resumen global calculado: {res}")
    return res


def parsear_args(argv=None):
    parser = argparse.ArgumentParser(description="Promediar métricas entre folds.")
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
    return parser.parse_args(argv if argv is not None else sys.argv[1:])


def main(argv=None):
    args = parsear_args(argv)
    modelo = Modelo(
        plano=args.plano, num_cortes=args.num_cortes, modalidad=args.modalidad,
        k_folds=args.k_folds, mejora=args.mejora,
    )
    config = ConfigEval(
        modelo=modelo, epochs=args.epochs, k_folds=args.k_folds, fold_test=1,
        plano_forzado=args.plano if args.plano == "consenso" else None,
    )
    ejecutar_flujo_promediar(config, verbose=True)


def ejecutar_promediar_folds_pipeline(
    modelo, epochs=50, k_folds=5, plano_forzado=None
):
    config = ConfigEval(
        modelo=modelo, epochs=epochs, k_folds=k_folds, fold_test=1,
        plano_forzado=plano_forzado,
    )
    return ejecutar_flujo_promediar(config)


if __name__ == "__main__":
    main()
