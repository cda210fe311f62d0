"""Stage 4 — 3D reconstruction: prediction PNGs -> NIfTI volumes.

Port of ``tpu_mslesseg/pipeline/stages/reconstruir_volumen.py``.
Reference: ``scripts/reconstruir_volumen.py`` — per-slice host loop with
index/shape validation. Here the per-patient slice stack is validated on
host (filename index regex, per-plane slice dims, index range) and the
volume is built with one device scatter, then saved with the GT's affine.
"""

from __future__ import annotations

import argparse
import re
import sys

import numpy as np
import torch

from tpu_mslesseg_torch.core import geometry
from tpu_mslesseg_torch.core.device import exigir
from tpu_mslesseg_torch.infer.reconstruct import reconstruct_volume
from tpu_mslesseg_torch.io import nifti, png
from tpu_mslesseg_torch.pipeline.logging_setup import evaluate_results, get_logger, log_fold_status
from tpu_mslesseg_torch.pipeline.modelo import Modelo
from tpu_mslesseg_torch.pipeline.paciente import Paciente, listar_pacientes
from tpu_mslesseg_torch.pipeline.paths import ConfigRecVol
from tpu_mslesseg_torch.pipeline.stages.cola import procesar_en_cola
from tpu_mslesseg_torch.preproc.slices import int_o_percentil

logger = get_logger(__file__)

# max patients with device results in flight (see generar_predicciones)
PIPELINE_DEPTH = 4

_IDX_RE = re.compile(r".*_(\d+)(?:_[^_]*)?\.png$")


def extraer_indice_png(nombre: str):
    m = _IDX_RE.match(nombre)
    return int(m.group(1)) if m else None


def validar_corte(slice2d, vol_shape, plano, indice):
    """Per-plane slice dimension + index-range validation
    (reference ``reconstruir_volumen.py:153-177``)."""
    expected = geometry.slice_shape(vol_shape, plano)
    n = geometry.num_slices(vol_shape, plano)
    if not 0 <= indice < n:
        raise ValueError(f"Índice de corte fuera de rango: {indice} (max {n - 1}).")
    if slice2d.shape != expected:
        raise ValueError(
            f"Dimensiones de corte inválidas {slice2d.shape}, esperadas {expected}."
        )


def despachar_paciente_vol(paciente_id, config: ConfigRecVol, device="cuda"):
    """Read+validate the patient's prediction PNGs and run the scatter on
    `device` without fetching: returns None (skip), False (no preds) or a
    pending tuple for `finalizar_paciente_vol`. The range check of
    `validar_corte` comes first: `insert_slices` would drop an
    out-of-range slice without a word."""
    out_path = config.vol_path(paciente_id)
    gt_path = config.gt_path(paciente_id)

    if out_path.exists():
        try:
            existing = nifti.load(out_path)
            gt_shape, _ = nifti.load_header(gt_path)
            # skip only if shape-valid and non-empty (reference rebuilds
            # missing/empty/mismatched volumes, `reconstruir_volumen.py:240-257`)
            if existing.shape == gt_shape and existing.data.max() > 0:
                return None
        except Exception:
            pass  # invalid file: rebuild

    pred_dir = config.pred_masks_dir(paciente_id)
    if not pred_dir.is_dir():
        logger.warning(f"⚠️ Sin predicciones para {paciente_id}.")
        return False
    gt_shape, affine = nifti.load_header(gt_path)
    files = sorted(pred_dir.glob("*.png"))
    indices, slices = [], []
    for f in files:
        i = extraer_indice_png(f.name)
        if i is None:
            continue
        sl = png.load_pred_png(f)
        validar_corte(sl, gt_shape, config.modelo.plano, i)
        indices.append(i)
        slices.append(sl)
    if not indices:
        raise ValueError(f"No hay predicciones en {pred_dir}.")
    vol_dev = reconstruct_volume(
        gt_shape, torch.from_numpy(np.stack(slices)).to(device),
        config.modelo.plano, indices,
    )
    if tuple(vol_dev.shape) != gt_shape:
        raise ValueError(f"Reconstrucción inválida: {vol_dev.shape} vs {gt_shape}.")
    return vol_dev, affine, out_path


def finalizar_paciente_vol(pendiente) -> bool:
    """Fetch a dispatched patient's volume and write the NIfTI."""
    vol_dev, affine, out_path = pendiente
    nifti.save(vol_dev.cpu().numpy().astype(np.float32), affine, out_path)
    return True


def procesar_paciente_vol(paciente_id, config: ConfigRecVol, device="cuda"):
    pendiente = despachar_paciente_vol(paciente_id, config, device=device)
    if pendiente is None or pendiente is False:
        return pendiente
    return finalizar_paciente_vol(pendiente)


def ejecutar_flujo_recvol(config: ConfigRecVol, limpiar=False, verbose=False,
                          device="cuda"):
    if verbose:
        target = (
            f"paciente {config.paciente}"
            if config.paciente is not None
            else f"fold {config.fold_test}"
        )
        logger.header(f"\n🧱 Reconstruyendo volúmenes 3D para el {target}.")

    device = exigir(device)
    if limpiar:
        if verbose:
            logger.info("♻️ Limpiando reconstrucciones previas.")
        config.limpiar_reconstrucciones()

    config.verificar_paths()

    if config.paciente is not None:
        res = procesar_paciente_vol(config.paciente.id, config, device=device)
        if res is None:
            logger.skip("⏩ Volumen ya reconstruido.")
        elif res:
            logger.info("✅ Volumen reconstruido.")
        return res

    dataset_fold = (
        config.root / "datasets" / config.modelo.base_path / f"fold{config.fold_test}"
    )
    pacientes = listar_pacientes(dataset_fold) if dataset_fold.is_dir() else []
    # dispatch/fetch in two steps (depth-bounded): pending device volumes
    # stay O(depth) rather than O(patients) for full-dataset runs
    resultados = procesar_en_cola(
        pacientes,
        lambda pid: despachar_paciente_vol(pid, config, device=device),
        finalizar_paciente_vol,
        PIPELINE_DEPTH,
        lambda pid, e: logger.warning(f"⚠️ Error reconstruyendo {pid}, se omite: {e}."),
    )
    estado = evaluate_results(resultados)
    log_fold_status(logger, estado, config.fold_test)
    return estado


def parsear_args(argv=None):
    parser = argparse.ArgumentParser(description="Reconstruir volúmenes 3D.")
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
    config = ConfigRecVol(
        modelo=modelo, epochs=args.epochs, k_folds=args.k_folds,
        fold_test=args.fold_test, paciente=paciente,
    )
    ejecutar_flujo_recvol(config, limpiar=args.limpiar, verbose=True)


def ejecutar_reconstrucciones_pipeline(
    modelo, epochs=50, k_folds=5, fold_test=None, paciente=None, limpiar=False,
    device="cuda",
):
    config = ConfigRecVol(
        modelo=modelo, epochs=epochs, k_folds=k_folds,
        fold_test=fold_test, paciente=paciente,
    )
    return ejecutar_flujo_recvol(config, limpiar=limpiar, device=device)


if __name__ == "__main__":
    main()
