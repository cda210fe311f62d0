"""Stage 1 — slice extraction: NIfTI volumes -> per-patient slice/mask PNGs
+ YOLO-seg labels, fold-partitioned.

Port of ``tpu_mslesseg/pipeline/stages/extraer_dataset.py``. Reference:
``scripts/extraer_dataset.py``. Same CLI flags, same artifact layout, same
skip-if-exists resume; internally the per-slice host loop is replaced by
batched enhancement on the device (one call per patient per modality, one
transfer each way) with PNG conversion only at the file boundary.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from tpu_mslesseg_torch.core import geometry
from tpu_mslesseg_torch.core.device import es_fallo_de_dispositivo, exigir, kernels_de
from tpu_mslesseg_torch.io import png
from tpu_mslesseg_torch.pipeline import labels as labels_mod
from tpu_mslesseg_torch.pipeline.logging_setup import evaluate_results, get_logger
from tpu_mslesseg_torch.pipeline.modelo import Modelo
from tpu_mslesseg_torch.pipeline.paciente import Paciente, listar_pacientes
from tpu_mslesseg_torch.pipeline.paths import ConfigDataset
from tpu_mslesseg_torch.preproc import enhance
from tpu_mslesseg_torch.preproc.slices import int_o_percentil, resolver_num_cortes

logger = get_logger(__file__)


def guardar_cortes(paciente: Paciente, dirs: dict, num_cortes, device="cuda"):
    """Batched extraction of one patient's lesion slices + masks -> PNGs.
    The enhancement and the 8-bit stretch run on `device`."""
    indices = paciente.indices_a_usar(num_cortes)
    if not indices:
        raise ValueError(
            f"No se encontraron cortes válidos para el paciente {paciente.id}."
        )
    mask_batch = paciente.cortes_mascara_batch(indices)
    for d in dirs.values():
        d.mkdir(parents=True, exist_ok=True)

    for mod in paciente.modalidad:
        raw = torch.from_numpy(paciente.cortes_imagen_batch(indices, mod)).to(device)
        imgs = enhance.enhance_batch(raw, paciente.mejora)
        pngs = geometry.minmax_to_uint8(geometry.to_png_space_batch(imgs)).cpu().numpy()
        png.save_gray_batch(
            [dirs["images"] / f"{paciente.id}_{mod}_{i}.png" for i in indices], pngs
        )

    mask_pngs = (
        geometry.to_png_space_batch(torch.from_numpy(mask_batch)).numpy() > 0
    ).astype(np.uint8)
    png.save_gray_batch(
        [dirs["GT_masks"] / f"{paciente.id}_{i}.png" for i in indices], mask_pngs
    )
    for j, i in enumerate(indices):
        labels_mod.write_yolo_seg_label(
            mask_pngs[j], dirs["labels"] / f"{paciente.id}_{i}.txt"
        )
    return indices


def procesar_paciente_dataset(paciente, config, paths_dir=None, num_cortes=None,
                              device="cuda"):
    if paths_dir is None:
        paths_dir = config.paciente_dir
    if all(p.is_dir() and any(p.iterdir()) for p in paths_dir.values()):
        return None  # already extracted (skip)
    guardar_cortes(paciente, paths_dir, num_cortes, device=device)
    return True


def ejecutar_flujo_dataset(config: ConfigDataset, limpiar=False, verbose=False,
                           device="cuda"):
    if verbose:
        target = (
            f"paciente {config.paciente}"
            if config.es_paciente_individual
            else "conjunto de pacientes completo"
        )
        logger.header(f"\n🧩 Preparando dataset YOLO para el {target}.")

    device = exigir(device, kernels_de(config.modelo.mejora))
    if limpiar:
        if verbose:
            logger.info("♻️ Limpiando dataset YOLO previo.")
        config.limpiar_dataset()

    config.verificar_paths()

    num_cortes, percentil = resolver_num_cortes(
        num_cortes=config.modelo.num_cortes,
        input_dir=config.dataset_entrada,
        plano=config.modelo.plano,
        modalidad=config.modelo.modalidad,
    )
    suffix = f" (P{percentil})" if percentil is not None else ""
    logger.info(f"📊 Número de cortes a extraer: {num_cortes}{suffix}.")

    if config.es_paciente_individual:
        res = procesar_paciente_dataset(
            config.paciente, config, num_cortes=num_cortes, device=device
        )
        if res is None:
            logger.skip("⏩ Dataset YOLO ya existente.")
        else:
            logger.info("✅ Extracción de cortes completada.")
            logger.info("📝 Anotaciones completadas.")
        return res

    resultados = []
    for pid in listar_pacientes(config.dataset_entrada):
        paciente = Paciente(
            id=pid,
            plano=config.modelo.plano,
            modalidad=config.modelo.modalidad,
            mejora=config.modelo.mejora,
            dataset_dir=config.dataset_entrada,
        )
        dirs = config.paths_paciente_dirs(pid)
        try:
            resultados.append(
                procesar_paciente_dataset(
                    paciente, config, dirs, num_cortes, device=device
                )
            )
        except Exception as e:
            if es_fallo_de_dispositivo(e):
                raise
            logger.warning(f"⚠️ Error extrayendo dataset YOLO de {pid}, se omite: {e}.")

    estado = evaluate_results(resultados)
    if estado is None:
        logger.skip("⏩ Dataset YOLO ya existente.")
    elif estado is True:
        logger.info("🆗 Dataset YOLO extraído con éxito.")
    else:
        logger.info("🔁 Dataset YOLO parcialmente actualizado.")
    return estado


def parsear_args(argv=None):
    parser = argparse.ArgumentParser(
        description="Extraer el dataset YOLO (cortes + máscaras + labels)."
    )
    parser.add_argument("--plano", required=True, choices=["axial", "coronal", "sagital"])
    parser.add_argument(
        "--modalidad", nargs="+", choices=["T1", "T2", "FLAIR"],
        default=["T1", "T2", "FLAIR"],
    )
    parser.add_argument("--num_cortes", type=int_o_percentil, required=True)
    parser.add_argument("--mejora", default=None, choices=["HE", "CLAHE", "GC", "LT"])
    parser.add_argument("--k_folds", type=int, default=5)
    group = parser.add_mutually_exclusive_group(required=True)
    group.add_argument("--completo", action="store_true")
    group.add_argument("--paciente_id", type=str)
    parser.add_argument("--limpiar", action="store_true")
    return parser.parse_args(argv if argv is not None else sys.argv[1:])


def main(argv=None):
    args = parsear_args(argv)
    modelo = Modelo(
        plano=args.plano, num_cortes=args.num_cortes, modalidad=args.modalidad,
        k_folds=args.k_folds, mejora=args.mejora,
    )
    if args.paciente_id:
        paciente = Paciente(
            id=args.paciente_id, plano=modelo.plano, modalidad=modelo.modalidad,
            mejora=modelo.mejora, dataset_dir="MSLesSeg-Dataset/train",
        )
        config = ConfigDataset(modelo=modelo, k_folds=args.k_folds, paciente=paciente)
    else:
        config = ConfigDataset(modelo=modelo, k_folds=args.k_folds, completo=True)
    ejecutar_flujo_dataset(config, limpiar=args.limpiar, verbose=True)


def ejecutar_dataset_pipeline(modelo, paciente=None, k_folds=5, limpiar=False,
                              device="cuda"):
    config = ConfigDataset(
        modelo=modelo, k_folds=k_folds, paciente=paciente, completo=paciente is None
    )
    return ejecutar_flujo_dataset(config, limpiar=limpiar, device=device)


if __name__ == "__main__":
    main()
