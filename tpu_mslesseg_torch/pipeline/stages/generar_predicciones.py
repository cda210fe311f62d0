"""Stage 3 — 2D prediction: trained model over every test-fold slice.

Port of ``tpu_mslesseg/pipeline/stages/generar_predicciones.py``.
Reference: ``scripts/generar_predicciones.py`` — a serial per-image Python
loop (SURVEY §3.4 hot loop). Here each patient's slices run as one
`SlicePredictor` call per modality on the device and only the final binary
PNGs touch disk.
"""

from __future__ import annotations

import argparse
import re
import sys
from pathlib import Path

import numpy as np
import torch

from tpu_mslesseg_torch.core.device import exigir, kernels_de
from tpu_mslesseg_torch.infer.predictor import SlicePredictor
from tpu_mslesseg_torch.io import png
from tpu_mslesseg_torch.model import stem
from tpu_mslesseg_torch.pipeline.logging_setup import evaluate_results, get_logger, log_fold_status
from tpu_mslesseg_torch.pipeline.modelo import Modelo
from tpu_mslesseg_torch.pipeline.paciente import Paciente, listar_pacientes
from tpu_mslesseg_torch.pipeline.paths import ConfigPred
from tpu_mslesseg_torch.pipeline.stages.cola import procesar_en_cola
from tpu_mslesseg_torch.preproc.slices import int_o_percentil
from tpu_mslesseg_torch.train import checkpoint

logger = get_logger(__file__)

# max patients whose masks stay on the device before they are fetched and
# written (dispatch/fetch pipeline): bounds the pending buffers on
# full-dataset runs. A dispatch here is not asynchronous (NMS reads a flag
# back to the host each step), so the depth orders the work, it does not
# overlap it.
PIPELINE_DEPTH = 4

_SLICE_RE = re.compile(r".*_(\d+)(?:_[^_]*)?\.png$")


def cargar_predictor(config: ConfigPred, slice_hw, device="cuda") -> SlicePredictor:
    """Load the fold's best checkpoint and build the predictor on `device`."""
    from tpu_mslesseg_torch.model.yolo11 import create_model_from_env

    model, _, imgsz = create_model_from_env()
    variables = checkpoint.load_checkpoint(config.model_path)
    return SlicePredictor(
        model, variables, slice_hw=slice_hw, imgsz=imgsz, device=device
    )


def indices_de_imagenes(images_dir: Path) -> list:
    out = set()
    for f in Path(images_dir).glob("*.png"):
        m = _SLICE_RE.match(f.name)
        if m:
            out.add(int(m.group(1)))
    return sorted(out)


def predicciones_completas(dirs: dict) -> bool:
    imgs = indices_de_imagenes(dirs["images"]) if dirs["images"].is_dir() else []
    if not imgs:
        return False
    preds = dirs["pred_masks"]
    if not preds.is_dir():
        return False
    have = indices_de_imagenes(preds)
    return set(imgs) <= set(have)


def despachar_paciente_predicciones(paciente_id, config, predictor_cache,
                                    device="cuda"):
    """Run the predictor for one patient WITHOUT fetching the masks:
    returns None (skip), False (no images) or a pending tuple for
    `finalizar_paciente_predicciones`, whose masks are still a tensor on
    `device`."""
    dirs = config.paciente_dirs(paciente_id)
    if predicciones_completas(dirs):
        return None  # skip

    indices = indices_de_imagenes(dirs["images"])
    if not indices:
        logger.warning(f"⚠️ Sin imágenes extraídas para {paciente_id}.")
        return False

    paciente = Paciente(
        id=paciente_id, plano=config.modelo.plano, modalidad=config.modelo.modalidad,
        mejora=config.modelo.mejora, dataset_dir=config.dataset_entrada,
    )
    # enhanced slices straight from the volume (equivalent to reading back
    # the stage-1 PNGs); multimodal experiments predict every modality and
    # union the masks ON DEVICE (the reference's reconstruction likewise
    # folds every modality's prediction PNG into the same volume)
    from tpu_mslesseg_torch.preproc import enhance

    masks = None
    for mod in config.modelo.modalidad:
        # one transfer a patient and modality, not one a slice
        raw = torch.from_numpy(paciente.cortes_imagen_batch(indices, mod)).to(device)
        imgs = enhance.enhance_for_model(raw, config.modelo.mejora)
        hw = tuple(imgs.shape[1:])
        if hw not in predictor_cache:
            predictor_cache[hw] = cargar_predictor(config, hw, device=device)
        m = predictor_cache[hw](imgs)  # stays on the device
        masks = m if masks is None else (masks | m)
    return paciente_id, indices, masks, dirs, paciente.modalidad_str


def finalizar_paciente_predicciones(pendiente) -> bool:
    """Fetch a dispatched patient's masks and write the PNG artifacts."""
    paciente_id, indices, masks, dirs, mod = pendiente
    masks_np = masks.cpu().numpy()
    dirs["pred_masks"].mkdir(parents=True, exist_ok=True)
    png.save_gray_batch(
        [dirs["pred_masks"] / f"{paciente_id}_{mod}_{i}.png" for i in indices],
        (masks_np > 0).astype(np.uint8) * 255,
    )
    return True


def procesar_paciente_predicciones(paciente_id, config, predictor_cache,
                                   device="cuda"):
    """Predict all slices of one patient in one device call."""
    pendiente = despachar_paciente_predicciones(
        paciente_id, config, predictor_cache, device=device
    )
    if pendiente is None or pendiente is False:
        return pendiente
    return finalizar_paciente_predicciones(pendiente)


def ejecutar_flujo_pred(config: ConfigPred, limpiar=False, verbose=False,
                        device="cuda"):
    if verbose:
        target = (
            f"paciente {config.paciente}"
            if config.es_paciente_individual
            else f"fold {config.fold_test}"
        )
        logger.header(f"\n🔮 Generando predicciones 2D para el {target}.")

    device = exigir(device, kernels_de(config.modelo.mejora, stem=stem.ENABLED, union=True))
    if limpiar:
        if verbose:
            logger.info("♻️ Limpiando predicciones previas.")
        config.limpiar_predicciones()

    config.verificar_paths()
    cache = {}

    if config.es_paciente_individual:
        res = procesar_paciente_predicciones(
            config.paciente.id, config, cache, device=device
        )
        if res is None:
            logger.skip("⏩ Predicciones ya existentes.")
        elif res:
            logger.info("✅ Predicciones generadas.")
        return res

    pacientes = (
        listar_pacientes(config.dataset_fold_dir)
        if config.dataset_fold_dir.is_dir()
        else []
    )
    # dispatch/fetch in two steps: keep at most PIPELINE_DEPTH patients'
    # device results pending, so device-resident memory stays O(depth)
    # instead of O(patients) (full-dataset runs have 53)
    resultados = procesar_en_cola(
        pacientes,
        lambda pid: despachar_paciente_predicciones(pid, config, cache, device=device),
        finalizar_paciente_predicciones,
        PIPELINE_DEPTH,
        lambda pid, e: logger.warning(f"⚠️ Error prediciendo {pid}, se omite: {e}."),
    )
    estado = evaluate_results(resultados)
    log_fold_status(logger, estado, config.fold_test)
    return estado


def parsear_args(argv=None):
    parser = argparse.ArgumentParser(description="Generar predicciones 2D.")
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
            mejora=modelo.mejora, dataset_dir="MSLesSeg-Dataset/train",
        )
    config = ConfigPred(
        modelo=modelo, epochs=args.epochs, k_folds=args.k_folds,
        fold_test=args.fold_test, paciente=paciente,
    )
    ejecutar_flujo_pred(config, limpiar=args.limpiar, verbose=True)


def ejecutar_predicciones_pipeline(
    modelo, epochs=50, k_folds=5, fold_test=None, paciente=None, limpiar=False,
    device="cuda",
):
    config = ConfigPred(
        modelo=modelo, epochs=epochs, k_folds=k_folds,
        fold_test=fold_test, paciente=paciente,
    )
    return ejecutar_flujo_pred(config, limpiar=limpiar, device=device)


if __name__ == "__main__":
    main()
