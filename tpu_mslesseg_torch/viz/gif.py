"""Animated GIF of predictions over all slices (TP/FP/FN overlay).

Port of ``tpu_mslesseg/viz/gif.py``. Reference:
``extras/generar_gif_predicciones.py`` — global intensity normalization
across the patient's slices (:141-148), adaptive FPS ``max(3, min(12, n/4))``
(:308), output under ``visualizaciones/<mejora>/<config>/fold<k>/PX/<plano>/``.

The frames are computed by `preparar_gif`, which needs numpy alone;
`generar_gif` then imports imageio and writes them. Where imageio is not
installed, `generar_gif` raises its ``ImportError`` before it creates the
output directory, so nothing is written.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

from tpu_mslesseg_torch.pipeline.logging_setup import get_logger
from tpu_mslesseg_torch.pipeline.modelo import Modelo
from tpu_mslesseg_torch.pipeline.paciente import calcular_fold
from tpu_mslesseg_torch.preproc.slices import int_o_percentil
from tpu_mslesseg_torch.viz import overlay

logger = get_logger(__file__)


def collect_slices(base_dir: Path, paciente_id: str, modalidad_str: str):
    """(index, img_path, pred_path, gt_path) for every predicted slice.

    Stage 1 writes images per single modality
    (``P1_FLAIR_23.png``), while predictions carry the joined modality
    string; fall back to any modality's image for the slice."""
    images = base_dir / "images"
    preds = base_dir / "pred_masks"
    gts = base_dir / "GT_masks"
    out = []
    for f in sorted(preds.glob("*.png")):
        try:
            idx = int(f.stem.split("_")[-1])
        except ValueError:
            continue
        img = images / f"{paciente_id}_{modalidad_str}_{idx}.png"
        if not img.exists():
            candidates = sorted(images.glob(f"{paciente_id}_*_{idx}.png"))
            img = candidates[0] if candidates else img
        gt = gts / f"{paciente_id}_{idx}.png"
        if img.exists() and gt.exists():
            out.append((idx, img, f, gt))
    return sorted(out)


def prediction_dir(modelo: Modelo, paciente_id: str, root: Path) -> Path:
    """The patient's stage-1/3 slice folder of `modelo`'s experiment."""
    fold = calcular_fold(paciente_id, modelo.k_folds)
    return (
        root / "datasets" / modelo.base_path / f"fold{fold}" / paciente_id
        / modelo.plano
    )


def preparar_gif(modelo: Modelo, paciente_id: str, epochs: int, root=None):
    """(frames, fps, out_path) of the patient's GIF: one RGB uint8 frame a
    predicted slice, in slice order, under one intensity range."""
    root = Path(root) if root else Path.cwd()
    fold = calcular_fold(paciente_id, modelo.k_folds)
    base_dir = prediction_dir(modelo, paciente_id, root)
    triplets = collect_slices(base_dir, paciente_id, modelo.modalidad_str)
    if not triplets:
        raise FileNotFoundError(f"No hay predicciones para {paciente_id} en {base_dir}.")

    loaded = [overlay.load_triplet(i, p, g) for _, i, p, g in triplets]
    lo = min(img.min() for img, _, _ in loaded)
    hi = max(img.max() for img, _, _ in loaded)
    frames = [overlay.render_overlay(img, pred, gt, lo, hi) for img, pred, gt in loaded]

    fps = max(3, min(12, len(frames) / 4))
    out_dir = overlay.viz_output_dir(modelo, epochs, fold, paciente_id, modelo.plano, root)
    return frames, fps, out_dir / f"{paciente_id}_{modelo.modalidad_str}.gif"


def generar_gif(modelo: Modelo, paciente_id: str, epochs: int, root=None) -> Path:
    frames, fps, out_path = preparar_gif(modelo, paciente_id, epochs, root)

    import imageio.v2 as imageio

    out_path.parent.mkdir(parents=True, exist_ok=True)
    imageio.mimsave(out_path, frames, duration=1.0 / fps, loop=0)
    logger.info(f"🎞️ GIF guardado en {out_path} ({len(frames)} cortes, {fps:.0f} fps).")
    return out_path


def parsear_args(argv=None):
    parser = argparse.ArgumentParser(description="GIF de predicciones TP/FP/FN.")
    parser.add_argument("--paciente_id", required=True)
    parser.add_argument("--plano", required=True, choices=["axial", "coronal", "sagital"])
    parser.add_argument("--modalidad", nargs="+", default=["T1", "T2", "FLAIR"])
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
    generar_gif(modelo, args.paciente_id, args.epochs)


if __name__ == "__main__":
    main()
