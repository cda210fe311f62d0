"""Best-slice overlay figure.

Port of ``tpu_mslesseg/viz/figure.py``. Reference:
``extras/visualizar_prediccion_corte.py`` — when ``--corte`` is omitted,
scans all predicted slices and picks the one with max DSC (:150-182);
renders image / GT / prediction-overlay panels with the shared TP/FP/FN
colors.

The slice is chosen before matplotlib is imported (Agg backend), so
`seleccionar_mejor_corte` runs where matplotlib is not installed; there
`generar_figura` raises matplotlib's ``ImportError`` and writes nothing.
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
from tpu_mslesseg_torch.viz.gif import collect_slices, prediction_dir

logger = get_logger(__file__)


def seleccionar_mejor_corte(triplets):
    """(index, dsc, loaded triplet) of the max-DSC slice."""
    best = None
    for idx, i, p, g in triplets:
        img, pred, gt = overlay.load_triplet(i, p, g)
        d = overlay.slice_dsc(pred, gt)
        if best is None or d > best[1]:
            best = (idx, d, (img, pred, gt))
    return best


def generar_figura(
    modelo: Modelo, paciente_id: str, epochs: int, corte: int | None = None, root=None
) -> Path:
    root = Path(root) if root else Path.cwd()
    fold = calcular_fold(paciente_id, modelo.k_folds)
    mods = modelo.modalidad_str
    triplets = collect_slices(prediction_dir(modelo, paciente_id, root), paciente_id, mods)
    if not triplets:
        raise FileNotFoundError(f"No hay predicciones para {paciente_id}.")

    if corte is not None:
        sel = [t for t in triplets if t[0] == corte]
        if not sel:
            raise ValueError(f"Corte {corte} sin predicción.")
        idx = corte
        img, pred, gt = overlay.load_triplet(sel[0][1], sel[0][2], sel[0][3])
        dsc = overlay.slice_dsc(pred, gt)
    else:
        idx, dsc, (img, pred, gt) = seleccionar_mejor_corte(triplets)

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(1, 3, figsize=(13, 5))
    axes[0].imshow(img, cmap="gray")
    axes[0].set_title(f"{paciente_id} {mods} corte {idx}")
    axes[1].imshow(gt, cmap="gray")
    axes[1].set_title("Ground truth")
    axes[2].imshow(overlay.render_overlay(img, pred, gt))
    axes[2].set_title(f"Predicción (DSC={dsc:.3f})")
    for ax in axes:
        ax.axis("off")
    fig.tight_layout()

    out_dir = overlay.viz_output_dir(modelo, epochs, fold, paciente_id, modelo.plano, root)
    out_dir.mkdir(parents=True, exist_ok=True)
    out_path = out_dir / f"{paciente_id}_{mods}_{idx}.png"
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    logger.info(f"🖼️ Figura guardada en {out_path} (corte {idx}, DSC {dsc:.3f}).")
    return out_path


def parsear_args(argv=None):
    parser = argparse.ArgumentParser(description="Figura del mejor corte.")
    parser.add_argument("--paciente_id", required=True)
    parser.add_argument("--plano", required=True, choices=["axial", "coronal", "sagital"])
    parser.add_argument("--modalidad", nargs="+", default=["T1", "T2", "FLAIR"])
    parser.add_argument("--num_cortes", type=int_o_percentil, required=True)
    parser.add_argument("--mejora", default=None, choices=["HE", "CLAHE", "GC", "LT"])
    parser.add_argument("--epochs", type=int, default=50)
    parser.add_argument("--k_folds", type=int, default=5)
    parser.add_argument("--corte", type=int, default=None)
    return parser.parse_args(argv if argv is not None else sys.argv[1:])


def main(argv=None):
    args = parsear_args(argv)
    modelo = Modelo(
        plano=args.plano, num_cortes=args.num_cortes, modalidad=args.modalidad,
        k_folds=args.k_folds, mejora=args.mejora,
    )
    generar_figura(modelo, args.paciente_id, args.epochs, corte=args.corte)


if __name__ == "__main__":
    main()
