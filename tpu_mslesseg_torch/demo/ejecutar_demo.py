"""Demo runner: full patient-mode pipeline + GIF + best-slice figure.

Port of ``tpu_mslesseg/demo/ejecutar_demo.py``. Reference:
``demo/ejecutar_demo.py`` — chdirs into ``demo/``, swaps the log file to
``demo.log``, and runs the pipeline for two fixed configurations:
P39/GC/axial (best DSC) and P18/HE/axial (worst DSC), FLAIR, P50 slices,
50 epochs, 5 folds (:55-76). Requires ``demo/MSLesSeg-Dataset`` (the
repository's ``demo/`` folder, not this package's) and trained fold weights
under ``demo/trains``, or ``--entrenar`` to train the fold weights in place
on the demo subset.

Each case runs the port's orchestrator CLI (``pipeline.ejecutar_pipeline``),
which computes on the CUDA card and exits 1 without one. A GIF or figure
that cannot be written (imageio or matplotlib not installed, no
predictions) is the reference's one warning, "Visualización no generada".
"""

from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

from tpu_mslesseg_torch.pipeline.logging_setup import (
    configure_logging,
    configure_logging_demo,
    get_logger,
)

logger = get_logger(__file__)

DEMO_DIR = Path(__file__).resolve().parents[2] / "demo"

DEMO_CASES = [
    {"paciente_id": "P39", "mejora": "GC"},
    {"paciente_id": "P18", "mejora": "HE"},
]


def ejecutar_demo_paciente(paciente_id: str, mejora: str, entrenar: bool, epochs: int):
    from tpu_mslesseg_torch.pipeline import ejecutar_pipeline as pipe
    from tpu_mslesseg_torch.pipeline.modelo import Modelo
    from tpu_mslesseg_torch.viz import figure, gif

    argv = [
        "--paciente_id", paciente_id,
        "--mejora", mejora,
        "--plano", "axial",
        "--modalidad", "FLAIR",
        "--num_cortes", "P50",
        "--epochs", str(epochs),
        "--k_folds", "5",
    ]
    if entrenar:
        argv.append("--entrenar")

    logger.header(f"\n🎬 Demo: paciente {paciente_id} ({mejora}).")
    pipe.main(argv)

    modelo = Modelo(
        plano="axial", num_cortes="P50", modalidad=["FLAIR"], k_folds=5, mejora=mejora
    )
    try:
        gif.generar_gif(modelo, paciente_id, epochs)
        figure.generar_figura(modelo, paciente_id, epochs)
    except Exception as e:
        logger.warning(f"⚠️ Visualización no generada: {e}")


def main(argv=None):
    parser = argparse.ArgumentParser(description="Demo YOLO-MSLesSeg (PyTorch/CUDA).")
    parser.add_argument("--entrenar", action="store_true",
                        help="Entrenar los folds de la demo si faltan pesos.")
    parser.add_argument("--epochs", type=int, default=50)
    args = parser.parse_args(argv if argv is not None else sys.argv[1:])

    os.chdir(DEMO_DIR)
    configure_logging(log_file=None)
    configure_logging_demo()

    for case in DEMO_CASES:
        ejecutar_demo_paciente(
            case["paciente_id"], case["mejora"], args.entrenar, args.epochs
        )
    logger.header("\n🏁 Demo completada.")


if __name__ == "__main__":
    main()
