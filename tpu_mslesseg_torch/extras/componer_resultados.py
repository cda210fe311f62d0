"""Results-table composer: all global JSONs -> one CSV of ``mean ± std``.

Port of ``tpu_mslesseg/extras/componer_resultados.py`` on the standard
library's ``csv`` in place of pandas. Reference:
``extras/componer_resultados.py`` — aggregates every
``global_<plano>_results.json`` across enhancements into a table ordered
Base/HE/CLAHE/GC/LT x Axial/Coronal/Sagital/Consenso (:150-222).

The file is the one the JAX package's ``df.to_csv(out, index=False)`` writes:
columns as pandas builds them from the rows (Mejora, Config, Plano, then each
metric in first-seen order), an empty field for a metric a JSON lacks,
unknown enhancements and planes after the known ones in stable order, ``\\n``
line endings. `componer_resultados` returns the rows as a list of dicts in
table order, each with every column in the table's order (None for a metric
its JSON lacks, where pandas holds NaN), not a DataFrame.
"""

from __future__ import annotations

import argparse
import csv
import json
import sys
from pathlib import Path

from tpu_mslesseg_torch.pipeline.logging_setup import get_logger

logger = get_logger(__file__)

ORDEN_MEJORAS = ["Base", "HE", "CLAHE", "GC", "LT"]
ORDEN_PLANOS = ["axial", "coronal", "sagital", "consenso"]
METRICAS = ["DSC", "AUC", "Precision", "Recall"]


def parsear_experimento(json_path: Path):
    """(mejora, config, plano) from results/<mejora>/<config>/global_<plano>_results.json"""
    plano = json_path.stem.replace("global_", "").replace("_results", "")
    return json_path.parent.parent.name, json_path.parent.name, plano


def _orden(row) -> tuple:
    """Table order: known enhancements, then config, then known planes;
    unknown ones after the known (the sort is stable)."""
    m = {m: i for i, m in enumerate(ORDEN_MEJORAS)}.get(row["Mejora"], len(ORDEN_MEJORAS))
    p = {p: i for i, p in enumerate(ORDEN_PLANOS)}.get(
        row["Plano"].lower(), len(ORDEN_PLANOS)
    )
    return m, row["Config"], p


def componer_resultados(results_root="results") -> list[dict]:
    root = Path(results_root)
    rows = []
    for f in sorted(root.glob("*/*/global_*_results.json")):
        mejora, config, plano = parsear_experimento(f)
        data = json.loads(f.read_text())
        row = {"Mejora": mejora, "Config": config, "Plano": plano.capitalize()}
        for m in METRICAS:
            if m in data:
                row[m] = f"{data[m]['media']:.3f} ± {data[m]['std']:.3f}"
        rows.append(row)
    if not rows:
        raise FileNotFoundError(f"No hay global_*_results.json bajo {root}.")
    # columns in first-seen order over the files as read, as pandas builds them
    columns = list(dict.fromkeys(k for row in rows for k in row))
    return sorted(({c: row.get(c) for c in columns} for row in rows), key=_orden)


def escribir_csv(rows: list[dict], out) -> None:
    """The rows as CSV, no index column, an empty field for None."""
    with open(out, "w", encoding="utf-8", newline="") as fh:
        writer = csv.writer(fh, lineterminator="\n")
        writer.writerow(rows[0])
        writer.writerows(row.values() for row in rows)


def main(argv=None):
    parser = argparse.ArgumentParser(description="Tabla global de resultados.")
    parser.add_argument("--results", default="results")
    parser.add_argument("--out", default="resultados_globales.csv")
    args = parser.parse_args(argv if argv is not None else sys.argv[1:])
    rows = componer_resultados(args.results)
    escribir_csv(rows, args.out)
    logger.info(f"📋 Tabla global escrita en {args.out} ({len(rows)} filas).")
    return rows


if __name__ == "__main__":
    main()
