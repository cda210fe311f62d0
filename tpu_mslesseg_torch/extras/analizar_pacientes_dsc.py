"""Per-patient DSC analysis: best/worst patient per enhancement.

Port of ``tpu_mslesseg/extras/analizar_pacientes_dsc.py``, unchanged.
Reference: ``extras/analizar_pacientes_dsc.py`` — scans the ``results/``
tree, takes each patient's max DSC *over anatomical planes* (consensus
excluded, :84-85), and reports the best and worst patient per enhancement.
"""

from __future__ import annotations

import argparse
import json
import re
import sys
from pathlib import Path

from tpu_mslesseg_torch.pipeline.logging_setup import get_logger

logger = get_logger(__file__)

_PLANE_RE = re.compile(r"P\d+_(axial|coronal|sagital|consenso)_results\.json$")
_PATIENT_RE = re.compile(r"(P\d+)_")


def extraer_plano_desde_json(name: str):
    m = _PLANE_RE.search(name)
    return m.group(1) if m else None


def analizar_experimento(config_dir: Path) -> dict:
    """{patient: max-DSC-over-planes} for one experiment config dir."""
    dscs: dict = {}
    for f in config_dir.rglob("P*_results.json"):
        plano = extraer_plano_desde_json(f.name)
        if plano is None or plano == "consenso":
            continue
        pid = _PATIENT_RE.match(f.name).group(1)
        try:
            d = json.loads(f.read_text()).get("DSC")
        except (json.JSONDecodeError, OSError):
            continue
        if d is None:
            continue
        dscs[pid] = max(dscs.get(pid, float("-inf")), float(d))
    return dscs


def analizar_resultados(results_root="results") -> dict:
    """Per enhancement: best and worst patient by max-over-planes DSC."""
    root = Path(results_root)
    out = {}
    if not root.is_dir():
        raise FileNotFoundError(f"No existe {root}.")
    for mejora_dir in sorted(root.iterdir()):
        if not mejora_dir.is_dir():
            continue
        for config_dir in sorted(mejora_dir.iterdir()):
            dscs = analizar_experimento(config_dir)
            if not dscs:
                continue
            best = max(dscs, key=dscs.get)
            worst = min(dscs, key=dscs.get)
            out[f"{mejora_dir.name}/{config_dir.name}"] = {
                "mejor": {"paciente": best, "DSC": dscs[best]},
                "peor": {"paciente": worst, "DSC": dscs[worst]},
                "n_pacientes": len(dscs),
            }
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description="Análisis de DSC por paciente.")
    parser.add_argument("--results", default="results")
    args = parser.parse_args(argv if argv is not None else sys.argv[1:])
    resumen = analizar_resultados(args.results)
    for exp, info in resumen.items():
        logger.info(
            f"📊 {exp}: mejor {info['mejor']['paciente']} "
            f"(DSC {info['mejor']['DSC']:.3f}), peor {info['peor']['paciente']} "
            f"(DSC {info['peor']['DSC']:.3f}), n={info['n_pacientes']}"
        )
    return resumen


if __name__ == "__main__":
    main()
