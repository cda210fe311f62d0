"""Stage 6 — evaluation: the metrics-JSON writer the fast serving path uses.

Port of ``tpu_mslesseg/pipeline/stages/eval.py``'s ``escribir_json``
(patient schema ``{"DSC": x, "AUC": x, "Precision": x, "Recall": x}``). The
stage itself comes with the orchestrator.
"""

from __future__ import annotations

import json
from pathlib import Path


def escribir_json(dic, path):
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        json.dump(dic, f)
