"""Stage 3 — 2D prediction: the pieces the fast serving path reads.

Port of ``tpu_mslesseg/pipeline/stages/generar_predicciones.py``'s
``_SLICE_RE`` and ``indices_de_imagenes``: the slice indices a patient's
stage-1 images name. The stage itself comes with the orchestrator.
"""

from __future__ import annotations

import re
from pathlib import Path

_SLICE_RE = re.compile(r".*_(\d+)(?:_[^_]*)?\.png$")


def indices_de_imagenes(images_dir: Path) -> list:
    out = set()
    for f in Path(images_dir).glob("*.png"):
        m = _SLICE_RE.match(f.name)
        if m:
            out.add(int(m.group(1)))
    return sorted(out)
