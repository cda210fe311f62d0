"""Experiment-identity value object (reference ``utils/Modelo.py``).

Port of ``tpu_mslesseg/pipeline/modelo.py``, unchanged.

Names an experiment by plane, modalities, slice count (int or ``P<n>``
percentile), k_folds and enhancement, and derives the canonical artifact
paths used across every stage:

* ``exp_string``  -> "Base" or the enhancement name (``Modelo.py:81-84``)
* ``base_path``   -> ``<exp>/<mods>_<n>c_<k>folds``   (``Modelo.py:87-92``)
* ``model_string``-> ``<plane>_<mods>[_<mejora>]_<n>c_<k>folds`` (``:94-100``)
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path

PLANOS = ("axial", "coronal", "sagital", "consenso")
MEJORAS = (None, "HE", "CLAHE", "GC", "LT")
MODALIDADES = ("T1", "T2", "FLAIR")


@dataclass
class Modelo:
    plano: str
    num_cortes: object  # int or "P<n>"
    modalidad: list
    k_folds: int
    mejora: str | None = None
    modalidad_str: str = field(init=False)

    def __post_init__(self):
        self.plano = self.plano.lower()
        if self.plano not in PLANOS:
            raise ValueError(f"Plano '{self.plano}' no válido. Debe ser uno de {PLANOS}.")
        self.mejora = self.mejora.upper() if self.mejora else None
        if self.mejora not in MEJORAS:
            raise ValueError(f"Mejora '{self.mejora}' no válida. Debe ser uno de {MEJORAS}.")
        self.modalidad = list(self.modalidad)
        self.modalidad_str = "".join(self.modalidad)

    @property
    def exp_string(self) -> str:
        return self.mejora if self.mejora else "Base"

    @property
    def base_path(self) -> Path:
        return Path(self.exp_string) / (
            f"{self.modalidad_str}_{self.num_cortes}c_{self.k_folds}folds"
        )

    @property
    def model_string(self) -> str:
        if not self.mejora:
            return f"{self.plano}_{self.modalidad_str}_{self.num_cortes}c_{self.k_folds}folds"
        return (
            f"{self.plano}_{self.modalidad_str}_{self.mejora}_"
            f"{self.num_cortes}c_{self.k_folds}folds"
        )

    def __repr__(self):
        return f"Modelo({self.model_string})"

    def __str__(self):
        return self.model_string
