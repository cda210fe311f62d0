"""Patient / volume access (reference ``utils/Paciente.py``), batched.

Port of ``tpu_mslesseg/pipeline/paciente.py``. Same responsibilities as the
reference class — lazy NIfTI loading per modality, timepoint handling with
flat-layout auto-detect (``Paciente.py:120-122``), lesion-slice detection,
centered slice-window selection (``:261-275``) — with slice extraction
batched through the port's ``core/geometry.py``.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from tpu_mslesseg_torch.core import geometry
from tpu_mslesseg_torch.io import nifti

MODALIDADES = ("T1", "T2", "FLAIR")
MEJORAS = ("HE", "CLAHE", "GC", "LT")
PLANOS = ("axial", "coronal", "sagital", "consenso")
TIMEPOINTS = ("T1", "T2", "T3", "T4")

DATASET_DIR = Path("MSLesSeg-Dataset/train")


class Paciente:
    def __init__(
        self,
        id,
        plano,
        timepoint="T1",
        modalidad=None,
        mejora=None,
        gt_mask=None,
        dataset_dir=None,
    ):
        if not id.startswith("P"):
            raise ValueError(
                f"ID de paciente no válido: '{id}'. Debe seguir el formato 'P#'."
            )
        if plano not in PLANOS:
            raise ValueError(f"Plano {plano} no válido.")
        if timepoint not in TIMEPOINTS:
            raise ValueError(f"Timepoint {timepoint} no válido.")
        if mejora is not None and mejora not in MEJORAS:
            raise ValueError(f"Algoritmo de mejora '{mejora}' no válido.")
        if not isinstance(modalidad, list) or not modalidad:
            raise TypeError("Modalidad debe ser una lista no vacía.")
        invalid = [m for m in modalidad if m not in MODALIDADES]
        if invalid:
            raise ValueError(f"Modalidades no reconocidas: {invalid}")

        self.id = id
        self.base_dir = Path(dataset_dir or DATASET_DIR) / id
        self.plano = plano
        self.timepoint = timepoint
        self.sin_timepoints = not any(
            (self.base_dir / tp).exists() for tp in TIMEPOINTS
        )
        self.mejora = mejora
        self._gt_mask = gt_mask
        self._volumenes: dict[str, np.ndarray] = {}
        self.modalidad = list(dict.fromkeys(modalidad))
        self.modalidad_str = "".join(m for m in MODALIDADES if m in set(self.modalidad))

    # ----- paths -----

    def volumen_path(self, modalidad) -> Path:
        if self.sin_timepoints:
            return self.base_dir / f"{self.id}_{modalidad}.nii.gz"
        return (
            self.base_dir
            / self.timepoint
            / f"{self.id}_{self.timepoint}_{modalidad}.nii.gz"
        )

    @property
    def gt_mask_path(self) -> Path:
        if self.sin_timepoints:
            return self.base_dir / f"{self.id}_MASK.nii.gz"
        return self.base_dir / self.timepoint / f"{self.id}_{self.timepoint}_MASK.nii.gz"

    # ----- loading -----

    def cargar_volumen(self, modalidad) -> np.ndarray:
        if modalidad not in self._volumenes:
            path = self.volumen_path(modalidad)
            if not path.exists():
                raise FileNotFoundError(f"No se encontró el volumen {modalidad}.")
            self._volumenes[modalidad] = nifti.load(path).get_fdata()
        return self._volumenes[modalidad]

    @property
    def gt_mask(self) -> np.ndarray:
        if self._gt_mask is None:
            if not self.gt_mask_path.exists():
                raise FileNotFoundError(
                    f"No se encontró la máscara en {self.gt_mask_path}"
                )
            self._gt_mask = nifti.load(self.gt_mask_path).get_fdata()
        return self._gt_mask

    @property
    def affine(self) -> np.ndarray:
        return nifti.load(self.gt_mask_path).affine

    @property
    def num_cortes(self) -> int:
        if self.plano == "consenso":
            raise ValueError("El plano 'consenso' no admite extracción de índices.")
        return geometry.num_slices(self.gt_mask.shape, self.plano)

    # ----- lesion-slice selection -----

    def indices_cortes_con_lesion(self):
        """Indices of slices with any lesion voxel — one vectorized reduction
        over the whole mask instead of a per-slice loop."""
        axis = geometry.plane_axis(self.plano)
        other = tuple(i for i in range(3) if i != axis)
        has_lesion = np.any(self.gt_mask > 0, axis=other)
        return [int(i) for i in np.nonzero(has_lesion)[0]]

    def indices_a_usar(self, num_cortes=None):
        """Centered window of at most `num_cortes` lesion slices
        (reference ``Paciente.py:261-275``)."""
        valid = self.indices_cortes_con_lesion()
        if num_cortes is None or len(valid) <= num_cortes:
            return valid
        centro = len(valid) // 2
        mitad = num_cortes // 2
        start = max(0, centro - mitad)
        return valid[start : start + num_cortes]

    # ----- batched extraction -----

    def _extraer(self, vol, indices) -> np.ndarray:
        vol = torch.from_numpy(np.asarray(vol, np.float32))
        return np.ascontiguousarray(geometry.extract_slices(vol, self.plano, indices).numpy())

    def cortes_imagen_batch(self, indices, modalidad):
        """Raw image slices [N, H, W] float32 for `modalidad` (no
        enhancement: the predictors apply enhancement batched)."""
        return self._extraer(self.cargar_volumen(modalidad), indices)

    def cortes_mascara_batch(self, indices):
        """GT mask slices [N, H, W] float32."""
        return self._extraer(self.gt_mask, indices)

    def __repr__(self):
        return f"Paciente({self.id})"

    def __str__(self):
        return self.id


# ----- fold assignment (reference ``utils/utils.py:299-316``) -----

ALL_TRAIN_IDS = list(range(1, 54))  # P1..P53, the MSLesSeg train split


def calcular_fold(paciente_id: str, k_folds: int = 5) -> int:
    """Deterministic patient-level CV assignment: IDs 1..53 split into
    k consecutive chunks (np.array_split semantics)."""
    numero = int(paciente_id[1:])
    folds = np.array_split(np.array(ALL_TRAIN_IDS), k_folds)
    for i, fold in enumerate(folds, 1):
        if numero in fold:
            return i
    raise ValueError(f"No se puede calcular el fold del paciente {paciente_id}.")


def listar_pacientes(input_dir):
    """Sorted patient IDs in a directory (numeric order). Only directories
    matching ``P<n>`` count — stray files (caches, readmes) are ignored."""
    input_path = Path(input_dir)
    pacientes = [
        d.name
        for d in input_path.iterdir()
        if d.is_dir()
        and d.name.startswith("P")
        and d.name[1:].isdigit()
        and not _ignorable(d.name)
    ]
    if not pacientes:
        raise FileNotFoundError(f"No se encontraron pacientes en {input_dir}.")
    return sorted(pacientes, key=lambda p: int(p[1:]))


def _ignorable(name: str) -> bool:
    low = name.lower()
    return name.startswith(".") or name.startswith("~") or low.endswith(".tmp")
