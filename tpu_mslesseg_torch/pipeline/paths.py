"""Per-stage path managers: the on-disk experiment schema.

Port of ``tpu_mslesseg/pipeline/paths.py``: the classes and paths the fast
serving path (``pipeline/rapido.py``) reads. The stage chain's precondition
checks and scoped cleanups come with the stage chain. The one difference is
the weights file: the port's checkpoint is ``weights/best.pt``, a torch
state_dict file, where the JAX package keeps an Orbax directory
``best.ckpt``.

Mirrors the reference's Config classes (``configs/Config*.py``) and its
canonical directory scheme (SURVEY §1):

    datasets/<mejora>/<mods>_<n>c_<k>folds/fold<j>/P<i>/<plano>/{images,GT_masks,labels,pred_masks}
    trains/<mejora>/<mods>_<n>c_<k>folds_<e>epochs/<plano>/fold<j>/{weights/best.pt,results.csv}
    pred_vols/<mejora>/<mods>_<n>c_<k>folds_<e>epochs/fold<j>/P<i>/P<i>_<plano>.nii.gz
    results/<mejora>/<mods>_<n>c_<k>folds_<e>epochs/fold<j>/[P<i>/]..._results.json
    GT/{train,test}/P<i>/P<i>_MASK.nii.gz

Each stage config owns its path derivation — the filesystem doubles as the
pipeline's memo table (skip-if-exists resume). All paths are cwd-relative
like the reference's.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path

from tpu_mslesseg_torch.pipeline.modelo import Modelo
from tpu_mslesseg_torch.pipeline.paciente import Paciente, calcular_fold

PLANOS_ANATOMICOS = ("axial", "coronal", "sagital")


def construir_nombre_configuracion(modelo: Modelo, epochs: int) -> str:
    mods = "".join(modelo.modalidad)
    return f"{mods}_{modelo.num_cortes}c_{modelo.k_folds}folds_{epochs}epochs"


@dataclass
class ConfigBase:
    modelo: Modelo
    root: Path = field(default_factory=Path.cwd)

    @property
    def dataset_entrada(self) -> Path:
        return self.root / "MSLesSeg-Dataset" / "train"

    @property
    def gt_dir(self) -> Path:
        return self.root / "GT" / "train"


@dataclass
class ConfigTrain(ConfigBase):
    """Training-stage paths (reference ``configs/ConfigTrain.py``); the
    paths only, until training is ported."""

    epochs: int = 50
    fold_test: int = 1

    @property
    def output_dir(self) -> Path:
        return (
            self.root / "trains"
            / f"{self.modelo.base_path}_{self.epochs}epochs"
            / self.modelo.plano
        )

    @property
    def fold_dir(self) -> Path:
        return self.output_dir / f"fold{self.fold_test}"

    @property
    def weights_dir(self) -> Path:
        return self.fold_dir / "weights"

    @property
    def best_ckpt(self) -> Path:
        return self.weights_dir / "best.pt"


def existe_modelo_entrenado(modelo: Modelo, epochs: int, fold_test: int, root=None) -> bool:
    """Trained-weights check (reference ``utils.py:240-251``)."""
    root = Path(root) if root else Path.cwd()
    best = (
        root / "trains"
        / f"{modelo.base_path}_{epochs}epochs"
        / modelo.plano
        / f"fold{fold_test}"
        / "weights"
        / "best.pt"
    )
    return best.is_file()


@dataclass
class ConfigPred(ConfigBase):
    """Prediction-stage paths (reference ``configs/ConfigPred.py``)."""

    epochs: int = 50
    k_folds: int = 5
    fold_test: int | None = None
    paciente: Paciente | None = None

    def __post_init__(self):
        if self.paciente is not None and self.fold_test is None:
            self.fold_test = calcular_fold(self.paciente.id, self.k_folds)

    @property
    def es_paciente_individual(self) -> bool:
        return self.paciente is not None

    @property
    def model_dir(self) -> Path:
        return (
            self.root / "trains"
            / f"{self.modelo.base_path}_{self.epochs}epochs"
            / self.modelo.plano
            / f"fold{self.fold_test}"
        )

    @property
    def model_path(self) -> Path:
        return self.model_dir / "weights" / "best.pt"

    @property
    def dataset_fold_dir(self) -> Path:
        return self.root / "datasets" / self.modelo.base_path / f"fold{self.fold_test}"

    def paciente_dirs(self, paciente_id: str) -> dict:
        rootp = self.dataset_fold_dir / paciente_id / self.modelo.plano
        return {"images": rootp / "images", "pred_masks": rootp / "pred_masks"}

@dataclass
class ConfigConsenso(ConfigBase):
    """Consensus-stage paths (reference ``configs/ConfigConsenso.py``):
    plane is always 'consenso'; inputs are the three per-plane volumes."""

    epochs: int = 50
    k_folds: int = 5
    fold_test: int | None = None
    paciente: Paciente | None = None
    umbral: int = 2

    def __post_init__(self):
        if self.paciente is not None and self.fold_test is None:
            self.fold_test = calcular_fold(self.paciente.id, self.k_folds)

    @property
    def pred_vols_fold_dir(self) -> Path:
        return (
            self.root / "pred_vols"
            / f"{self.modelo.base_path}_{self.epochs}epochs"
            / f"fold{self.fold_test}"
        )

    def vol_paths(self, paciente_id: str) -> dict:
        d = self.pred_vols_fold_dir / paciente_id
        return {p: d / f"{paciente_id}_{p}.nii.gz" for p in PLANOS_ANATOMICOS}

    def consenso_path(self, paciente_id: str) -> Path:
        return self.pred_vols_fold_dir / paciente_id / f"{paciente_id}_consenso.nii.gz"

    def gt_path(self, paciente_id: str) -> Path:
        return self.gt_dir / paciente_id / f"{paciente_id}_MASK.nii.gz"

@dataclass
class ConfigEval(ConfigBase):
    """Evaluation-stage paths (reference ``configs/ConfigEval.py``):
    patient / fold / experiment modes + `plano_forzado` for consensus."""

    epochs: int = 50
    k_folds: int = 5
    fold_test: int | None = None
    paciente: Paciente | None = None
    plano_forzado: str | None = None

    def __post_init__(self):
        if self.paciente is not None and self.fold_test is None:
            self.fold_test = calcular_fold(self.paciente.id, self.k_folds)

    @property
    def plano(self) -> str:
        return self.plano_forzado or self.modelo.plano

    @property
    def config_dir(self) -> Path:
        return self.root / "results" / f"{self.modelo.base_path}_{self.epochs}epochs"

    @property
    def results_fold_dir(self) -> Path:
        return self.config_dir / f"fold{self.fold_test}"

    @property
    def results_fold_json(self) -> Path:
        return self.results_fold_dir / f"fold{self.fold_test}_{self.plano}_results.json"

    @property
    def global_json(self) -> Path:
        return self.config_dir / f"global_{self.plano}_results.json"

    @property
    def pred_vols_fold_dir(self) -> Path:
        return (
            self.root / "pred_vols"
            / f"{self.modelo.base_path}_{self.epochs}epochs"
            / f"fold{self.fold_test}"
        )

    def paths_paciente(self, paciente_id: str) -> dict:
        return {
            "pred_vol": self.pred_vols_fold_dir / paciente_id
            / f"{paciente_id}_{self.plano}.nii.gz",
            "gt_vol": self.gt_dir / paciente_id / f"{paciente_id}_MASK.nii.gz",
            "results_json": self.results_fold_dir / paciente_id
            / f"{paciente_id}_{self.plano}_results.json",
        }

    def fold_jsons(self) -> list:
        return [
            self.config_dir / f"fold{k}" / f"fold{k}_{self.plano}_results.json"
            for k in range(1, self.modelo.k_folds + 1)
        ]
