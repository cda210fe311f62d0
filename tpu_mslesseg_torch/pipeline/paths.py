"""Per-stage path managers: the on-disk experiment schema.

Port of ``tpu_mslesseg/pipeline/paths.py``. The one difference is the
weights file: the port's checkpoint is ``weights/best.pt``, a torch
state_dict file, where the JAX package keeps an Orbax directory
``best.ckpt``.

Mirrors the reference's Config classes (``configs/Config*.py``) and its
canonical directory scheme (SURVEY §1):

    datasets/<mejora>/<mods>_<n>c_<k>folds/fold<j>/P<i>/<plano>/{images,GT_masks,labels,pred_masks}
    trains/<mejora>/<mods>_<n>c_<k>folds_<e>epochs/<plano>/fold<j>/{weights/{best,last}.pt,results.csv,args.yaml}
    pred_vols/<mejora>/<mods>_<n>c_<k>folds_<e>epochs/fold<j>/P<i>/P<i>_<plano>.nii.gz
    results/<mejora>/<mods>_<n>c_<k>folds_<e>epochs/fold<j>/[P<i>/]..._results.json
    GT/{train,test}/P<i>/P<i>_MASK.nii.gz

Each stage config owns path derivation, precondition verification
(`verificar_paths`) and scoped cleanup (`limpiar_*`) — the filesystem
doubles as the pipeline's memo table (skip-if-exists resume).
All paths are cwd-relative like the reference's.
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


def eliminar_directorio(path):
    import shutil

    p = Path(path)
    if p.exists() and p.is_dir():
        shutil.rmtree(p)


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
class ConfigDataset(ConfigBase):
    """Extraction-stage paths (reference ``configs/ConfigDataset.py``)."""

    k_folds: int = 5
    paciente: Paciente | None = None
    completo: bool = False

    @property
    def output_dir(self) -> Path:
        return self.root / "datasets" / self.modelo.base_path

    @property
    def es_paciente_individual(self) -> bool:
        return self.paciente is not None

    def paciente_root(self, paciente_id: str, plano: str | None = None) -> Path:
        fold = calcular_fold(paciente_id, self.k_folds)
        return (
            self.output_dir / f"fold{fold}" / paciente_id / (plano or self.modelo.plano)
        )

    def paths_paciente_dirs(self, paciente_id: str) -> dict:
        rootp = self.paciente_root(paciente_id)
        return {
            "images": rootp / "images",
            "GT_masks": rootp / "GT_masks",
            "labels": rootp / "labels",
        }

    @property
    def paciente_dir(self) -> dict:
        return self.paths_paciente_dirs(self.paciente.id)

    def verificar_paths(self):
        if not self.dataset_entrada.is_dir():
            raise FileNotFoundError(
                f"Dataset de entrada no encontrado: {self.dataset_entrada}. "
                "Ejecuta primero la etapa de setup."
            )
        if self.es_paciente_individual:
            for d in self.paciente_dir.values():
                d.mkdir(parents=True, exist_ok=True)

    def limpiar_dataset(self):
        """Plane-scoped cleanup: removes this plane's dirs for all patients."""
        base = self.output_dir
        if not base.exists():
            return
        for fold_dir in base.glob("fold*"):
            for pac_dir in fold_dir.iterdir():
                plane_dir = pac_dir / self.modelo.plano
                eliminar_directorio(plane_dir)


@dataclass
class ConfigTrain(ConfigBase):
    """Training-stage paths (reference ``configs/ConfigTrain.py``)."""

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

    def verificar_paths(self):
        if not self.dataset_entrada.is_dir():
            raise FileNotFoundError(
                f"Dataset de entrada no encontrado: {self.dataset_entrada}."
            )
        self.fold_dir.mkdir(parents=True, exist_ok=True)

    def limpiar_entrenamiento(self):
        eliminar_directorio(self.fold_dir)


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

    def verificar_paths(self):
        if not self.model_path.is_file():
            raise FileNotFoundError(
                f"No se encontró el modelo entrenado en {self.model_path}."
            )

    def limpiar_predicciones(self):
        if not self.dataset_fold_dir.exists():
            return
        for pac_dir in self.dataset_fold_dir.iterdir():
            eliminar_directorio(pac_dir / self.modelo.plano / "pred_masks")


@dataclass
class ConfigRecVol(ConfigBase):
    """Reconstruction-stage paths (reference ``configs/ConfigRecVol.py``)."""

    epochs: int = 50
    k_folds: int = 5
    fold_test: int | None = None
    paciente: Paciente | None = None

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

    def vol_path(self, paciente_id: str, plano: str | None = None) -> Path:
        plano = plano or self.modelo.plano
        return self.pred_vols_fold_dir / paciente_id / f"{paciente_id}_{plano}.nii.gz"

    def gt_path(self, paciente_id: str) -> Path:
        return self.gt_dir / paciente_id / f"{paciente_id}_MASK.nii.gz"

    def pred_masks_dir(self, paciente_id: str) -> Path:
        return (
            self.root / "datasets" / self.modelo.base_path
            / f"fold{self.fold_test}" / paciente_id / self.modelo.plano / "pred_masks"
        )

    def verificar_paths(self):
        if not self.gt_dir.is_dir():
            raise FileNotFoundError(f"GT no encontrado: {self.gt_dir}.")
        self.pred_vols_fold_dir.mkdir(parents=True, exist_ok=True)

    def limpiar_reconstrucciones(self):
        if not self.pred_vols_fold_dir.exists():
            return
        for pac_dir in self.pred_vols_fold_dir.iterdir():
            vol = pac_dir / f"{pac_dir.name}_{self.modelo.plano}.nii.gz"
            if vol.exists():
                vol.unlink()


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

    def verificar_paths(self):
        if not self.pred_vols_fold_dir.is_dir():
            raise FileNotFoundError(
                f"No hay volúmenes predichos en {self.pred_vols_fold_dir}."
            )

    def limpiar_consenso(self):
        if not self.pred_vols_fold_dir.exists():
            return
        for pac_dir in self.pred_vols_fold_dir.iterdir():
            c = pac_dir / f"{pac_dir.name}_consenso.nii.gz"
            if c.exists():
                c.unlink()


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

    def verificar_paths(self):
        """Mode-dependent precondition checks (reference
        ``ConfigEval.py:401-424``): patient mode verifies that patient's
        GT + predicted volume; fold mode verifies them for every patient
        of the fold; experiment mode (fold_test None, no paciente)
        requires all k fold JSONs before averaging — each raising the
        same early FileNotFoundError the reference does."""
        if self.paciente is not None:
            p = self.paths_paciente(self.paciente.id)
            if not p["gt_vol"].exists():
                raise FileNotFoundError(
                    f"No existe la GT del paciente {self.paciente.id}: "
                    f"{p['gt_vol']}."
                )
            if not p["pred_vol"].exists():
                raise FileNotFoundError(
                    f"No existe la predicción del paciente "
                    f"{self.paciente.id}: {p['pred_vol']}."
                )
            p["results_json"].parent.mkdir(parents=True, exist_ok=True)
        elif self.fold_test is not None:
            # a fold dir may legitimately not exist yet (warn-and-skip
            # contract downstream); patients that ARE present must have
            # consistent GT + prediction volumes, raised early like the
            # reference's per-patient loop
            if self.pred_vols_fold_dir.exists():
                for pac_dir in sorted(self.pred_vols_fold_dir.iterdir()):
                    if not pac_dir.is_dir():
                        continue
                    p = self.paths_paciente(pac_dir.name)
                    if not p["gt_vol"].exists():
                        raise FileNotFoundError(
                            f"No existe el volumen ground truth del paciente "
                            f"{pac_dir.name}: {p['gt_vol']}."
                        )
                    if not p["pred_vol"].exists():
                        raise FileNotFoundError(
                            f"No existe la predicción del paciente "
                            f"{pac_dir.name}: {p['pred_vol']}."
                        )
                    p["results_json"].parent.mkdir(parents=True, exist_ok=True)
            self.results_fold_dir.mkdir(parents=True, exist_ok=True)
        else:
            self.verificar_paths_experimento()

    def verificar_paths_experimento(self):
        """Experiment-mode precondition: every fold's results JSON must
        exist before averaging (reference ``ConfigEval.py:370-399``)."""
        faltantes = [
            f"fold{k}" for k, j in enumerate(self.fold_jsons(), start=1)
            if not j.exists()
        ]
        if faltantes:
            raise FileNotFoundError(
                f"❌ No existen los JSON de resultados para los "
                f"siguientes folds: {faltantes}"
            )

    def limpiar_resultados(self):
        if not self.results_fold_dir.exists():
            return
        for f in self.results_fold_dir.rglob(f"*_{self.plano}_results.json"):
            f.unlink()
