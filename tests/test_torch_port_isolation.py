"""The PyTorch port stands alone: no JAX, and no GPU result without a GPU."""

import json
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import tpu_mslesseg_torch
from torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]


def _port_modules():
    return sorted(
        m.name
        for m in pkgutil.walk_packages(tpu_mslesseg_torch.__path__, "tpu_mslesseg_torch.")
    )


def test_importing_every_port_module_leaves_jax_out():
    mods = _port_modules()
    for name in ("infer.consensus3", "pipeline.rapido", "pipeline.paths", "io.nifti",
                 "train.checkpoint", "model.stem", "preproc.clahe", "io.png",
                 "pipeline.ejecutar_pipeline", "pipeline.stages.extraer_dataset",
                 "pipeline.stages.reconstruir_volumen", "pipeline.stages.promediar_folds",
                 "viz.overlay", "viz.gif", "viz.figure", "extras.analizar_pacientes_dsc",
                 "extras.componer_resultados", "demo.ejecutar_demo", "demo.entrenar_capacidad",
                 "io.native"):
        assert f"tpu_mslesseg_torch.{name}" in mods, name
    code = (
        "import importlib, json, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "print(json.dumps(sorted(k for k in sys.modules "
        "if k == 'jax' or k.startswith(('jax.', 'tpu_mslesseg.', 'flax')) "
        "or k == 'tpu_mslesseg' or k.split('.')[0] in ('pandas', 'imageio', 'matplotlib'))))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
        timeout=120, check=True,
    )
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


TRAIN_MODULES = ("train.assigner", "train.losses", "train.trainer", "train.checkpoint",
                 "tools.train_batches", "model.blocks", "model.bridge", "model.yolo11",
                 "train.data", "train.augment", "train.validate", "train.engine",
                 "train.autobatch", "evalx.seg_map", "io.torch_pt", "model.import_pt",
                 "pipeline.yaml_out", "pipeline.stages.train", "train.fold_parallel",
                 "train.engine_parallel", "core.distributed", "core.mesh", "train.plots")


def test_the_training_modules_load_no_other_framework():
    """The training modules import torch, numpy and scipy: no jax, flax,
    optax or ml_dtypes, nothing of the JAX package, and no PyYAML (the card's
    machine lists none: the port writes its YAML itself); matplotlib only
    when a figure is drawn (``train/plots.py`` imports it lazily)."""
    mods = _port_modules()
    for name in TRAIN_MODULES:
        assert f"tpu_mslesseg_torch.{name}" in mods, name
    code = (
        "import importlib, json, sys\n"
        f"for m in {TRAIN_MODULES!r}: importlib.import_module('tpu_mslesseg_torch.' + m)\n"
        "print(json.dumps(sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'ml_dtypes', 'yaml', 'tpu_mslesseg', "
        "'matplotlib'))))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
        timeout=120, check=True,
    )
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
    for name in TRAIN_MODULES:
        path = Path(tpu_mslesseg_torch.__path__[0]) / (name.replace(".", "/") + ".py")
        for line in path.read_text().splitlines():
            assert not line.strip().startswith(
                ("import flax", "from flax", "import optax", "from optax", "import yaml",
                 "import ml_dtypes")), (path, line)


def test_the_training_entry_points_default_to_the_card():
    import inspect

    from tpu_mslesseg_torch.core import distributed
    from tpu_mslesseg_torch.demo import entrenar_capacidad
    from tpu_mslesseg_torch.pipeline.stages import train as stage
    from tpu_mslesseg_torch.train import (
        autobatch, data, engine, engine_parallel, fold_parallel, trainer, validate,
    )

    for fn in (engine.train_fold, stage.ejecutar_flujo_train, stage.ejecutar_train_pipeline,
               autobatch.auto_batch_size, validate.run_validation, data.build_dataset,
               trainer.init_train_state, stage.ejecutar_train_paralelo,
               engine_parallel.train_folds_parallel, fold_parallel.init_fold_state,
               fold_parallel.init_multi_fold_state, distributed.maybe_initialize,
               entrenar_capacidad.ejecutar_capacidad, entrenar_capacidad.evaluar_capacidad):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn.__name__


CLIS = ("pipeline.ejecutar_pipeline", "pipeline.stages.setup", "pipeline.stages.extraer_dataset",
        "pipeline.stages.generar_predicciones", "pipeline.stages.reconstruir_volumen",
        "pipeline.stages.generar_consenso", "pipeline.stages.eval",
        "pipeline.stages.promediar_folds", "pipeline.stages.train", "viz.gif", "viz.figure",
        "extras.analizar_pacientes_dsc", "extras.componer_resultados", "demo.ejecutar_demo",
        "demo.entrenar_capacidad")
# the CLIs of the viz, the extras and the demo, which take neither flag
NO_SLICE_FLAGS = ("pipeline.stages.setup", "extras.analizar_pacientes_dsc",
                  "extras.componer_resultados", "demo.ejecutar_demo", "demo.entrenar_capacidad")


@pytest.fixture(scope="module")
def cli_help():
    """``python -m <cli> --help`` for every CLI of the port, in one process:
    each one's help text and exit code, and the foreign modules loaded."""
    code = (
        "import contextlib, io, json, runpy, sys\n"
        "out = {}\n"
        f"for m in {CLIS!r}:\n"
        "    sys.argv = [m, '--help']\n"
        "    buf = io.StringIO()\n"
        "    try:\n"
        "        with contextlib.redirect_stdout(buf):\n"
        "            runpy.run_module('tpu_mslesseg_torch.' + m, run_name='__main__')\n"
        "        rc = 'returned'\n"
        "    except SystemExit as e:\n"
        "        rc = e.code\n"
        "    out[m] = [rc, buf.getvalue()]\n"
        "out['foreign'] = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'flax', 'tpu_mslesseg', 'PIL', 'cv2', 'nibabel', 'pandas', 'imageio', "
        "'matplotlib'))\n"
        "print(json.dumps(out))\n"
    )
    run = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
        timeout=120, check=True,
    )
    return json.loads(run.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("cli", CLIS)
def test_every_cli_prints_its_help_and_loads_nothing_foreign(cli_help, cli):
    rc, text = cli_help[cli]
    assert rc == 0 and "usage:" in text
    if cli not in NO_SLICE_FLAGS:
        assert "--num_cortes" in text and "--mejora" in text
    assert "--device" not in text  # the flag vocabulary is the reference's
    assert cli_help["foreign"] == []


def test_port_sources_never_name_jax():
    for path in Path(tpu_mslesseg_torch.__path__[0]).rglob("*.py"):
        for line in path.read_text().splitlines():
            s = line.strip()
            assert not s.startswith(("import jax", "from jax")), (path, line)
            assert not s.startswith(("import tpu_mslesseg ", "from tpu_mslesseg.")), (path, line)
            assert not s.startswith(("import PIL", "from PIL", "import cv2", "import nibabel",
                                     "from nibabel", "import pandas", "from pandas")), (path, line)
            # imageio and matplotlib only inside the function that writes
            if s.startswith(("import imageio", "import matplotlib", "from matplotlib")):
                assert line.startswith("    "), (path, line)


def _run_smoke(cwd):
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    return subprocess.run(
        [sys.executable, str(cwd / "chip_smoke.py")], cwd=cwd, capture_output=True,
        text=True, timeout=120, env=env,
    )


def test_chip_smoke_fails_without_a_cuda_device():
    if torch.cuda.is_available():
        pytest.skip("this box has a CUDA device")
    out = _run_smoke(ROOT)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_chip_smoke_fails_outside_a_checkout(tmp_path):
    (tmp_path / "chip_smoke.py").write_text((ROOT / "chip_smoke.py").read_text())
    out = _run_smoke(tmp_path)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
