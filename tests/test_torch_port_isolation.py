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

ROOT = Path(__file__).resolve().parents[1]


def _port_modules():
    return sorted(
        m.name
        for m in pkgutil.walk_packages(tpu_mslesseg_torch.__path__, "tpu_mslesseg_torch.")
    )


def test_importing_every_port_module_leaves_jax_out():
    mods = _port_modules()
    for name in ("infer.consensus3", "pipeline.rapido", "pipeline.paths", "io.nifti",
                 "train.checkpoint", "model.stem", "preproc.clahe"):
        assert f"tpu_mslesseg_torch.{name}" in mods, name
    code = (
        "import importlib, json, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "print(json.dumps(sorted(k for k in sys.modules "
        "if k == 'jax' or k.startswith(('jax.', 'tpu_mslesseg.', 'flax')) "
        "or k == 'tpu_mslesseg')))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
        timeout=120, check=True,
    )
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_port_sources_never_name_jax():
    for path in Path(tpu_mslesseg_torch.__path__[0]).rglob("*.py"):
        for line in path.read_text().splitlines():
            s = line.strip()
            assert not s.startswith(("import jax", "from jax")), (path, line)
            assert not s.startswith(("import tpu_mslesseg ", "from tpu_mslesseg.")), (path, line)


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
