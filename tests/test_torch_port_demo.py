"""The port's demo (``demo/ejecutar_demo.py``), capacity mode
(``demo/entrenar_capacidad.py``) and ``configure_logging_demo`` against the
JAX package's.

The demo patients P18 and P39 (folds 2 and 4 of 5) as 24x28x24 synthetic
volumes from ``test_torch_port_stages.write_dataset`` (a numpy seed). No JAX
training runs here:

* the log swap and the argv each demo case gives the CLI, both packages'
  ``main`` captured;
* one demo case through the port alone on the CPU (imgsz 64, float32, one
  epoch, the orchestrator wrapped as ``test_torch_port_orchestrator`` does):
  trained fold, stage-3 PNGs, GIF and figure; the JAX package's GIF and
  figure over the same tree give the same bytes and the same slice; a viz
  failure is one warning;
* the capacity mode's evaluation tail on weights bridged from the JAX
  model against the JAX package's lines (``demo/entrenar_capacidad.py``
  :110-127) at imgsz 96; a two-epoch CPU run at imgsz 64; ``main`` without
  a CUDA device.

Tolerance: none (argv, GIF bytes, volumes and metrics compared exactly).
"""

import functools
import importlib.util
import logging
import math
import os
import shutil
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from test_torch_port_stages import plane_variables, write_dataset
from tpu_mslesseg.evalx import metrics as jmx
from tpu_mslesseg.infer.predictor import SlicePredictor as JSlicePredictor
from tpu_mslesseg.infer.reconstruct import reconstruct_volume as jreconstruct
from tpu_mslesseg.pipeline import ejecutar_pipeline as jorch
from tpu_mslesseg.pipeline import logging_setup as jlog
from tpu_mslesseg.pipeline.modelo import Modelo as JModelo
from tpu_mslesseg.pipeline.paciente import Paciente as JPaciente
from tpu_mslesseg.preproc import enhance as jenh
from tpu_mslesseg.viz import figure as jfig
from tpu_mslesseg.viz import gif as jgif
from tpu_mslesseg_torch.demo import ejecutar_demo as tdemo
from tpu_mslesseg_torch.demo import entrenar_capacidad as tcap
from tpu_mslesseg_torch.model.bridge import state_dict_from_reference
from tpu_mslesseg_torch.pipeline import ejecutar_pipeline as torch_orch
from tpu_mslesseg_torch.pipeline import logging_setup as tlog
from tpu_mslesseg_torch.pipeline.modelo import Modelo as TModelo
from tpu_mslesseg_torch.train.checkpoint import load_checkpoint
from tpu_mslesseg_torch.train.trainer import TrainConfig
from tpu_mslesseg_torch.viz import figure as tfig
from tpu_mslesseg_torch.viz import gif as tgif

ROOT = Path(__file__).resolve().parents[1]
DEMO_PIDS = ("P18", "P39")
SERVE_ENV = {"TPU_MSLESSEG_IMGSZ": "64", "TPU_MSLESSEG_DTYPE": "float32"}
CASE = {"paciente_id": "P39", "mejora": "GC"}
DEMO_MODELO = dict(plano="axial", num_cortes="P50", modalidad=["FLAIR"], k_folds=5)
METRIC_KEYS = {"DSC", "AUC", "Precision", "Recall"}


def _jax_demo():
    spec = importlib.util.spec_from_file_location("jax_ejecutar_demo",
                                                  ROOT / "demo" / "ejecutar_demo.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("demo_inputs")
    write_dataset(root, pids=DEMO_PIDS)
    return root


# --------------------------------------------------------------------------
# the log swap, the CLI's argv, main
# --------------------------------------------------------------------------


def test_configure_logging_demo_swaps_the_same_handlers(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    seen = {}
    try:
        for name, mod in (("jax", jlog), ("port", tlog)):
            mod.configure_logging(log_file="pipeline.log")
            mod.configure_logging_demo()
            seen[name] = [(type(h).__name__, Path(getattr(h, "baseFilename", "-")).name,
                           type(h.formatter).__name__, h.level)
                          for h in logging.getLogger().handlers]
    finally:
        tlog.configure_logging(log_file=None)
    assert seen["port"] == seen["jax"]
    assert [h[1] for h in seen["port"]] == ["-", "demo.log"]
    assert (tmp_path / "demo.log").is_file()


@pytest.mark.parametrize("entrenar", [False, True])
def test_each_demo_case_gives_the_cli_the_jax_packages_argv(monkeypatch, tmp_path, entrenar):
    """Both packages' ``main`` captured: nothing trains or serves, and the
    viz that follows finds no prediction (its one warning)."""
    monkeypatch.chdir(tmp_path)
    argv = {"jax": [], "port": []}
    monkeypatch.setattr(jorch, "main", lambda a: argv["jax"].append(list(a)))
    monkeypatch.setattr(torch_orch, "main", lambda a: argv["port"].append(list(a)))
    jdemo = _jax_demo()
    assert tdemo.DEMO_CASES == jdemo.DEMO_CASES
    for case in tdemo.DEMO_CASES:
        jdemo.ejecutar_demo_paciente(case["paciente_id"], case["mejora"], entrenar, 7)
        tdemo.ejecutar_demo_paciente(case["paciente_id"], case["mejora"], entrenar, 7)
    assert argv["port"] == argv["jax"] and len(argv["port"]) == 2
    assert ("--entrenar" in argv["port"][0]) == entrenar
    assert not list(tmp_path.iterdir())


def test_main_runs_both_cases_from_the_repositorys_demo_folder(monkeypatch, tmp_path):
    assert tdemo.DEMO_DIR == ROOT / "demo"
    calls = []
    monkeypatch.setattr(tdemo, "DEMO_DIR", tmp_path)
    monkeypatch.setattr(tdemo, "ejecutar_demo_paciente",
                        lambda *a: calls.append((Path.cwd(), *a)))
    monkeypatch.chdir(ROOT)
    try:
        tdemo.main(["--entrenar", "--epochs", "3"])
    finally:
        tlog.configure_logging(log_file=None)
    assert calls == [(tmp_path, "P39", "GC", True, 3), (tmp_path, "P18", "HE", True, 3)]
    assert (tmp_path / "demo.log").is_file()


# --------------------------------------------------------------------------
# one demo case through the port on the CPU
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def demo_run(dataset, tmp_path_factory):
    """P39/GC through ``ejecutar_demo_paciente(..., entrenar=True, epochs=1)``:
    the CLI's patient mode trains fold 4 on P18, serves P39 through the stage
    chain and the viz writes its GIF and figure."""
    root = tmp_path_factory.mktemp("demo_run") / "demo"
    shutil.copytree(dataset, root)
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    mp = pytest.MonkeyPatch()
    mp.setattr(torch_orch, "ejecutar_pipeline", functools.partial(
        torch_orch.ejecutar_pipeline, device="cpu",
        train_cfg=TrainConfig(epochs=1, batch_size=4, imgsz=64, amp=False)))
    for k, v in SERVE_ENV.items():
        mp.setenv(k, v)
    mp.chdir(root)
    try:
        tdemo.ejecutar_demo_paciente(CASE["paciente_id"], CASE["mejora"], True, 1)
        log = (root / "pipeline.log").read_text()
    finally:
        mp.undo()
        torch.set_num_threads(n_threads)
        tlog.configure_logging(log_file=None)
    return root, log


def test_the_demo_trains_serves_and_draws_one_case(demo_run):
    root, log = demo_run
    assert "Error en el pipeline" not in log and "Pipeline completado" in log
    modelo = TModelo(mejora=CASE["mejora"], **DEMO_MODELO)
    fold = root / "trains" / f"{modelo.base_path}_1epochs" / "axial" / "fold4"
    assert {p.name for p in (fold / "weights").iterdir()} == {"best.pt", "last.pt",
                                                              "fitness.json"}
    assert (fold / "results.csv").is_file() and (fold / "args.yaml").is_file()
    assert not (root / "trains" / f"{modelo.base_path}_1epochs" / "axial" / "fold2").exists()
    base = tgif.prediction_dir(modelo, "P39", root)
    preds = sorted((base / "pred_masks").glob("*.png"))
    assert preds
    vol = root / "pred_vols" / f"{modelo.base_path}_1epochs" / "fold4" / "P39" / "P39_axial.nii.gz"
    assert vol.is_file()
    assert (root / "results" / f"{modelo.base_path}_1epochs" / "fold4" / "P39"
            / "P39_axial_results.json").is_file()
    frames, _, gif_path = tgif.preparar_gif(modelo, "P39", 1, root=root)
    assert gif_path.is_file() and len(frames) == len(preds)
    idx, _, _ = tfig.seleccionar_mejor_corte(tgif.collect_slices(base, "P39", "FLAIR"))
    assert (gif_path.parent / f"P39_FLAIR_{idx}.png").is_file()
    assert load_checkpoint(fold / "weights" / "best.pt")


def test_the_jax_viz_over_the_ports_demo_tree_gives_the_same_gif_and_slice(demo_run):
    root, _ = demo_run
    tmod = TModelo(mejora=CASE["mejora"], **DEMO_MODELO)
    jmod = JModelo(mejora=CASE["mejora"], **DEMO_MODELO)
    _, _, gif_path = tgif.preparar_gif(tmod, "P39", 1, root=root)
    port_gif = gif_path.read_bytes()
    assert jgif.generar_gif(jmod, "P39", 1, root=root) == gif_path
    assert gif_path.read_bytes() == port_gif
    base = tgif.prediction_dir(tmod, "P39", root)
    triplets = tgif.collect_slices(base, "P39", "FLAIR")
    assert tfig.seleccionar_mejor_corte(triplets)[:2] == jfig.seleccionar_mejor_corte(triplets)[:2]
    assert jfig.generar_figura(jmod, "P39", 1, root=root).name == \
        tfig.generar_figura(tmod, "P39", 1, root=root).name


def test_a_viz_failure_is_one_warning(demo_run, monkeypatch, caplog):
    """imageio hidden after a real run: the GIF raises, the figure is not
    tried, and the case logs the reference's one warning."""
    root, _ = demo_run
    monkeypatch.chdir(root)
    monkeypatch.setattr(torch_orch, "main", lambda argv: None)
    for name in [m for m in sys.modules if m == "imageio" or m.startswith("imageio.")]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "imageio", None)
    before = {p: p.stat().st_mtime_ns for p in (root / "visualizaciones").rglob("*") if p.is_file()}
    with caplog.at_level(logging.WARNING):
        tdemo.ejecutar_demo_paciente(CASE["paciente_id"], CASE["mejora"], True, 1)
    warned = [r.getMessage() for r in caplog.records if r.levelno == logging.WARNING]
    assert len(warned) == 1 and "Visualización no generada" in warned[0]
    after = {p: p.stat().st_mtime_ns for p in (root / "visualizaciones").rglob("*") if p.is_file()}
    assert after == before


# --------------------------------------------------------------------------
# capacity mode
# --------------------------------------------------------------------------


def test_the_capacity_evaluation_equals_the_jax_packages_lines(dataset):
    """The reference's lines :110-127 with the JAX modules, and the port's
    `evaluar_capacidad`, on the same patient and bridged weights at 96."""
    jmodel, tmodel, jvars = plane_variables()
    v = jvars["axial"]
    ds = dataset / "MSLesSeg-Dataset" / "train"
    # the JAX package's lines, as entrenar_capacidad.py runs them
    p = JPaciente(id="P39", plano="axial", modalidad=["FLAIR"], dataset_dir=ds)
    idx = p.indices_a_usar(50)
    imgs = np.asarray(jenh.enhance_for_model(p.cortes_imagen_batch(idx, "FLAIR"), "GC"))
    pred = JSlicePredictor(jmodel, v, slice_hw=imgs.shape[1:], imgsz=96)
    masks = np.asarray(pred(imgs))
    want_vol = np.asarray(jreconstruct(p.gt_mask.shape, masks, "axial", idx))
    want = jmx.compute_metrics(p.gt_mask, want_vol)
    with torch.no_grad():
        vol, got = tcap.evaluar_capacidad(tmodel, state_dict_from_reference(v, tmodel), "P39",
                                          "GC", ds, imgsz=96, device="cpu")
    np.testing.assert_array_equal(vol.numpy(), want_vol)
    assert got == want and set(got) == METRIC_KEYS
    assert 0 < want_vol.sum() < want_vol.size  # the masks are mixed
    jax.clear_caches()


@pytest.mark.usefixtures("one_torch_thread")
def test_a_two_epoch_capacity_run_on_the_cpu(dataset, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    try:
        res = tcap.ejecutar_capacidad(dataset / "MSLesSeg-Dataset" / "train", mejora="GC",
                                      epochs=2, batch=4, amp=False, paciente_eval="P39",
                                      imgsz=64, device="cpu")
    finally:
        tlog.configure_logging(log_file=None)
    assert len(res["perdidas"]) == 2
    assert all(math.isfinite(v) and v >= 0 for e in res["perdidas"] for v in e.values())
    assert res["paso_ms"] is not None and res["paso_ms"] > 0
    best = tmp_path / "trains_capacidad" / "GC" / "weights" / "best.pt"
    assert res["pesos"] == str(best.relative_to(tmp_path)) and best.is_file()
    sd = load_checkpoint(best)
    assert all(torch.isfinite(t).all() for t in sd.values() if t.is_floating_point())
    met = res["metricas"]
    assert set(met) == set(jmx.compute_metrics(np.ones((2, 2, 2)), np.ones((2, 2, 2)))) \
        == METRIC_KEYS
    assert all(math.isfinite(v) for v in met.values())


def test_capacity_main_without_a_cuda_device_fails_and_trains_nothing(dataset, tmp_path,
                                                                       monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("this box has a CUDA device")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="no disponible"):
        tcap.main(["--epochs", "1", "--dataset", str(dataset / "MSLesSeg-Dataset" / "train")])
    assert not os.listdir(tmp_path)
