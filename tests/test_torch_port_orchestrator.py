"""The port's orchestrator (``pipeline/ejecutar_pipeline.py``) on the CPU.

The tree is ``test_torch_port_stages``'s: volumes 24x28x24, ``k_folds=2``,
P1 and P2 in fold 1 and P30 in fold 2, FLAIR under ``--mejora CLAHE``,
6 slices a patient, imgsz 96, float32, one set of bridged weights a plane
and ``best.pt`` checkpoints for 3 planes x 2 folds.

* full mode, ``rapido=False``: three planes in turn build the whole
  artifact tree, the consensus waits for the third plane, a second run
  writes nothing;
* full mode, ``rapido=True`` from the same inputs: the same volumes and
  JSONs, and no prediction PNGs;
* patient mode for one plane against the JAX orchestrator's patient mode
  (the JAX three-plane run is in that package's slow set), and against the
  port's own ``rapido`` patient mode;
* stage 2: a trained fold skips, an untrained fold warns without
  ``--entrenar``; with it, the CLI trains all folds at once and serves
  them; ``main`` exits 1 without a CUDA
  device; the flag vocabulary and the ``--rapido`` default equal the JAX
  package's.

Tolerance: none (PNGs, volumes, JSONs compared exactly).
"""

import functools
import json
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_port_stages import (
    EPOCHS, K_FOLDS, NUM_CORTES, PIDS, PLANES, SHAPE, Env, TModelo, JModelo,
    assert_json_files_equal, assert_volumes_equal, modelo, plane_variables, stamps,
    tree_files, write_checkpoints, write_dataset,
)
from tpu_mslesseg.pipeline import ejecutar_pipeline as jorch
from tpu_mslesseg.pipeline import paciente as jpac
from tpu_mslesseg_torch.core import profiling as tprof
from tpu_mslesseg_torch.io import nifti as tnifti
from tpu_mslesseg_torch.io import png as tpng
from tpu_mslesseg_torch.pipeline import ejecutar_pipeline as torch_orch
from tpu_mslesseg_torch.pipeline import logging_setup as tlog
from tpu_mslesseg_torch.pipeline import paciente as tpac

CASE = "clahe"
FOLD_OF = {"P1": 1, "P2": 1, "P30": 2}
ARTIFACTS = ("datasets", "pred_vols", "results")


def _base(kind, plano="axial"):
    return Path(kind) / f"{modelo(TModelo, plano, CASE).base_path}_{EPOCHS}epochs"


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """Dataset, GT and checkpoints (the Orbax one for axial fold 2 only:
    the JAX package serves P30 in patient mode)."""
    src = tmp_path_factory.mktemp("orch_inputs")
    _, tmodel, jvars = plane_variables()
    write_dataset(src)
    write_checkpoints(src, CASE, jvars, tmodel, jax_planes_folds={("axial", 2)})
    return src


@pytest.fixture(scope="module")
def chain_tree(inputs, tmp_path_factory):
    """Three planes through the chain, plane by plane; after each plane,
    the consensus volumes on disk."""
    root = tmp_path_factory.mktemp("orch_chain") / "exp"
    shutil.copytree(inputs, root)
    consensus_after, timings = {}, {}
    with Env(cwd=root):
        for plano in PLANES:
            tprof.reset_timings()
            torch_orch.ejecutar_pipeline(
                modelo(TModelo, plano, CASE), epochs=EPOCHS, rapido=False, device="cpu")
            timings[plano] = tprof.timings_summary()
            consensus_after[plano] = [
                f for f in tree_files(root, "pred_vols") if "consenso" in f.name]
    return {"root": root, "consensus_after": consensus_after, "timings": timings}


def test_chain_builds_the_whole_tree_and_gates_the_consensus(chain_tree):
    root = chain_tree["root"]
    # the consensus waits until the third plane's volumes exist
    assert chain_tree["consensus_after"]["axial"] == []
    assert chain_tree["consensus_after"]["coronal"] == []
    assert len(chain_tree["consensus_after"]["sagital"]) == len(PIDS)
    for pid, k in FOLD_OF.items():
        for plano in PLANES:
            d = root / "datasets" / modelo(TModelo, plano, CASE).base_path / f"fold{k}" / pid / plano
            counts = {sub: len(list((d / sub).iterdir()))
                      for sub in ("images", "GT_masks", "labels", "pred_masks")}
            assert counts == dict.fromkeys(counts, NUM_CORTES), (pid, plano, counts)
            vol = tnifti.load(root / _base("pred_vols") / f"fold{k}" / pid / f"{pid}_{plano}.nii.gz")
            assert vol.shape == SHAPE and 0 < vol.data.mean() < 1
        cons = tnifti.load(root / _base("pred_vols") / f"fold{k}" / pid / f"{pid}_consenso.nii.gz")
        assert cons.shape == SHAPE and cons.data.dtype == np.uint8 and cons.data.any()
        for plano in (*PLANES, "consenso"):
            pj = root / _base("results") / f"fold{k}" / pid / f"{pid}_{plano}_results.json"
            assert set(json.loads(pj.read_text())) == {"DSC", "AUC", "Precision", "Recall"}
    for plano in (*PLANES, "consenso"):
        for k in (1, 2):
            fj = root / _base("results") / f"fold{k}" / f"fold{k}_{plano}_results.json"
            assert set(json.loads(fj.read_text())["DSC"]) == {"media", "std"}
        g = json.loads((root / _base("results") / f"global_{plano}_results.json").read_text())
        assert set(g) == {"DSC", "AUC", "Precision", "Recall"} and g["DSC"]["media"] > 0
    # every region the orchestrator times was timed, the consensus only in
    # the third plane's run
    t = chain_tree["timings"]
    for plano in PLANES:
        assert {"setup", "extraer_dataset", "predicciones_fold1", "predicciones_fold2",
                "reconstrucciones_fold1", "reconstrucciones_fold2", "eval_fold1",
                "eval_fold2", "promediar_folds"} <= set(t[plano])
        assert ("consenso_fold1" in t[plano]) == (plano == "sagital")
    assert (root / "pred_vols").is_dir() and not list(root.rglob("*.tmp"))


def test_chain_second_run_is_all_skips(chain_tree):
    root = chain_tree["root"]
    files = tree_files(root, *ARTIFACTS)
    before = stamps(root, files)
    with Env(cwd=root):
        for plano in PLANES:
            torch_orch.ejecutar_pipeline(
                modelo(TModelo, plano, CASE), epochs=EPOCHS, rapido=False, device="cpu")
    assert tree_files(root, *ARTIFACTS) == files
    assert stamps(root, files) == before


def test_rapido_gives_the_chains_volumes_and_jsons(inputs, chain_tree, tmp_path):
    root = tmp_path / "exp"
    shutil.copytree(inputs, root)
    with Env(cwd=root):
        for plano in PLANES:
            tprof.reset_timings()
            torch_orch.ejecutar_pipeline(
                modelo(TModelo, plano, CASE), epochs=EPOCHS, rapido=True, device="cpu")
            timed = set(tprof.timings_summary())
            assert {"rapido_fold1", "rapido_fold2"} <= timed
            assert not any(name.startswith("predicciones_fold") for name in timed)
    chain = chain_tree["root"]
    want = tree_files(chain, "pred_vols", "results")
    assert tree_files(root, "pred_vols", "results") == want
    for rel in want:
        if rel.suffix == ".json":
            assert_json_files_equal(chain / rel, root / rel)
        else:
            # rapido stores every volume as float32; the chain's consensus is uint8
            np.testing.assert_array_equal(tnifti.load(root / rel).data,
                                          tnifti.load(chain / rel).data, err_msg=str(rel))
            np.testing.assert_array_equal(tnifti.load(root / rel).affine,
                                          tnifti.load(chain / rel).affine)
    assert not [f for f in tree_files(root, "datasets") if "pred_masks" in f.parts]
    stage1 = [f for f in tree_files(chain, "datasets") if "pred_masks" not in f.parts]
    assert tree_files(root, "datasets") == stage1


def test_patient_mode_equals_the_jax_orchestrator(inputs, chain_tree, tmp_path):
    """P30, axial, through each package's orchestrator in patient mode (the
    chain: patient mode does not default to ``rapido``), then through the
    port's ``rapido`` patient mode."""
    roots = {name: tmp_path / name for name in ("jax", "port", "port_rapido")}
    for root in roots.values():
        shutil.copytree(inputs, root)
    kw = dict(id="P30", plano="axial", modalidad=["FLAIR"], mejora="CLAHE",
              dataset_dir="MSLesSeg-Dataset/train")
    with Env(cwd=roots["jax"]):
        jorch.ejecutar_pipeline(modelo(JModelo, "axial", CASE), epochs=EPOCHS,
                                paciente=jpac.Paciente(**kw))
    with Env(cwd=roots["port"]):
        torch_orch.ejecutar_pipeline(modelo(TModelo, "axial", CASE), epochs=EPOCHS,
                                     paciente=tpac.Paciente(**kw), device="cpu")
    with Env(cwd=roots["port_rapido"]):
        torch_orch.ejecutar_pipeline(modelo(TModelo, "axial", CASE), epochs=EPOCHS,
                                     paciente=tpac.Paciente(**kw), rapido=True, device="cpu")
    jr, tr = roots["jax"], roots["port"]
    files = tree_files(jr, *ARTIFACTS)
    assert tree_files(tr, *ARTIFACTS) == files
    # 6 images, GT masks, labels and predictions; one volume; one JSON (no
    # fold or global file in patient mode)
    assert len(files) == 4 * NUM_CORTES + 2
    for rel in files:
        if rel.suffix == ".png":
            np.testing.assert_array_equal(tpng.load_gray(tr / rel), tpng.load_gray(jr / rel),
                                          err_msg=str(rel))
        elif rel.suffix == ".txt":
            assert (tr / rel).read_bytes() == (jr / rel).read_bytes()
        elif rel.suffix == ".json":
            assert_json_files_equal(jr / rel, tr / rel)
        else:
            assert_volumes_equal(jr / rel, tr / rel)
    # the same patient through the full-mode chain and through rapido
    rr = roots["port_rapido"]
    served = tree_files(rr, "pred_vols", "results")
    assert served == tree_files(tr, "pred_vols", "results")
    for rel in served:
        if rel.suffix == ".json":
            assert_json_files_equal(tr / rel, rr / rel)
            assert_json_files_equal(chain_tree["root"] / rel, rr / rel)
        else:
            assert_volumes_equal(tr / rel, rr / rel)
            assert_volumes_equal(chain_tree["root"] / rel, rr / rel)
    assert not [f for f in tree_files(rr, "datasets") if "pred_masks" in f.parts]


# --------------------------------------------------------------------------
# stage 2, the device, the flags
# --------------------------------------------------------------------------


@pytest.fixture()
def untrained(tmp_path):
    """A dataset and GT with no weights at all."""
    root = tmp_path / "exp"
    write_dataset(root, pids=("P1", "P30"))
    return root


def test_an_untrained_fold_without_entrenar_warns_and_goes_on(untrained, caplog):
    with Env(cwd=untrained), caplog.at_level("WARNING"):
        torch_orch.ejecutar_pipeline(modelo(TModelo, "axial", CASE), epochs=EPOCHS, device="cpu")
    text = caplog.text
    for k in (1, 2):
        assert f"Fold {k} sin modelo entrenado y --entrenar no indicado" in text
        assert f"Sin modelo para el fold {k}; se omiten predicciones" in text
    assert (untrained / "datasets").is_dir()  # stage 1 ran
    assert not (untrained / "pred_vols").exists()
    assert not list((untrained / "results").rglob("*.json"))


@pytest.fixture
def one_torch_thread():
    """Torch on one thread for a test that runs whole stages: the suite runs
    several test processes at once, and each torch process's own thread
    pool would contend for the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.usefixtures("one_torch_thread")
def test_completo_entrenar_trains_every_fold_at_once_and_serves_them(untrained, monkeypatch):
    """Full mode with no fold trained trains all folds at once (ROADMAP A7,
    ported) and serves each from its ``best.pt``: the CLI's ``--completo
    --entrenar`` exits 0 with every fold's files (the fold-by-fold path is
    ``test_torch_port_train_stage``'s)."""
    from tpu_mslesseg_torch.train.trainer import TrainConfig

    monkeypatch.setattr(torch_orch, "ejecutar_pipeline", functools.partial(
        torch_orch.ejecutar_pipeline, device="cpu",
        train_cfg=TrainConfig(epochs=EPOCHS, batch_size=4, imgsz=64, amp=False)))
    argv = ["--plano", "axial", "--modalidad", "FLAIR", "--num_cortes", str(NUM_CORTES),
            "--mejora", "CLAHE", "--epochs", str(EPOCHS), "--k_folds", str(K_FOLDS),
            "--completo", "--entrenar"]
    tprof.reset_timings()
    try:
        with Env(cwd=untrained):
            assert torch_orch.main(argv) is None  # no SystemExit: the run ended well
        log = (untrained / "pipeline.log").read_text()
    finally:
        tlog.configure_logging(log_file=None)
    assert "Error en el pipeline" not in log and "Pipeline completado" in log
    timed = tprof.timings_summary()
    assert "train_paralelo" in timed and not [k for k in timed if k.startswith("train_fold")]
    trains = untrained / _base("trains")
    for k in range(1, K_FOLDS + 1):
        fold = trains / "axial" / f"fold{k}"
        assert {p.name for p in (fold / "weights").iterdir()} == {"best.pt", "last.pt",
                                                                  "fitness.json"}
        assert (fold / "results.csv").is_file() and (fold / "args.yaml").is_file()
    served = sorted(p.relative_to(untrained / _base("pred_vols")).as_posix()
                    for p in (untrained / "pred_vols").rglob("*.nii.gz"))
    assert served == ["fold1/P1/P1_axial.nii.gz", "fold2/P30/P30_axial.nii.gz"]


def test_a_trained_fold_skips_stage_two_even_with_entrenar(inputs, tmp_path, caplog):
    root = tmp_path / "exp"
    shutil.copytree(inputs, root)
    pac = tpac.Paciente(id="P1", plano="coronal", modalidad=["FLAIR"], mejora="CLAHE",
                        dataset_dir=root / "MSLesSeg-Dataset" / "train")
    with Env(cwd=root), caplog.at_level(tlog.SKIP_LEVEL):
        torch_orch.ejecutar_pipeline(modelo(TModelo, "coronal", CASE), epochs=EPOCHS,
                                     paciente=pac, entrenar=True, device="cpu")
    assert "Modelo del fold 1 ya entrenado" in caplog.text
    assert (root / _base("pred_vols", "coronal") / "fold1" / "P1" / "P1_coronal.nii.gz").exists()


def test_main_exits_1_without_a_cuda_device(untrained):
    if torch.cuda.is_available():
        pytest.skip("this box has a CUDA device")
    argv = ["--plano", "axial", "--modalidad", "FLAIR", "--num_cortes", str(NUM_CORTES),
            "--k_folds", str(K_FOLDS), "--completo"]
    with Env(cwd=untrained):
        try:
            with pytest.raises(SystemExit) as exc:
                torch_orch.main(argv)
        finally:
            tlog.configure_logging(log_file=None)
    assert exc.value.code == 1
    log = (untrained / "pipeline.log").read_text()
    assert "Error en el pipeline" in log and "no disponible" in log
    assert not (untrained / "datasets").exists()  # nothing ran on the CPU instead


def test_pipeline_entry_point_defaults_to_the_card():
    import inspect

    assert inspect.signature(torch_orch.ejecutar_pipeline).parameters["device"].default == "cuda"


BASE_ARGS = ["--plano", "coronal", "--num_cortes", "P50"]
ARGVS = {
    "completo": BASE_ARGS + ["--completo"],
    "completo_sin_rapido": BASE_ARGS + ["--completo", "--sin_rapido"],
    "completo_rapido": BASE_ARGS + ["--completo", "--rapido"],
    "paciente": BASE_ARGS + ["--paciente_id", "P7"],
    "paciente_rapido": BASE_ARGS + ["--paciente_id", "P7", "--rapido"],
    "paciente_rapido_sin": BASE_ARGS + ["--paciente_id", "P7", "--rapido", "--sin_rapido"],
    "everything": ["--plano", "sagital", "--modalidad", "T1", "FLAIR", "--num_cortes", "40",
                   "--mejora", "LT", "--epochs", "3", "--k_folds", "4", "--umbral_consenso", "3",
                   "--completo", "--entrenar", "--train_secuencial", "--limpiar"],
}
RAPIDO = {"completo": True, "completo_sin_rapido": False, "completo_rapido": True,
          "paciente": False, "paciente_rapido": True, "paciente_rapido_sin": False,
          "everything": True}
BAD_ARGVS = {
    "no_mode": BASE_ARGS,
    "both_modes": BASE_ARGS + ["--completo", "--paciente_id", "P7"],
    "no_plano": ["--num_cortes", "5", "--completo"],
    "consenso_plano": ["--plano", "consenso", "--num_cortes", "5", "--completo"],
    "bad_cortes": ["--plano", "axial", "--num_cortes", "x5", "--completo"],
    "bad_umbral": BASE_ARGS + ["--completo", "--umbral_consenso", "1"],
    "bad_mejora": BASE_ARGS + ["--completo", "--mejora", "XX"],
    "new_flag": BASE_ARGS + ["--completo", "--device", "cpu"],
}


@pytest.mark.parametrize("name", sorted(ARGVS))
def test_flags_and_rapido_default_equal_jax(name):
    t, j = torch_orch.parsear_args(ARGVS[name]), jorch.parsear_args(ARGVS[name])
    assert vars(t) == vars(j)
    assert torch_orch.resolver_rapido(t) is jorch.resolver_rapido(j)
    assert torch_orch.resolver_rapido(t) is RAPIDO[name]


@pytest.mark.parametrize("name", sorted(BAD_ARGVS))
def test_bad_flags_are_refused_like_jax(name):
    for parse in (torch_orch.parsear_args, jorch.parsear_args):
        with pytest.raises(SystemExit) as exc:
            parse(BAD_ARGVS[name])
        assert exc.value.code == 2


def test_fold_helpers_and_the_consensus_gate_match_jax(chain_tree, inputs):
    assert torch_orch.PLANOS_ANATOMICOS == jorch.PLANOS_ANATOMICOS
    for k, pid in ((2, None), (5, None), (2, "P30"), (5, "P30"), (5, "P1")):
        assert torch_orch.folds_del_experimento(k, pid) == jorch.folds_del_experimento(k, pid)
    root = chain_tree["root"]
    tm, jm = modelo(TModelo, "axial", CASE), modelo(JModelo, "axial", CASE)
    for folds in ([1], [1, 2], [1, 2, 3]):
        assert torch_orch.verificar_folds_consenso(tm, EPOCHS, folds, root=root) is \
            jorch.verificar_folds_consenso(jm, EPOCHS, folds, root=root) is (3 not in folds)
    # a missing plane volume closes the gate
    vol = root / _base("pred_vols") / "fold2" / "P30" / "P30_coronal.nii.gz"
    vol.rename(vol.with_suffix(".moved"))
    try:
        assert torch_orch.verificar_folds_consenso(tm, EPOCHS, [1, 2], root=root) is \
            jorch.verificar_folds_consenso(jm, EPOCHS, [1, 2], root=root) is False
    finally:
        vol.with_suffix(".moved").rename(vol)
    with Env(cwd=inputs):
        assert torch_orch.folds_sin_entrenar(tm, EPOCHS, [1, 2]) == []
        assert torch_orch.folds_sin_entrenar(tm, EPOCHS + 1, [1, 2]) == [1, 2]
        # the JAX package looks for its own checkpoint directory: axial fold 2
        assert jorch.folds_sin_entrenar(jm, EPOCHS, [1, 2]) == [1]
