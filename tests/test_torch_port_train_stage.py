"""Stage 2 of the port (``pipeline/stages/train.py``) and ``--entrenar`` in the
orchestrator, on the CPU.

The tree is ``test_torch_port_stages``'s (P1 and P2 in fold 1 of 2, P30 in
fold 2; FLAIR under CLAHE, 6 slices a patient). The CPU is passed down by
wrapping the entry point the CLI calls (``ejecutar_flujo_train``, or
``ejecutar_pipeline``) with ``device="cpu"``; nothing defaults to it.

* ``stages.train.main([... "--fold_test", "1"])`` at imgsz 64 in float32
  lays out the fold as the reference does (``args.yaml``, the dataset
  YAML, ``results.csv``, ``weights/{best,last}.pt``, ``fitness.json``, and
  the training figures where matplotlib imports), and a second run skips;
* the two YAML files parse (``yaml.safe_load``) to what the JAX package's
  writers give for the same inputs, as do values of every kind the writer
  takes (paths, lists of patient ids, None, booleans, 0.002, 1e-12);
* ``ejecutar_pipeline.main([... "--completo", "--entrenar",
  "--train_secuencial"])`` trains both folds, then serves every patient
  from the ``best.pt`` it wrote (``rapido``, imgsz 96); a second run trains
  nothing;
* without ``--train_secuencial`` the same command trains both folds at once
  (``ejecutar_train_paralelo`` with the orchestrator's device, never fold
  by fold), and the stage's ``--paralelo`` skips a trained experiment and
  starts again with ``--limpiar``.
"""

import csv
import functools
import importlib.util
import shutil

import pytest
import torch
import yaml

from test_torch_port_stages import Env, TModelo, write_dataset
from tpu_mslesseg.pipeline.modelo import Modelo as JModelo
from tpu_mslesseg.pipeline.stages import train as jtrain_stage
from tpu_mslesseg.train import engine as jengine
from tpu_mslesseg.train.trainer import TrainConfig as JConfig
from tpu_mslesseg_torch.pipeline import ejecutar_pipeline as torch_orch
from tpu_mslesseg_torch.pipeline import logging_setup as tlog
from tpu_mslesseg_torch.pipeline import yaml_out
from tpu_mslesseg_torch.pipeline.paths import ConfigTrain, existe_modelo_entrenado
from tpu_mslesseg_torch.pipeline.stages import train as train_stage
from tpu_mslesseg_torch.train import engine as tengine
from tpu_mslesseg_torch.train.trainer import TrainConfig

EPOCHS = 2
STAGE_ARGS = ["--plano", "axial", "--modalidad", "FLAIR", "--num_cortes", "6", "--mejora",
              "CLAHE", "--epochs", str(EPOCHS), "--k_folds", "2", "--fold_test", "1",
              "--imgsz", "64", "--batch", "4", "--no_amp", "--pretrained", "no"]
MODELO = dict(plano="axial", num_cortes=6, modalidad=["FLAIR"], k_folds=2, mejora="CLAHE")
FOLD_FILES = {"args.yaml", "axial_FLAIR_CLAHE_6c_2folds.yaml", "results.csv",
              "weights/best.pt", "weights/last.pt", "weights/fitness.json"}
# the training figures (``plots`` on by default), where matplotlib imports:
# the parallel engine writes the results, labels, curves and confusion
# matrices a fold, the sequential one the batch previews as well
PARALLEL_FIGURES = {"results.png", "labels.jpg", "confusion_matrix.png",
                    "confusion_matrix_normalized.png"} | {
    f"{k}{c}.png" for k in ("Box", "Mask") for c in ("P_curve", "R_curve", "F1_curve", "PR_curve")}
FIGURES = PARALLEL_FIGURES | {"train_batch0.jpg", "train_batch1.jpg", "train_batch2.jpg",
                              "val_batch0_labels.jpg", "val_batch0_pred.jpg"}
if importlib.util.find_spec("matplotlib") is None:
    PARALLEL_FIGURES = FIGURES = set()


def _files(d):
    return {str(p.relative_to(d)) for p in d.rglob("*") if p.is_file()}


@pytest.fixture(scope="module")
def stage_run(tmp_path_factory):
    root = tmp_path_factory.mktemp("stage2")
    write_dataset(root)
    with pytest.MonkeyPatch.context() as mp, Env(cwd=root):
        mp.setattr(train_stage, "ejecutar_flujo_train",
                   functools.partial(train_stage.ejecutar_flujo_train, device="cpu"))
        train_stage.main(STAGE_ARGS)
        fold = ConfigTrain(modelo=TModelo(**MODELO), epochs=EPOCHS, fold_test=1, root=root).fold_dir
        before = {f: (fold / f).stat().st_mtime_ns for f in _files(fold)}
        calls = []
        mp.setattr(tengine, "train_fold", lambda *a, **kw: calls.append(1))
        train_stage.main(STAGE_ARGS)
    return root, fold, before, calls


def test_the_stage_lays_out_the_fold_as_the_reference(stage_run):
    root, fold, _, _ = stage_run
    assert _files(fold) == FOLD_FILES | FIGURES
    assert fold == root / "trains" / "CLAHE" / f"FLAIR_6c_2folds_{EPOCHS}epochs" / "axial" / "fold1"
    with open(fold / "results.csv") as f:
        rows = list(csv.reader(f))
    assert [r[0] for r in rows[1:]] == [str(e) for e in range(1, EPOCHS + 1)]
    assert tengine.entrenamiento_exitoso(fold)
    assert existe_modelo_entrenado(TModelo(**MODELO), EPOCHS, 1, root=root)
    best = torch.load(fold / "weights" / "best.pt", weights_only=True)
    assert best["model.0.conv.weight"].shape[1] == 3  # the 3-channel stem the predictors fold


def test_a_second_run_skips(stage_run):
    _, fold, before, calls = stage_run
    assert calls == []
    assert {f: (fold / f).stat().st_mtime_ns for f in _files(fold)} == before


def test_the_yaml_files_parse_as_the_jax_packages(stage_run, tmp_path):
    root, fold, _, _ = stage_run
    ds = root / "MSLesSeg-Dataset" / "train"
    jfold = tmp_path / "jax_fold"
    jtrain_stage._escribir_dataset_yaml(jfold, JModelo(**MODELO), ds, ["P1", "P2", "P30"], 1, 2)
    name = "axial_FLAIR_CLAHE_6c_2folds.yaml"
    assert yaml.safe_load((fold / name).read_text()) == yaml.safe_load((jfold / name).read_text())
    assert list(yaml.safe_load((fold / name).read_text())) == ["path", "train", "val", "names", "nc"]
    jengine._write_args_yaml(
        jfold / "args.yaml", JConfig(epochs=EPOCHS, batch_size=4, imgsz=64, amp=False),
        plano="axial", modalidades=["FLAIR"], mejora="CLAHE", num_cortes=6, fold_test=1,
        k_folds=2)
    want = yaml.safe_load((jfold / "args.yaml").read_text())
    assert yaml.safe_load((fold / "args.yaml").read_text()) == want and want["remat"] is True


@pytest.mark.parametrize("remat", [True, False])
def test_the_stage_builds_its_model_with_the_configs_remat(tmp_path, remat):
    """``create_model(..., remat=cfg.remat)``, fold by fold and for every
    fold at once, as the reference's stage 2 (``:100-102``, ``:247-249``);
    the CLI's configuration keeps the default, on."""
    root = tmp_path / "exp"
    write_dataset(root, pids=("P1", "P30"))
    cfg = TrainConfig(epochs=1, batch_size=4, imgsz=64, amp=False, remat=remat)
    built = []
    with pytest.MonkeyPatch.context() as mp, Env(cwd=root):
        mp.setattr(tengine, "train_fold",
                   lambda **kw: built.append(("fold", kw["model"].remat, kw["cfg"].remat)) or {})
        mp.setattr(train_stage.engine_parallel, "train_folds_parallel",
                   lambda **kw: built.append(("all", kw["model"].remat, kw["cfg"].remat)) or {})
        train_stage.ejecutar_flujo_train(
            ConfigTrain(modelo=TModelo(**MODELO), epochs=1, fold_test=1, root=root),
            train_cfg=cfg, device="cpu")
        train_stage.ejecutar_train_paralelo(TModelo(**MODELO), 1, train_cfg=cfg, device="cpu")
        seen = []
        mp.setattr(train_stage, "ejecutar_flujo_train", lambda *a, **kw: seen.append(kw))
        train_stage.main(STAGE_ARGS)
    assert built == [("fold", remat, remat), ("all", remat, remat)]
    assert seen[0]["train_cfg"].remat is True is JConfig().remat


@pytest.mark.parametrize("value", [None, True, False, 0, -1, 7, 0.002, 1e-12, 1e12, -2.5e-07,
                                   0.1, 1.0, float("inf"), "", "P30", "it's", "1e3", "yes",
                                   "null", "/tmp/a path/MSLesSeg-Dataset", [], ["P1", "P2"],
                                   ["T1", "FLAIR"], [1, 2.5, None, True]])
def test_yaml_writer_round_trips_like_pyyaml(value, tmp_path):
    payload = {"b": value, "a": 1, "path": tmp_path}
    for sort_keys in (True, False):
        got = yaml.safe_load(yaml_out.dumps(payload, sort_keys=sort_keys))
        want = yaml.safe_load(yaml.safe_dump({**payload, "path": str(tmp_path)},
                                             sort_keys=sort_keys))
        assert got == want and list(got) == list(want)
    with pytest.raises(TypeError):
        yaml_out.dumps({"a": {"nested": 1}})


# --------------------------------------------------------------------------
# the orchestrator: --entrenar, then serving from the best.pt it wrote
# --------------------------------------------------------------------------

ORCH_ARGS = ["--plano", "axial", "--modalidad", "FLAIR", "--num_cortes", "6", "--mejora",
             "CLAHE", "--epochs", "1", "--k_folds", "2", "--completo", "--entrenar"]
ORCH_CFG = TrainConfig(epochs=1, batch_size=4, imgsz=64, amp=False)


def _main(mp, root, argv):
    mp.setattr(torch_orch, "ejecutar_pipeline", functools.partial(
        torch_orch.ejecutar_pipeline, device="cpu", train_cfg=ORCH_CFG))
    try:
        with Env(cwd=root):
            torch_orch.main(argv)
    finally:
        tlog.configure_logging(log_file=None)


def test_entrenar_trains_each_fold_then_serves_from_best_pt(tmp_path):
    root = tmp_path / "exp"
    write_dataset(root)
    real_train_fold = tengine.train_fold
    with pytest.MonkeyPatch.context() as mp:
        trained = []
        mp.setattr(tengine, "train_fold",
                   lambda *a, **kw: trained.append(kw["fold_test"]) or real_train_fold(*a, **kw))
        _main(mp, root, ORCH_ARGS + ["--train_secuencial"])
        assert trained == [1, 2]
        exp = "FLAIR_6c_2folds_1epochs"
        for k in (1, 2):
            fold = root / "trains" / "CLAHE" / exp / "axial" / f"fold{k}"
            assert _files(fold) == FOLD_FILES | FIGURES
        served = sorted(p.relative_to(root / "pred_vols" / "CLAHE" / exp).as_posix()
                        for p in (root / "pred_vols").rglob("*.nii.gz"))
        assert served == ["fold1/P1/P1_axial.nii.gz", "fold1/P2/P2_axial.nii.gz",
                          "fold2/P30/P30_axial.nii.gz"]
        for pid, k in (("P1", 1), ("P2", 1), ("P30", 2)):
            assert (root / "results" / "CLAHE" / exp / f"fold{k}" / pid
                    / f"{pid}_axial_results.json").is_file()

        # a second run trains nothing; the default (all folds at once) with a
        # fold trained goes fold by fold too, and skips
        stamps = {p: p.stat().st_mtime_ns for p in (root / "trains").rglob("*") if p.is_file()}
        _main(mp, root, ORCH_ARGS)
        assert trained == [1, 2]
        assert {p: p.stat().st_mtime_ns for p in (root / "trains").rglob("*")
                if p.is_file()} == stamps


@pytest.fixture
def tmp_path_removed_after(tmp_path):
    """`tmp_path`, removed after the test: its tree holds checkpoints."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture
def one_torch_thread():
    """Torch on one thread for a test that runs whole stages: the suite runs
    several test processes at once, and each torch process's own thread
    pool would contend for the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.usefixtures("one_torch_thread", "tmp_path_removed_after")
def test_the_fold_parallel_default_raises_and_names_a7(tmp_path):
    """A full experiment with no fold trained trains every fold at once, the
    reference's default (ROADMAP A7, ported): through
    ``ejecutar_train_paralelo`` with the orchestrator's device, never fold
    by fold; the stage's ``--paralelo`` reaches the same function."""
    root = tmp_path / "exp"
    write_dataset(root, pids=("P1", "P30"))
    real = train_stage.ejecutar_train_paralelo
    calls = []

    def fold_by_fold(*a, **kw):
        raise AssertionError("trained fold by fold")

    with pytest.MonkeyPatch.context() as mp, Env(cwd=root):
        mp.setattr(train_stage, "ejecutar_flujo_train", fold_by_fold)
        mp.setattr(train_stage, "ejecutar_train_paralelo",
                   lambda *a, **kw: calls.append(kw) or real(*a, **kw))
        torch_orch.ejecutar_pipeline(TModelo(**MODELO), epochs=1, entrenar=True, device="cpu",
                                     train_cfg=ORCH_CFG)
    assert len(calls) == 1 and calls[0]["device"] == torch.device("cpu")
    out = root / "trains" / "CLAHE" / "FLAIR_6c_2folds_1epochs" / "axial"
    for k in (1, 2):
        assert _files(out / f"fold{k}") == FOLD_FILES | PARALLEL_FIGURES
        assert tengine.entrenamiento_exitoso(out / f"fold{k}")
    assert _files(out / "_parallel") == {"last.pt"}

    with pytest.MonkeyPatch.context() as mp:
        stage_calls = []
        mp.setattr(train_stage, "ejecutar_train_paralelo",
                   lambda *a, **kw: stage_calls.append((a, kw)))
        mp.setattr(train_stage, "ejecutar_flujo_train", fold_by_fold)
        train_stage.main(["--plano", "axial", "--num_cortes", "6", "--paralelo", "--k_folds",
                          "2", "--limpiar", "--imgsz", "64", "--no_amp"])
    ((modelo_, epochs), kw), = stage_calls
    assert (modelo_.k_folds, epochs, kw["limpiar"], kw["train_cfg"].imgsz) == (2, 50, True, 64)
    assert "device" not in kw  # the stage's CLI runs on the card, its default


@pytest.mark.usefixtures("one_torch_thread", "tmp_path_removed_after")
def test_paralelo_skips_a_trained_experiment_and_cleans_with_limpiar(tmp_path):
    """``ejecutar_train_paralelo`` (the reference's ``:204-268``): every
    fold trained skips; ``limpiar`` removes every fold and the stacked
    resume point, then trains again from epoch 1."""
    root = tmp_path / "exp"
    write_dataset(root, pids=("P1", "P30"))
    m = TModelo(**MODELO)
    run = functools.partial(train_stage.ejecutar_train_paralelo, m, 1, train_cfg=ORCH_CFG,
                            device="cpu")
    with Env(cwd=root):
        from tpu_mslesseg_torch.pipeline.stages import extraer_dataset

        extraer_dataset.ejecutar_dataset_pipeline(m, k_folds=2, device="cpu")
        summary = run()
        assert set(summary) == {"fold1", "fold2"}
        out = ConfigTrain(modelo=m, epochs=1, fold_test=1, root=root).output_dir
        stamps = {p: p.stat().st_mtime_ns for p in out.rglob("*") if p.is_file()}
        assert run() is None  # every fold trained: a skip
        assert {p: p.stat().st_mtime_ns for p in out.rglob("*") if p.is_file()} == stamps
        (out / "_parallel" / "stale").write_text("x")
        assert set(run(limpiar=True)) == {"fold1", "fold2"}
        assert not (out / "_parallel" / "stale").exists()
        with open(out / "fold1" / "results.csv") as f:
            assert [r[0] for r in list(csv.reader(f))[1:]] == ["1"]


def test_flags_equal_jax():
    paralelo = ["--plano", "coronal", "--num_cortes", "P50", "--paralelo", "--scale", "s",
                "--limpiar", "--mejora", "LT"]
    for argv in (STAGE_ARGS, paralelo):
        assert vars(train_stage.parsear_args(argv)) == vars(jtrain_stage.parsear_args(argv))
    for bad in ([], STAGE_ARGS + ["--paralelo"], STAGE_ARGS + ["--scale", "z"]):
        for parse in (train_stage.parsear_args, jtrain_stage.parsear_args):
            with pytest.raises(SystemExit):
                parse(bad)
    assert train_stage.resolver_pretrained("no") == jtrain_stage.resolver_pretrained("no") == ""
    with pytest.raises(FileNotFoundError):
        train_stage.resolver_pretrained("/nonexistent/yolo11n-seg.pt")


def test_limpiar_removes_the_fold(stage_run, tmp_path):
    root, fold, _, _ = stage_run
    copy = tmp_path / "copy"
    shutil.copytree(root / "trains", copy / "trains")
    cfg = ConfigTrain(modelo=TModelo(**MODELO), epochs=EPOCHS, fold_test=1, root=copy)
    assert existe_modelo_entrenado(cfg.modelo, EPOCHS, 1, root=copy)
    cfg.limpiar_entrenamiento()
    assert not cfg.fold_dir.exists() and not existe_modelo_entrenado(cfg.modelo, EPOCHS, 1, root=copy)
