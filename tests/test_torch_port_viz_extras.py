"""The port's visualisation and results extras against the JAX package's.

``viz/overlay.py``, ``viz/gif.py``, ``viz/figure.py``,
``extras/analizar_pacientes_dsc.py`` and ``extras/componer_resultados.py``
on synthetic trees made from a numpy seed: a patient's prediction tree
(stage 1's images and GT masks, stage 3's predictions) with a slice whose
image exists only under another modality's name, a prediction whose stem is
not an integer and a prediction with no GT; and a ``results/`` tree of
per-patient and global JSONs.

Tolerance: none. Frames, paths, DSCs, GIF bytes, dicts and CSV bytes are
compared exactly. The port's CSV is written without pandas; the JAX
package's comes from ``DataFrame.to_csv``.
"""

import json
import shutil
import sys

import numpy as np
import pytest

from tpu_mslesseg.extras import analizar_pacientes_dsc as janal
from tpu_mslesseg.extras import componer_resultados as jcomp
from tpu_mslesseg.io import png as jpng
from tpu_mslesseg.pipeline.modelo import Modelo as JModelo
from tpu_mslesseg.viz import figure as jfig
from tpu_mslesseg.viz import gif as jgif
from tpu_mslesseg.viz import overlay as jov
from tpu_mslesseg_torch.extras import analizar_pacientes_dsc as tanal
from tpu_mslesseg_torch.extras import componer_resultados as tcomp
from tpu_mslesseg_torch.pipeline.modelo import Modelo as TModelo
from tpu_mslesseg_torch.viz import figure as tfig
from tpu_mslesseg_torch.viz import gif as tgif
from tpu_mslesseg_torch.viz import overlay as tov

PID, EPOCHS, HW = "P39", 3, (20, 16)  # slices are [H, W] in volume space
INDICES = (3, 4, 6, 7, 9)
FALLBACK = 6  # this slice's image is stored under T1
NO_GT = 9  # this prediction has no GT mask
MODELO = dict(plano="axial", num_cortes="P50", modalidad=["FLAIR"], k_folds=5, mejora="GC")


def _rng(seed=0):
    return np.random.default_rng(seed)


def write_prediction_tree(root, seed=0):
    """Stage 1's images and GT masks (PNG space, [W, H]) and stage 3's
    predictions (volume space, [H, W], {0, 255}) of one patient."""
    rng = _rng(seed)
    base = tgif.prediction_dir(TModelo(**MODELO), PID, root)
    for d in ("images", "pred_masks", "GT_masks"):
        (base / d).mkdir(parents=True)
    for i in INDICES:
        mod = "T1" if i == FALLBACK else "FLAIR"
        jpng.save_gray(base / "images" / f"{PID}_{mod}_{i}.png",
                       rng.integers(20, 230, HW[::-1]).astype(np.uint8))
        gt = np.zeros(HW[::-1], np.uint8)
        gt[4 : 8 + i % 4, 3 : 11] = 1
        if i != NO_GT:
            jpng.save_gray(base / "GT_masks" / f"{PID}_{i}.png", gt)
        pred = np.zeros(HW, np.uint8)
        pred[3 + i % 3 : 12, 2 : 9 + i % 5] = 255
        jpng.save_gray(base / "pred_masks" / f"{PID}_FLAIR_{i}.png", pred)
    jpng.save_gray(base / "pred_masks" / f"{PID}_FLAIR_x.png", np.zeros(HW, np.uint8))
    return base


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("viz") / "exp"
    return root, write_prediction_tree(root)


# --------------------------------------------------------------------------
# overlay
# --------------------------------------------------------------------------


def _case(which):
    rng = _rng(7)
    img = rng.integers(0, 256, (12, 10)).astype(float)
    pred = (rng.random((12, 10)) < 0.4).astype(float)
    gt = (rng.random((12, 10)) < 0.4).astype(float)
    return img, pred, gt


@pytest.mark.parametrize("what", ["render", "render_lo_hi", "load_triplet", "slice_dsc",
                                  "viz_output_dir"])
def test_overlay_equals_the_jax_package(what, tree):
    root, base = tree
    img, pred, gt = _case(what)
    if what == "render":
        got, want = tov.render_overlay(img, pred, gt), jov.render_overlay(img, pred, gt)
    elif what == "render_lo_hi":
        got = tov.render_overlay(img, pred, gt, 30.0, 200.0)
        want = jov.render_overlay(img, pred, gt, 30.0, 200.0)
    elif what == "load_triplet":
        paths = (base / "images" / f"{PID}_FLAIR_3.png", base / "pred_masks" / f"{PID}_FLAIR_3.png",
                 base / "GT_masks" / f"{PID}_3.png")
        got, want = tov.load_triplet(*paths), jov.load_triplet(*paths)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape
        got, want = np.stack(got), np.stack(want)
    elif what == "slice_dsc":
        got, want = tov.slice_dsc(pred, gt), jov.slice_dsc(pred, gt)
        assert isinstance(got, float) and 0 < got < 1
    else:
        got = tov.viz_output_dir(TModelo(**MODELO), EPOCHS, 4, PID, "axial", root)
        want = jov.viz_output_dir(JModelo(**MODELO), EPOCHS, 4, PID, "axial", root)
    if isinstance(got, np.ndarray):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want


# --------------------------------------------------------------------------
# gif and figure
# --------------------------------------------------------------------------


def test_collect_slices_equals_the_jax_package(tree):
    _, base = tree
    got = tgif.collect_slices(base, PID, "FLAIR")
    assert got == jgif.collect_slices(base, PID, "FLAIR")
    # the non-integer stem and the missing GT are skipped; slice 6 falls back to T1
    assert [t[0] for t in got] == [i for i in INDICES if i != NO_GT]
    assert dict((t[0], t[1].name) for t in got)[FALLBACK] == f"{PID}_T1_{FALLBACK}.png"


def test_generar_gif_writes_the_jax_packages_bytes(tree, tmp_path):
    root, _ = tree
    jroot = tmp_path / "jax"
    shutil.copytree(root, jroot)
    got = tgif.generar_gif(TModelo(**MODELO), PID, EPOCHS, root=root)
    want = jgif.generar_gif(JModelo(**MODELO), PID, EPOCHS, root=jroot)
    assert got.relative_to(root) == want.relative_to(jroot)
    assert got.read_bytes() == want.read_bytes()
    frames, fps, path = tgif.preparar_gif(TModelo(**MODELO), PID, EPOCHS, root=root)
    assert path == got and len(frames) == len(INDICES) - 1 and fps == 3


@pytest.mark.parametrize("corte", [None, 4])
def test_generar_figura_picks_the_jax_packages_slice(tree, tmp_path, corte):
    root, base = tree
    jroot = tmp_path / "jax"
    shutil.copytree(root, jroot)
    got = tfig.generar_figura(TModelo(**MODELO), PID, EPOCHS, corte=corte, root=root)
    want = jfig.generar_figura(JModelo(**MODELO), PID, EPOCHS, corte=corte, root=jroot)
    assert got.relative_to(root) == want.relative_to(jroot) and got.is_file()
    triplets = tgif.collect_slices(base, PID, "FLAIR")
    t_best, j_best = tfig.seleccionar_mejor_corte(triplets), jfig.seleccionar_mejor_corte(triplets)
    assert t_best[:2] == j_best[:2]
    for g, w in zip(t_best[2], j_best[2]):
        np.testing.assert_array_equal(g, w)
    if corte is None:
        assert got.name == f"{PID}_FLAIR_{t_best[0]}.png"


def test_an_unknown_corte_raises_value_error(tree):
    root, _ = tree
    for mod, modelo in ((tfig, TModelo), (jfig, JModelo)):
        with pytest.raises(ValueError, match="Corte 5 sin predicción"):
            mod.generar_figura(modelo(**MODELO), PID, EPOCHS, corte=5, root=root)


@pytest.mark.parametrize("hidden", ["imageio", "matplotlib"])
def test_a_missing_library_raises_import_error_and_writes_nothing(tree, tmp_path, monkeypatch,
                                                                  hidden):
    root, _ = tree
    mine = tmp_path / "exp"
    shutil.copytree(root, mine)
    shutil.rmtree(mine / "visualizaciones", ignore_errors=True)
    for name in [m for m in sys.modules if m == hidden or m.startswith(hidden + ".")]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, hidden, None)
    fn = tgif.generar_gif if hidden == "imageio" else tfig.generar_figura
    with pytest.raises(ImportError):
        fn(TModelo(**MODELO), PID, EPOCHS, root=mine)
    assert not (mine / "visualizaciones").exists()


# --------------------------------------------------------------------------
# extras
# --------------------------------------------------------------------------


def write_results_tree(root, seed=1):
    """Per-patient JSONs (three planes and consensus) for two experiments,
    a broken JSON, a JSON with no DSC, a stray file; global JSONs with every
    known enhancement and plane, an unknown enhancement and plane, and a
    missing metric."""
    rng = _rng(seed)
    res = root / "results"
    for mejora, config in (("GC", "FLAIR_P50c_5folds_3epochs"), ("HE", "FLAIR_P50c_5folds_3epochs"),
                           ("Base", "T1FLAIR_50c_2folds_1epochs")):
        for fold, pids in ((1, ("P1", "P7")), (4, ("P39", "P40"))):
            for pid in pids:
                for plano in ("axial", "coronal", "sagital", "consenso"):
                    d = res / mejora / config / f"fold{fold}" / pid
                    d.mkdir(parents=True, exist_ok=True)
                    (d / f"{pid}_{plano}_results.json").write_text(json.dumps(
                        {"DSC": round(float(rng.random()), 3), "AUC": 0.5}))
    d = res / "GC" / "FLAIR_P50c_5folds_3epochs" / "fold1" / "P1"
    (d / "P1_axial_results.json").write_text("{not json")
    (d / "P1_coronal_results.json").write_text(json.dumps({"AUC": 0.7}))
    (res / "HE" / "README.txt").write_text("stray")
    (res / "LT" / "empty_config").mkdir(parents=True)

    def glob(mejora, config, plano, metrics=("DSC", "AUC", "Precision", "Recall")):
        d = res / mejora / config
        d.mkdir(parents=True, exist_ok=True)
        data = {m: {"media": float(rng.random()), "std": float(rng.random() / 10)}
                for m in metrics}
        (d / f"global_{plano}_results.json").write_text(json.dumps(data))

    for mejora in ("LT", "GC", "Base", "CLAHE", "HE", "ZZ", "AA"):
        for plano in ("sagital", "consenso", "axial", "coronal"):
            # the first file read lacks two metrics: pandas puts them last
            first = (mejora, plano) == ("AA", "axial")
            glob(mejora, "FLAIR_P50c_5folds_3epochs", plano,
                 *((("DSC", "Recall"),) if first else ()))
    glob("GC", "A_first_config", "axial")
    glob("HE", "FLAIR_P50c_5folds_3epochs", "oblicuo")
    glob("CLAHE", "B_config", "coronal", metrics=("DSC", "Recall"))
    glob("Base", "B_config", "axial", metrics=("Extra", "DSC"))
    return res


def test_analizar_resultados_equals_the_jax_package(tmp_path):
    res = write_results_tree(tmp_path)
    got = tanal.analizar_resultados(res)
    assert got == janal.analizar_resultados(res)
    assert set(got) == {"GC/FLAIR_P50c_5folds_3epochs", "HE/FLAIR_P50c_5folds_3epochs",
                        "Base/T1FLAIR_50c_2folds_1epochs"}
    assert tanal.main(["--results", str(res)]) == got
    with pytest.raises(FileNotFoundError):
        tanal.analizar_resultados(tmp_path / "missing")


def test_componer_resultados_writes_the_jax_packages_csv(tmp_path):
    res = write_results_tree(tmp_path)
    got, want = tmp_path / "port.csv", tmp_path / "jax.csv"
    rows = tcomp.main(["--results", str(res), "--out", str(got)])
    df = jcomp.main(["--results", str(res), "--out", str(want)])
    assert got.read_bytes() == want.read_bytes()
    assert b"\r" not in got.read_bytes()
    assert len(rows) == len(df) == 7 * 4 + 4
    assert [r["Mejora"] for r in rows] == list(df["Mejora"])
    assert [r["Plano"] for r in rows] == list(df["Plano"])
    assert rows == tcomp.componer_resultados(res)
    header = got.read_text().splitlines()[0]
    assert header == "Mejora,Config,Plano,DSC,Recall,AUC,Precision"
    empty = tmp_path / "empty"
    empty.mkdir()
    for mod in (tcomp, jcomp):
        with pytest.raises(FileNotFoundError):
            mod.componer_resultados(empty)
