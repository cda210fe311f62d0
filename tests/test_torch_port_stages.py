"""The port's stage chain (stages 0, 1, 3-7) against the JAX package's.

One synthetic experiment tree a case, on the pattern of
``tests/test_pipeline.py`` and ``tests/test_orchestrator_e2e.py``: volumes
24x28x24, ``k_folds=2``, patients P1 and P2 in fold 1 and P30 in fold 2,
6 slices a patient, ``TPU_MSLESSEG_IMGSZ=96``. Volumes come from a numpy
seed; the weights are the JAX model's ``init`` with perturbed batch-norm
statistics and a head that keeps boxes (``test_torch_port_consensus``), the
mask-coefficient bias lowered so the masks are mixed, saved side by side as
the JAX package's Orbax ``best.ckpt`` and, through the bridge, the port's
``best.pt``. Both packages serve in float32.

Two cases: FLAIR under ``--mejora CLAHE``, and the two modalities T1 + FLAIR
with no enhancement (the per-modality masks are OR-ed on the device). Each
package runs stages 1, 3, 4 and 6 for the axial plane from its own copy of
the tree; the port also runs coronal and sagital, and the JAX stages 5, 6
(consenso) and 7 then run on a copy of the port's three plane volumes.

Tolerance: none. PNGs equal pixel for pixel, label files byte for byte,
volumes voxel for voxel with the same affine and on-disk dtype, JSON files
as parsed objects (NaN equal to NaN), return values and exception types
alike.
"""

import json
import math
import os
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_consensus import _perturbed
from tpu_mslesseg.io import nifti as jnifti
from tpu_mslesseg.io import png as jpng
from tpu_mslesseg.model.yolo11 import create_model as j_create
from tpu_mslesseg.pipeline import labels as jlabels
from tpu_mslesseg.pipeline import paciente as jpac
from tpu_mslesseg.pipeline import paths as jpaths
from tpu_mslesseg.pipeline.modelo import Modelo as JModelo
from tpu_mslesseg.pipeline.stages import eval as jeval
from tpu_mslesseg.pipeline.stages import extraer_dataset as jext
from tpu_mslesseg.pipeline.stages import generar_consenso as jcons
from tpu_mslesseg.pipeline.stages import generar_predicciones as jgen
from tpu_mslesseg.pipeline.stages import promediar_folds as jprom
from tpu_mslesseg.pipeline.stages import reconstruir_volumen as jrec
from tpu_mslesseg.pipeline.stages import setup as jsetup
from tpu_mslesseg.preproc import slices as jslices
from tpu_mslesseg.train import checkpoint as jckpt
from tpu_mslesseg_torch.infer.predictor import SlicePredictor
from tpu_mslesseg_torch.io import nifti as tnifti
from tpu_mslesseg_torch.io import png as tpng
from tpu_mslesseg_torch.model.bridge import state_dict_from_reference
from tpu_mslesseg_torch.model.yolo11 import create_model as t_create
from tpu_mslesseg_torch.pipeline import labels as tlabels
from tpu_mslesseg_torch.pipeline import paciente as tpac
from tpu_mslesseg_torch.pipeline import paths as tpaths
from tpu_mslesseg_torch.pipeline.modelo import Modelo as TModelo
from tpu_mslesseg_torch.pipeline.stages import eval as teval
from tpu_mslesseg_torch.pipeline.stages import extraer_dataset as text_
from tpu_mslesseg_torch.pipeline.stages import generar_consenso as tcons
from tpu_mslesseg_torch.pipeline.stages import generar_predicciones as tgen
from tpu_mslesseg_torch.pipeline.stages import promediar_folds as tprom
from tpu_mslesseg_torch.pipeline.stages import reconstruir_volumen as trec
from tpu_mslesseg_torch.pipeline.stages import setup as tsetup
from tpu_mslesseg_torch.preproc import enhance as tenh
from tpu_mslesseg_torch.preproc import slices as tslices
from tpu_mslesseg_torch.train import checkpoint as tckpt
from torch_threads import one_torch_thread  # noqa: F401

SHAPE = (24, 28, 24)
PLANES = ("axial", "coronal", "sagital")
EPOCHS = 1
IMGSZ = 96
NUM_CORTES = 6
K_FOLDS = 2
PIDS = ("P1", "P2", "P30")  # folds 1, 1, 2 of 2
AFFINE = np.array([[-1.0, 0, 0, 12], [0, 1.0, 0, -14], [0, 0, 1.0, -12], [0, 0, 0, 1]])
# per-plane shift of the mask-coefficient bias: mixed masks at imgsz 96
MASK_BIAS = {"axial": -0.28, "coronal": -0.1, "sagital": -0.14}
CASES = {
    "clahe": {"modalidad": ["FLAIR"], "mejora": "CLAHE"},
    "multi": {"modalidad": ["T1", "FLAIR"], "mejora": None},
}
SERVING_ENV = {"TPU_MSLESSEG_IMGSZ": str(IMGSZ), "TPU_MSLESSEG_DTYPE": "float32"}


def modelo(cls, plano, case):
    return cls(plano=plano, num_cortes=NUM_CORTES, k_folds=K_FOLDS, **CASES[case])


class JaxState:
    """The fields the JAX package's ``save_checkpoint`` reads."""

    def __init__(self, v):
        self.params = v["params"]
        self.batch_stats = v["batch_stats"]
        self.ema_params = v["params"]
        self.step = np.int32(1)
        self.opt_state = ()


def write_dataset(root, pids=PIDS, seed=3):
    """``MSLesSeg-Dataset/train`` (T1 and FLAIR volumes, the mask) and
    ``GT/train`` for `pids`, from a numpy seed."""
    rng = np.random.default_rng(seed)
    for i, pid in enumerate(pids):
        mask = np.zeros(SHAPE, np.float32)
        mask[6 + i : 14, 8 + i : 18, 6 : 18 - i] = 1
        pdir = root / "MSLesSeg-Dataset" / "train" / pid / "T1"
        for mod, gain in (("FLAIR", 900.0), ("T1", 500.0)):
            vol = rng.normal(500, 150, SHAPE).astype(np.float32)
            vol[mask > 0] += gain
            jnifti.save(vol, AFFINE, pdir / f"{pid}_T1_{mod}.nii.gz")
        jnifti.save(mask, AFFINE, pdir / f"{pid}_T1_MASK.nii.gz")
        jnifti.save(mask.astype(np.uint8), AFFINE,
                    root / "GT" / "train" / pid / f"{pid}_MASK.nii.gz")


def plane_variables():
    """(jmodel, tmodel, {plane: JAX variables}): one set of weights a plane."""
    jmodel, _ = j_create(nc=1, scale="n")
    init = jax.jit(lambda k: jmodel.init(k, jnp.zeros((1, IMGSZ, IMGSZ, 3)), train=False))
    v0 = jax.tree_util.tree_map(np.asarray, init(jax.random.PRNGKey(0)))
    v0 = {c: jax.tree_util.tree_map(lambda x: x, dict(v0[c])) for c in v0}
    tmodel, _ = t_create(nc=1, scale="n")
    jvars = {}
    for i, plano in enumerate(PLANES):
        jvars[plano] = _perturbed(v0, 2 + i)
        for lvl in range(3):
            head = jvars[plano]["params"][f"mc{lvl}_2"]
            head["bias"] = (head["bias"] + MASK_BIAS[plano]).astype(np.float32)
    return jmodel, tmodel, jvars


def write_checkpoints(root, case, jvars, tmodel, jax_planes_folds=(), folds=(1, 2)):
    """``best.pt`` for every plane and fold; the Orbax ``best.ckpt`` only for
    the (plane, fold) pairs the JAX package will serve."""
    for plano in PLANES:
        sd = state_dict_from_reference(jvars[plano], tmodel)
        for k in folds:
            cfg = tpaths.ConfigTrain(modelo=modelo(TModelo, plano, case), epochs=EPOCHS,
                                     fold_test=k, root=root)
            tckpt.save_checkpoint(cfg.best_ckpt, sd)
            if (plano, k) in jax_planes_folds:
                jckpt.save_checkpoint(cfg.weights_dir / "best.ckpt", JaxState(jvars[plano]))


class Env:
    """The serving model at imgsz 96 in float32 and, with `cwd`, the working
    directory at an experiment root, for the duration."""

    def __init__(self, cwd=None):
        self.cwd = cwd

    def __enter__(self):
        self.old = os.getcwd()
        self.saved = {k: os.environ.get(k) for k in SERVING_ENV}
        os.environ.update(SERVING_ENV)
        if self.cwd is not None:
            os.chdir(self.cwd)

    def __exit__(self, *exc):
        os.chdir(self.old)
        for k, v in self.saved.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v


def tree_files(root, *tops):
    return sorted(p.relative_to(root) for d in tops for p in (root / d).rglob("*") if p.is_file())


def contents(root, files):
    """File bytes, a gzip container opened first (its header holds a time)."""
    import gzip

    raw = [(root / f).read_bytes() for f in files]
    return [gzip.decompress(b) if b[:2] == b"\x1f\x8b" else b for b in raw]


def stamps(root, files):
    return [(root / f).stat().st_mtime_ns for f in files]


def json_equal(a, b):
    """Parsed JSON values equal, NaN equal to NaN."""
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(json_equal(a[k], b[k]) for k in a)
    if isinstance(a, float) and isinstance(b, float) and math.isnan(a) and math.isnan(b):
        return True
    return type(a) is type(b) and a == b


def assert_volumes_equal(jpath, tpath):
    j, t = jnifti.load(jpath), jnifti.load(tpath)
    assert t.data.dtype == j.data.dtype, (jpath.name, t.data.dtype, j.data.dtype)
    np.testing.assert_array_equal(t.affine, j.affine)
    np.testing.assert_array_equal(t.data, j.data, err_msg=jpath.name)


def assert_json_files_equal(jpath, tpath):
    assert json_equal(json.loads(tpath.read_text()), json.loads(jpath.read_text())), jpath.name


# --------------------------------------------------------------------------
# the chain, stage by stage, both packages from their own tree
# --------------------------------------------------------------------------

PKGS = {
    "jax": dict(M=JModelo, paths=jpaths, ext=jext, gen=jgen, rec=jrec, ev=jeval, kw={}),
    "port": dict(M=TModelo, paths=tpaths, ext=text_, gen=tgen, rec=trec, ev=teval,
                 kw={"device": "cpu"}),
}


def _run_plane(pkg, root, case, plano, out):
    """Stages 1, 3, 4, 6 for one plane (stage 1 over the whole dataset, the
    others over fold 1), each twice: the first run's and the skip run's
    return values go into `out`."""
    p = PKGS[pkg]
    m = modelo(p["M"], plano, case)
    kw = p["kw"]
    cd = p["paths"].ConfigDataset(modelo=m, k_folds=K_FOLDS, completo=True, root=root)
    out[f"s1_{plano}"] = [p["ext"].ejecutar_flujo_dataset(cd, **kw) for _ in range(2)]
    cp = p["paths"].ConfigPred(modelo=m, epochs=EPOCHS, k_folds=K_FOLDS, fold_test=1, root=root)
    out[f"s3_{plano}"] = [p["gen"].ejecutar_flujo_pred(cp, **kw) for _ in range(2)]
    cr = p["paths"].ConfigRecVol(modelo=m, epochs=EPOCHS, k_folds=K_FOLDS, fold_test=1, root=root)
    out[f"s4_{plano}"] = [p["rec"].ejecutar_flujo_recvol(cr, **kw) for _ in range(2)]
    ce = p["paths"].ConfigEval(modelo=m, epochs=EPOCHS, k_folds=K_FOLDS, fold_test=1, root=root)
    out[f"s6_{plano}"] = [p["ev"].ejecutar_flujo_eval(ce, **kw) for _ in range(2)]


@pytest.fixture(scope="module")
def weights():
    return plane_variables()


@pytest.fixture(scope="module", params=sorted(CASES))
def chain(request, tmp_path_factory, weights):
    case = request.param
    _, tmodel, jvars = weights
    base = tmp_path_factory.mktemp(f"stages_{case}")
    src = base / "src"
    write_dataset(src)
    write_checkpoints(src, case, jvars, tmodel, jax_planes_folds={("axial", 1)}, folds=(1,))
    roots = {"jax": base / "jax", "port": base / "port"}
    returns = {"jax": {}, "port": {}}
    for pkg, root in roots.items():
        shutil.copytree(src, root)
    with Env():
        _run_plane("jax", roots["jax"], case, "axial", returns["jax"])
        for plano in PLANES:
            _run_plane("port", roots["port"], case, plano, returns["port"])
    return {"case": case, "roots": roots, "returns": returns, "base": base,
            "jvars": jvars, "tmodel": tmodel}


def _axial(files):
    return [f for f in files if "axial" in f.parts or "_axial" in f.name]


def test_stage1_images_masks_and_labels_equal_jax(chain):
    jr, tr = chain["roots"]["jax"], chain["roots"]["port"]
    jfiles = tree_files(jr, "datasets")
    tfiles = [f for f in _axial(tree_files(tr, "datasets")) if "pred_masks" not in f.parts]
    jfiles_s1 = [f for f in jfiles if "pred_masks" not in f.parts]
    assert tfiles == jfiles_s1
    n_mod = len(CASES[chain["case"]]["modalidad"])
    # 3 patients x 6 slices: an image a modality, a GT mask and a label file
    assert len(jfiles_s1) == 3 * NUM_CORTES * (n_mod + 2)
    for rel in jfiles_s1:
        if rel.suffix == ".png":
            want = jpng.load_gray(jr / rel)
            np.testing.assert_array_equal(tpng.load_gray(tr / rel), want, err_msg=str(rel))
            np.testing.assert_array_equal(jpng.load_gray(tr / rel), want, err_msg=str(rel))
            if "GT_masks" in rel.parts:
                assert set(np.unique(want)) == {0, 1}
            else:
                assert want.min() == 0 and want.max() == 255  # stretched, not flat
        else:
            assert (tr / rel).read_bytes() == (jr / rel).read_bytes(), str(rel)
            assert (jr / rel).read_text().startswith("0 ")
    assert chain["returns"]["port"]["s1_axial"] == chain["returns"]["jax"]["s1_axial"] == \
        [True, None]


def test_stage3_prediction_pngs_equal_jax(chain):
    jr, tr = chain["roots"]["jax"], chain["roots"]["port"]
    jpreds = [f for f in tree_files(jr, "datasets") if "pred_masks" in f.parts]
    tpreds = [f for f in _axial(tree_files(tr, "datasets")) if "pred_masks" in f.parts]
    assert tpreds == jpreds
    assert len(jpreds) == 2 * NUM_CORTES  # fold 1: P1 and P2, one PNG a slice
    mods = "".join(m for m in ("T1", "T2", "FLAIR") if m in CASES[chain["case"]]["modalidad"])
    assert all(f.name.startswith(f"{f.parts[-4]}_{mods}_") for f in jpreds)
    filled = 0
    for rel in jpreds:
        want = jpng.load_gray(jr / rel)
        assert want.shape == (SHAPE[0], SHAPE[1])  # stored in volume-slice orientation
        assert set(np.unique(want)) <= {0, 255}
        filled += int(0 < (want > 0).mean() < 1)
        np.testing.assert_array_equal(tpng.load_gray(tr / rel), want, err_msg=str(rel))
    assert filled == len(jpreds)  # every mask is mixed: neither empty nor full
    assert chain["returns"]["port"]["s3_axial"] == chain["returns"]["jax"]["s3_axial"] == \
        [True, None]


def test_stage3_stored_masks_are_the_or_of_each_modality(chain):
    """The stored mask is the OR, over the experiment's modalities, of the
    predictor's masks on that modality's enhanced slices (one modality: the
    mask itself)."""
    case = chain["case"]
    root = chain["roots"]["port"]
    m = modelo(TModelo, "axial", case)
    pac = tpac.Paciente(id="P2", plano="axial", modalidad=m.modalidad,
                        dataset_dir=root / "MSLesSeg-Dataset" / "train")
    ids = pac.indices_a_usar(NUM_CORTES)
    sd = state_dict_from_reference(chain["jvars"]["axial"], chain["tmodel"])
    pred = SlicePredictor(chain["tmodel"], sd, SHAPE[:2], imgsz=IMGSZ, device="cpu")
    each = [
        pred(tenh.enhance_for_model(torch.from_numpy(pac.cortes_imagen_batch(ids, mod)),
                                    m.mejora))
        for mod in m.modalidad
    ]
    union = each[0]
    for other in each[1:]:
        assert not torch.equal(other, each[0])  # the modalities disagree somewhere
        union = union | other
    cp = tpaths.ConfigPred(modelo=m, epochs=EPOCHS, k_folds=K_FOLDS, fold_test=1, root=root)
    for j, i in enumerate(ids):
        stored = tpng.load_pred_png(
            cp.paciente_dirs("P2")["pred_masks"] / f"P2_{pac.modalidad_str}_{i}.png")
        np.testing.assert_array_equal(stored > 0, union[j].numpy())


def test_stage4_volumes_equal_jax(chain):
    jr, tr = chain["roots"]["jax"], chain["roots"]["port"]
    jvols = tree_files(jr, "pred_vols")
    assert _axial(tree_files(tr, "pred_vols")) == jvols and len(jvols) == 2
    for rel in jvols:
        assert_volumes_equal(jr / rel, tr / rel)
        img = tnifti.load(tr / rel)
        assert img.data.dtype == np.float32 and img.shape == SHAPE
        np.testing.assert_array_equal(img.affine, AFFINE)
        assert 0 < img.data.mean() < 1
    assert chain["returns"]["port"]["s4_axial"] == chain["returns"]["jax"]["s4_axial"] == \
        [True, None]


def test_stage6_patient_and_fold_jsons_equal_jax(chain):
    jr, tr = chain["roots"]["jax"], chain["roots"]["port"]
    jres = tree_files(jr, "results")
    assert _axial(tree_files(tr, "results")) == jres and len(jres) == 3  # P1, P2, fold 1
    for rel in jres:
        assert_json_files_equal(jr / rel, tr / rel)
    jret, tret = chain["returns"]["jax"]["s6_axial"], chain["returns"]["port"]["s6_axial"]
    assert json_equal(tret[0], jret[0]) and tret[1] is jret[1] is None
    assert set(tret[0]) == {"DSC", "AUC", "Precision", "Recall"}
    assert tret[0]["DSC"]["media"] > 0


def test_second_run_of_every_stage_writes_nothing(chain):
    root = chain["roots"]["port"]
    case = chain["case"]
    files = tree_files(root, "datasets", "pred_vols", "results")
    before = stamps(root, files)
    again = {}
    with Env():
        for plano in PLANES:
            _run_plane("port", root, case, plano, again)
    assert tree_files(root, "datasets", "pred_vols", "results") == files
    assert stamps(root, files) == before
    assert all(v == [None, None] for v in again.values()), again


@pytest.mark.parametrize("stage", ["s1", "s3", "s4", "s6"])
def test_limpiar_rebuilds_the_same_artifacts(chain, tmp_path, stage):
    """``limpiar`` removes the stage's own artifacts for the plane and the
    run that follows writes them again, the same, touching nothing else;
    both packages return the same value (each on a copy of its tree; the
    JAX stage 3 is left out: it would only serve again). Stage 1's cleanup
    is the plane's whole directory, prediction PNGs included."""
    case = chain["case"]
    with Env():
        for pkg in ("port",) if stage == "s3" else ("port", "jax"):
            p, root = PKGS[pkg], tmp_path / pkg
            shutil.copytree(chain["roots"][pkg], root,
                            ignore=None if stage == "s3" else shutil.ignore_patterns("trains"))
            m = modelo(p["M"], "axial", case)
            common = dict(modelo=m, root=root)
            fold = dict(epochs=EPOCHS, k_folds=K_FOLDS, fold_test=1)
            cfg, run, top, keep = {
                "s1": (p["paths"].ConfigDataset(k_folds=K_FOLDS, completo=True, **common),
                       p["ext"].ejecutar_flujo_dataset, "datasets",
                       lambda f: "axial" in f.parts and "pred_masks" not in f.parts),
                "s3": (p["paths"].ConfigPred(**fold, **common), p["gen"].ejecutar_flujo_pred,
                       "datasets", lambda f: "axial" in f.parts and "pred_masks" in f.parts),
                "s4": (p["paths"].ConfigRecVol(**fold, **common),
                       p["rec"].ejecutar_flujo_recvol, "pred_vols",
                       lambda f: f.name.endswith("_axial.nii.gz")),
                "s6": (p["paths"].ConfigEval(**fold, **common), p["ev"].ejecutar_flujo_eval,
                       "results", lambda f: f.name.endswith("_axial_results.json")),
            }[stage]
            everything = tree_files(root, "datasets", "pred_vols", "results")
            files = [f for f in everything if keep(f)]
            gone = [f for f in everything
                    if stage == "s1" and "axial" in f.parts and "pred_masks" in f.parts]
            others = [f for f in everything if f not in files and f not in gone]
            assert files and others
            content = contents(root, files)
            before, before_others = stamps(root, files), stamps(root, others)
            res = run(cfg, limpiar=True, **p["kw"])
            assert res is True or (stage == "s6" and isinstance(res, dict)), (pkg, res)
            assert tree_files(root, "datasets", "pred_vols", "results") == \
                sorted(files + others)
            assert all(a != b for a, b in zip(stamps(root, files), before)), pkg
            assert contents(root, files) == content
            assert stamps(root, others) == before_others  # nothing else was touched


# --------------------------------------------------------------------------
# stages 5, 6 (consenso) and 7: JAX on a copy of the port's plane volumes
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def consensus(chain):
    """Stages 5-7 of each package, each on a copy of the port's three plane
    volumes and per-plane JSONs. Fold 2 has
    no volumes, so its fold JSON is planted as a copy of fold 1's for stage
    7 to have both."""
    case = chain["case"]
    jr, tr = chain["base"] / "jax_consensus", chain["base"] / "port_consensus"
    for root in (jr, tr):
        for top in ("GT", "pred_vols", "results", "datasets"):
            shutil.copytree(chain["roots"]["port"] / top, root / top)
    out = {}
    for pkg, p, root, cons, prom in (("port", PKGS["port"], tr, tcons, tprom),
                                     ("jax", PKGS["jax"], jr, jcons, jprom)):
        m = modelo(p["M"], "axial", case)
        fold = dict(modelo=m, epochs=EPOCHS, k_folds=K_FOLDS, fold_test=1, root=root)
        cc = p["paths"].ConfigConsenso(umbral=2, **fold)
        ce = p["paths"].ConfigEval(plano_forzado="consenso", **fold)
        r = out[pkg] = {}
        r["prom_incomplete"] = prom.ejecutar_flujo_promediar(ce)  # no consenso JSONs yet
        r["s5"] = [cons.ejecutar_flujo_consenso(cc, **p["kw"]) for _ in range(2)]
        r["s6"] = [p["ev"].ejecutar_flujo_eval(ce, **p["kw"]) for _ in range(2)]
        for plano in ("axial", "consenso"):
            f1 = ce.config_dir / "fold1" / f"fold1_{plano}_results.json"
            f2 = ce.config_dir / "fold2" / f"fold2_{plano}_results.json"
            f2.parent.mkdir(parents=True, exist_ok=True)
            stats = json.loads(f1.read_text())
            stats["DSC"]["media"] = round(stats["DSC"]["media"] / 2, 3)  # folds differ
            f2.write_text(json.dumps(stats))
        ca = p["paths"].ConfigEval(**fold)
        r["s7"] = [prom.ejecutar_flujo_promediar(c) for c in (ca, ce, ca, ce)]
    return {"jax": jr, "port": tr, "out": out}


def test_stage5_consensus_volumes_equal_jax(chain, consensus):
    jr, tr = consensus["jax"], consensus["port"]
    jc = [f for f in tree_files(jr, "pred_vols") if f.name.endswith("_consenso.nii.gz")]
    tc = [f for f in tree_files(tr, "pred_vols") if f.name.endswith("_consenso.nii.gz")]
    assert tc == jc and len(jc) == 2
    for rel in jc:
        assert_volumes_equal(jr / rel, tr / rel)
        cons = tnifti.load(tr / rel)
        assert cons.data.dtype == np.uint8 and 0 < cons.data.mean() < 1
        planes = [tnifti.load(tr / rel.parent / rel.name.replace("consenso", p)).data > 0
                  for p in PLANES]
        np.testing.assert_array_equal(cons.data, (np.sum(planes, axis=0) >= 2).astype(np.uint8))
    assert consensus["out"]["port"]["s5"] == consensus["out"]["jax"]["s5"] == [True, None]


def test_stage6_consensus_and_stage7_jsons_equal_jax(chain, consensus):
    jr, tr = consensus["jax"], consensus["port"]
    jres = [f for f in tree_files(jr, "results") if "consenso" in f.name or "global" in f.name]
    tres = [f for f in tree_files(tr, "results") if "consenso" in f.name or "global" in f.name]
    # P1, P2, fold 1, the planted fold 2, and the two global files
    assert tres == jres and len(jres) == 6
    for rel in jres:
        assert_json_files_equal(jr / rel, tr / rel)
    jo, to = consensus["out"]["jax"], consensus["out"]["port"]
    assert to["prom_incomplete"] is jo["prom_incomplete"] is False
    assert json_equal(to["s6"][0], jo["s6"][0]) and to["s6"][1] is jo["s6"][1] is None
    assert json_equal(to["s7"][:2], jo["s7"][:2]) and to["s7"][2:] == jo["s7"][2:] == [None, None]
    g = json.loads((tr / jres[-1]).read_text())
    assert g["DSC"]["std"] > 0  # the sample std across two folds that differ


# --------------------------------------------------------------------------
# control flow: missing preconditions behave alike in both packages
# --------------------------------------------------------------------------


def _outcome(fn):
    try:
        return ("ok", fn())
    except Exception as e:  # noqa: BLE001 - the type is what is compared
        return ("raises", type(e))


@pytest.mark.parametrize("what", [
    "s1_no_dataset", "s1_patient_mode", "s3_no_model", "s3_no_images", "s3_patient_mode",
    "s4_no_gt", "s4_no_predictions", "s4_patient_mode", "s4_empty_volume_is_rebuilt",
    "s4_invalid_volume_is_rebuilt", "s4_index_out_of_range", "s4_wrong_slice_shape",
    "s5_missing_plane", "s5_no_fold_dir", "s6_fold_without_volumes", "s6_patient_without_volume",
    "s6_shape_mismatch", "s7_missing_fold_json",
])
def test_missing_preconditions_behave_alike(chain, tmp_path, what):
    """Each package runs the same broken situation on its own copy of the
    port's finished tree (checkpoints aside: no case here serves)."""
    case = chain["case"]
    got = {}
    for pkg in ("jax", "port"):
        p = PKGS[pkg]
        root = tmp_path / pkg
        for top in ("MSLesSeg-Dataset", "GT", "datasets", "pred_vols", "results"):
            shutil.copytree(chain["roots"]["port"] / top, root / top)
        m = modelo(p["M"], "axial", case)
        pac_mod = jpac if pkg == "jax" else tpac
        pac = pac_mod.Paciente(id="P1", plano="axial", modalidad=m.modalidad, mejora=m.mejora,
                               dataset_dir=root / "MSLesSeg-Dataset" / "train")
        fold = dict(modelo=m, epochs=EPOCHS, k_folds=K_FOLDS, fold_test=1, root=root)
        one = dict(modelo=m, epochs=EPOCHS, k_folds=K_FOLDS, paciente=pac, root=root)
        kw = p["kw"]
        cr = p["paths"].ConfigRecVol(**fold)
        if what == "s1_no_dataset":
            shutil.rmtree(root / "MSLesSeg-Dataset")
            cfg = p["paths"].ConfigDataset(modelo=m, k_folds=K_FOLDS, completo=True, root=root)
            got[pkg] = _outcome(lambda: p["ext"].ejecutar_flujo_dataset(cfg, **kw))
        elif what == "s1_patient_mode":
            cfg = p["paths"].ConfigDataset(modelo=m, k_folds=K_FOLDS, paciente=pac, root=root)
            first = _outcome(lambda: p["ext"].ejecutar_flujo_dataset(cfg, **kw))
            shutil.rmtree(cfg.paciente_dir["labels"])
            second = _outcome(lambda: p["ext"].ejecutar_flujo_dataset(cfg, **kw))
            got[pkg] = (first, second, len(list(cfg.paciente_dir["labels"].iterdir())))
        elif what == "s3_no_model":
            cfg = p["paths"].ConfigPred(**fold)
            got[pkg] = _outcome(lambda: p["gen"].ejecutar_flujo_pred(cfg, **kw))
        elif what == "s3_no_images":
            cfg = p["paths"].ConfigPred(**fold)
            d = cfg.paciente_dirs("P1")
            shutil.rmtree(d["pred_masks"])
            shutil.rmtree(d["images"])
            d["images"].mkdir()
            args = ("P1", cfg, {})
            got[pkg] = (
                _outcome(lambda: p["gen"].procesar_paciente_predicciones(*args, **kw)),
                _outcome(lambda: p["gen"].procesar_paciente_predicciones("P2", cfg, {}, **kw)),
                p["gen"].predicciones_completas(d),
                p["gen"].predicciones_completas(cfg.paciente_dirs("P2")),
            )
        elif what == "s3_patient_mode":
            cfg = p["paths"].ConfigPred(**one)  # no weights in this copy
            got[pkg] = (cfg.fold_test, cfg.es_paciente_individual,
                        _outcome(lambda: p["gen"].ejecutar_flujo_pred(cfg, **kw)))
        elif what == "s4_no_gt":
            shutil.rmtree(root / "GT")
            got[pkg] = _outcome(lambda: p["rec"].ejecutar_flujo_recvol(cr, **kw))
        elif what == "s4_no_predictions":
            cr.vol_path("P1").unlink()
            shutil.rmtree(cr.pred_masks_dir("P1"))
            got[pkg] = (_outcome(lambda: p["rec"].ejecutar_flujo_recvol(cr, **kw)),
                        cr.vol_path("P1").exists())
        elif what == "s4_patient_mode":
            cfg = p["paths"].ConfigRecVol(**one)
            first = _outcome(lambda: p["rec"].ejecutar_flujo_recvol(cfg, **kw))
            good = jnifti.load(cfg.vol_path("P1")).data
            cfg.vol_path("P1").unlink()
            second = _outcome(lambda: p["rec"].ejecutar_flujo_recvol(cfg, **kw))
            np.testing.assert_array_equal(jnifti.load(cfg.vol_path("P1")).data, good)
            got[pkg] = (first, second)
        elif what in ("s4_empty_volume_is_rebuilt", "s4_invalid_volume_is_rebuilt"):
            vp = cr.vol_path("P1")
            good = jnifti.load(vp).data
            if what.startswith("s4_empty"):
                jnifti.save(np.zeros(SHAPE, np.float32), AFFINE, vp)
            else:
                vp.write_bytes(b"not a nifti file")
            got[pkg] = _outcome(lambda: p["rec"].ejecutar_flujo_recvol(cr, **kw))
            np.testing.assert_array_equal(jnifti.load(vp).data, good)
            # a volume of another shape is rebuilt too
            jnifti.save(np.ones((4, 5, 6), np.float32), AFFINE, vp)
            assert p["rec"].procesar_paciente_vol("P1", cr, **kw) is True
            np.testing.assert_array_equal(jnifti.load(vp).data, good)
        elif what == "s4_index_out_of_range":
            cr.vol_path("P1").unlink()
            d = cr.pred_masks_dir("P1")
            mods = "".join(m.modalidad)
            jpng.save_gray(d / f"P1_{mods}_{SHAPE[2]}.png", np.zeros(SHAPE[:2], np.uint8))
            got[pkg] = (
                _outcome(lambda: p["rec"].procesar_paciente_vol("P1", cr, **kw)),
                _outcome(lambda: p["rec"].ejecutar_flujo_recvol(cr, **kw)),
                cr.vol_path("P1").exists(),
                _outcome(lambda: p["rec"].validar_corte(np.zeros(SHAPE[:2]), SHAPE, "axial", -1)),
                _outcome(lambda: p["rec"].validar_corte(np.zeros(SHAPE[:2]), SHAPE, "axial", 23)),
                p["rec"].extraer_indice_png("P1_FLAIR_17.png"),
                p["rec"].extraer_indice_png("P1_FLAIR.png"),
            )
        elif what == "s4_wrong_slice_shape":
            cr.vol_path("P1").unlink()
            first = sorted(cr.pred_masks_dir("P1").glob("*.png"))[0]
            jpng.save_gray(first, np.zeros((SHAPE[1], SHAPE[0]), np.uint8))
            got[pkg] = _outcome(lambda: p["rec"].procesar_paciente_vol("P1", cr, **kw))
        elif what == "s5_missing_plane":
            cc = p["paths"].ConfigConsenso(umbral=2, **fold)
            for f in cc.pred_vols_fold_dir.rglob("*_consenso.nii.gz"):
                f.unlink()
            cc.vol_paths("P1")["coronal"].unlink()
            cons = jcons if pkg == "jax" else tcons
            got[pkg] = (_outcome(lambda: cons.ejecutar_flujo_consenso(cc, **kw)),
                        cc.consenso_path("P1").exists(), cc.consenso_path("P2").exists())
        elif what == "s5_no_fold_dir":
            cc = p["paths"].ConfigConsenso(umbral=3, **{**fold, "fold_test": 2})
            cons = jcons if pkg == "jax" else tcons
            got[pkg] = _outcome(lambda: cons.ejecutar_flujo_consenso(cc, **kw))
        elif what == "s6_fold_without_volumes":
            ce = p["paths"].ConfigEval(**{**fold, "fold_test": 2})
            got[pkg] = (_outcome(lambda: p["ev"].ejecutar_flujo_eval(ce, **kw)),
                        ce.results_fold_json.exists())
        elif what == "s6_patient_without_volume":
            ce = p["paths"].ConfigEval(**one)
            first = _outcome(lambda: p["ev"].ejecutar_flujo_eval(ce, **kw))
            ce.paths_paciente("P1")["results_json"].unlink()
            second = _outcome(lambda: p["ev"].ejecutar_flujo_eval(ce, **kw))
            ce.paths_paciente("P1")["pred_vol"].unlink()
            third = _outcome(lambda: p["ev"].ejecutar_flujo_eval(ce, **kw))
            got[pkg] = (first, second, third)
        elif what == "s6_shape_mismatch":
            ce = p["paths"].ConfigEval(**one)
            paths = ce.paths_paciente("P1")
            paths["results_json"].unlink()
            jnifti.save(np.ones((4, 5, 6), np.float32), AFFINE, paths["pred_vol"])
            got[pkg] = (_outcome(lambda: p["ev"].ejecutar_flujo_eval(ce, **kw)),
                        paths["results_json"].exists())
        elif what == "s7_missing_fold_json":
            prom = jprom if pkg == "jax" else tprom
            ce = p["paths"].ConfigEval(**fold)
            for f in ce.config_dir.rglob("global_*"):
                f.unlink()
            (ce.config_dir / "fold2" / "fold2_axial_results.json").unlink(missing_ok=True)
            got[pkg] = (_outcome(lambda: prom.ejecutar_flujo_promediar(ce)),
                        _outcome(lambda: prom.leer_metricas_folds(ce)),
                        ce.global_json.exists())
    assert json_equal(_plain(got["port"]), _plain(got["jax"])), (got["port"], got["jax"])


def _plain(x):
    """Tuples to lists, so `json_equal` compares nested outcomes."""
    if isinstance(x, (tuple, list)):
        return [_plain(v) for v in x]
    return x


# --------------------------------------------------------------------------
# stage 0, labels, slice counts, the small helpers
# --------------------------------------------------------------------------


def test_setup_stage_from_a_local_zip_matches_jax(tmp_path):
    import zipfile

    blob_path = tmp_path / "blob.nii.gz"
    jnifti.save(np.ones((4, 4, 4), np.float32), np.eye(4), blob_path)
    blob = blob_path.read_bytes()
    zpath = tmp_path / "MSLesSeg.zip"
    with zipfile.ZipFile(zpath, "w") as z:
        z.writestr("MSLesSeg-Dataset/train/P1/T1/P1_T1_FLAIR.nii.gz", blob)
        z.writestr("MSLesSeg-Dataset/train/P1/T1/P1_T1_MASK.nii.gz", blob)
        z.writestr("MSLesSeg-Dataset/train/P2/P2_FLAIR.nii.gz", blob)
        z.writestr("MSLesSeg-Dataset/train/P2/P2_MASK.nii.gz", blob)
        z.writestr("MSLesSeg-Dataset/train/P3/P3_FLAIR.nii.gz", blob)  # no mask
        z.writestr("MSLesSeg-Dataset/test/P54/P54_FLAIR.nii.gz", blob)
        z.writestr("MSLesSeg-Dataset/test/P54/P54_MASK.nii.gz", blob)
        z.writestr("MSLesSeg-Dataset/info_dataset/readme.txt", b"skip me")
    trees = {}
    for name, stage in (("jax", jsetup), ("port", tsetup)):
        work = tmp_path / name
        work.mkdir()
        with Env(cwd=work):
            assert stage.ejecutar_flujo_setup(zip_path=zpath) is True
            first = tree_files(work, "MSLesSeg-Dataset", "GT")
            before = stamps(work, first)
            # the existing-directory path: nothing is unpacked or copied again
            assert stage.ejecutar_setup_pipeline() is True
            assert stamps(work, first) == before
            (work / "GT" / "stale").mkdir()
            assert stage.ejecutar_flujo_setup(limpiar=True) is True
            assert not (work / "GT" / "stale").exists()
        trees[name] = tree_files(work, "MSLesSeg-Dataset", "GT")
    assert trees["port"] == trees["jax"]
    assert Path("GT/train/P2/P2_MASK.nii.gz") in trees["port"]
    assert Path("GT/test/P54/P54_MASK.nii.gz") in trees["port"]
    assert not any("info_dataset" in f.parts or "P3" in f.parts[:3] and f.parts[0] == "GT"
                   for f in trees["port"])
    assert tsetup.FIGSHARE_URL == jsetup.FIGSHARE_URL
    assert vars(tsetup.parsear_args(["--zip", "a.zip", "--limpiar"])) == \
        vars(jsetup.parsear_args(["--zip", "a.zip", "--limpiar"]))


GOLDEN = Path(__file__).parent / "goldens" / "labels"
GOLDEN_CASES = sorted(p.stem[: -len("_mask")] for p in GOLDEN.glob("*_mask.npy"))


def _random_blobs(seed):
    from scipy import ndimage

    rng = np.random.default_rng(seed)
    field = ndimage.gaussian_filter(rng.normal(size=(40, 52)), 2.0 + seed % 3)
    mask = (field > np.quantile(field, 0.8)).astype(np.uint8)
    mask[rng.integers(0, 40, 6), rng.integers(0, 52, 6)] = 1  # specks
    return mask


@pytest.mark.parametrize("case", GOLDEN_CASES + [f"random{i}" for i in range(6)] + ["empty"])
def test_label_text_equals_the_jax_package(tmp_path, case):
    if case == "empty":
        mask = np.zeros((12, 9), np.uint8)
    elif case.startswith("random"):
        mask = _random_blobs(int(case[6:]))
    else:
        mask = np.load(GOLDEN / f"{case}_mask.npy")
    jlabels.write_yolo_seg_label(mask, tmp_path / "j" / "l.txt")
    tlabels.write_yolo_seg_label(mask, tmp_path / "t" / "l.txt")
    text = (tmp_path / "t" / "l.txt").read_bytes()
    assert text == (tmp_path / "j" / "l.txt").read_bytes()
    assert tlabels.mask_to_polygons(mask) == jlabels.mask_to_polygons(mask)
    if case != "empty":
        assert text.startswith(b"0 ")
    else:
        assert text == b""


@pytest.mark.parametrize("num_cortes", [4, None, "P50", "P90", "Q3"])
def test_slice_count_resolution_matches_jax(chain, num_cortes):
    ds = chain["roots"]["port"] / "MSLesSeg-Dataset" / "train"
    args = dict(num_cortes=num_cortes, input_dir=ds, plano="coronal", modalidad=["FLAIR"])
    want = _outcome(lambda: jslices.resolver_num_cortes(**args))
    assert _outcome(lambda: tslices.resolver_num_cortes(**args)) == want
    if num_cortes == "P50":
        assert want == ("ok", (9, 50))  # lesion spans 10, 9 and 8 coronal slices


@pytest.mark.parametrize("valor", ["12", "P50", "p10", "P", "x3", "1.5"])
def test_int_o_percentil_matches_jax(valor):
    assert _outcome(lambda: tslices.int_o_percentil(valor)) == \
        _outcome(lambda: jslices.int_o_percentil(valor))


def test_small_helpers_match_jax(chain):
    from tpu_mslesseg.core import geometry as jgeo
    from tpu_mslesseg.evalx import metrics as jmx
    from tpu_mslesseg.infer import reconstruct as jrecon
    from tpu_mslesseg.pipeline import logging_setup as jlog
    from tpu_mslesseg_torch.core import geometry as tgeo
    from tpu_mslesseg_torch.evalx import metrics as tmx
    from tpu_mslesseg_torch.infer import reconstruct as trecon
    from tpu_mslesseg_torch.pipeline import logging_setup as tlog

    rng = np.random.default_rng(8)
    x = rng.normal(300, 90, (3, 12, 15)).astype(np.float32)
    x[1] = 7.0  # a flat slice maps to 0
    np.testing.assert_array_equal(tgeo.minmax_to_uint8(torch.from_numpy(x)).numpy(),
                                  np.asarray(jgeo.minmax_to_uint8(x)))
    np.testing.assert_array_equal(tgeo.minmax_to_uint8(torch.from_numpy(x[0])).numpy(),
                                  np.asarray(jgeo.minmax_to_uint8(x[0])))
    gt = (rng.random(SHAPE) > 0.7).astype(np.float32)
    pred = (rng.random(SHAPE) > 0.6).astype(np.float32)
    for name in ("DSC", "precision", "recall", "AUC"):
        assert getattr(tmx, name)(gt, pred) == getattr(jmx, name)(gt, pred), name
    assert math.isnan(tmx.AUC(np.zeros(SHAPE), pred)) and math.isnan(jmx.AUC(np.zeros(SHAPE), pred))
    for a, b in (((2, 3, 4), (2, 3, 4)), ((2, 3, 4), [2, 3, 4]), ((2, 3, 4), (2, 4, 3))):
        assert trecon.reconstruccion_valida(a, b) == jrecon.reconstruccion_valida(a, b)
    for res in ([], [None, None], [True, True], [True, None], [False], [True, False]):
        assert tlog.evaluate_results(res) == jlog.evaluate_results(res)
    for name in ("P12", "P3_T1", "fold", "xP7y"):
        assert tpac.obtener_id(name) == jpac.obtener_id(name)
    ds = chain["roots"]["port"] / "MSLesSeg-Dataset" / "train"
    jp = jpac.Paciente(id="P2", plano="sagital", modalidad=["T1", "FLAIR"], dataset_dir=ds)
    tp = tpac.Paciente(id="P2", plano="sagital", modalidad=["T1", "FLAIR"], dataset_dir=ds)
    jimg, timg = jp.cortes_con_lesion_img(4), tp.cortes_con_lesion_img(4)
    assert list(timg) == list(jimg)
    for mod in jimg:
        assert [i for i, _ in timg[mod]] == [i for i, _ in jimg[mod]]
        for (_, a), (_, b) in zip(timg[mod], jimg[mod]):
            np.testing.assert_array_equal(a, b)
    for (i, a), (j, b) in zip(tp.cortes_con_lesion_mask(4), jp.cortes_con_lesion_mask(4)):
        assert i == j
        np.testing.assert_array_equal(a, b)


def test_lt_equals_jax_on_stretched_slices_and_within_a_level_elsewhere():
    """LT equals the JAX package wherever the pipeline calls it: on slices
    stretched to a maximum of 255 (`normalize_to_uint8` comes first), for
    every value, and on blank ones. For other maxima the two packages' f32
    ``log1p`` of the maximum differ by an ulp on the CPU for some, and LT by
    one level there (ROADMAP section C)."""
    from tpu_mslesseg.preproc import enhance as jenh

    rows = np.stack([np.minimum(np.arange(256), m) for m in range(256)]).astype(np.uint8)
    imgs = np.tile(rows[:, None, :], (1, 3, 1))  # image m holds 0..m, three rows
    got = tenh.lt_batch(torch.from_numpy(imgs))
    assert got.dtype == torch.uint8 and tuple(got.shape) == imgs.shape
    want = np.asarray(jenh.lt_batch(imgs))
    for m in (0, 255):
        np.testing.assert_array_equal(got[m].numpy(), want[m])
    assert int(np.abs(got.numpy().astype(int) - want.astype(int)).max()) <= 1
    assert got[255, 0, 255] == 255 and got[255, 0, 0] == 0
    rng = np.random.default_rng(6)
    raw = rng.normal(400, 120, (5, 24, 28)).astype(np.float32)
    raw[2] = 0.0  # a blank slice
    np.testing.assert_array_equal(tenh.enhance_batch(torch.from_numpy(raw), "LT").numpy(),
                                  np.asarray(jenh.enhance_batch(raw, "LT")))


class _Recorder:
    def __init__(self):
        self.lines = []

    def __getattr__(self, level):
        return lambda msg: self.lines.append((level, msg))


def test_fold_status_lines_match_jax():
    from tpu_mslesseg.pipeline import logging_setup as jlog
    from tpu_mslesseg_torch.pipeline import logging_setup as tlog

    j, t = _Recorder(), _Recorder()
    for res in (None, True, {"DSC": 1}, [1], "parcial", False):
        jlog.log_fold_status(j, res, 3)
        tlog.log_fold_status(t, res, 3)
    assert t.lines == j.lines and len(t.lines) == 6


def test_stage_timer_records_and_resets():
    from tpu_mslesseg.core import profiling as jprof
    from tpu_mslesseg_torch.core import profiling as tprof

    tprof.reset_timings()
    for _ in range(2):
        with tprof.stage_timer("a"):
            pass
    with pytest.raises(KeyError):
        with tprof.stage_timer("b"):
            raise KeyError("x")
    s = tprof.timings_summary()
    assert set(s) == {"a"} and s["a"]["calls"] == 2
    jprof.reset_timings()
    with jprof.stage_timer("a"):
        pass
    assert set(s["a"]) == set(jprof.timings_summary()["a"])
    tprof.reset_timings()
    jprof.reset_timings()
    assert tprof.timings_summary() == {}


@pytest.mark.parametrize("stage", ["extraer_dataset", "generar_predicciones",
                                   "reconstruir_volumen", "generar_consenso", "eval",
                                   "promediar_folds"])
def test_stage_cli_arguments_match_jax(stage):
    import importlib

    j = importlib.import_module(f"tpu_mslesseg.pipeline.stages.{stage}")
    t = importlib.import_module(f"tpu_mslesseg_torch.pipeline.stages.{stage}")
    plano = [] if stage == "generar_consenso" else ["--plano", "axial"]
    target = {"extraer_dataset": ["--completo"], "promediar_folds": []}.get(
        stage, ["--fold_test", "2"])
    argvs = [
        plano + ["--num_cortes", "P50"] + target,
        plano + ["--num_cortes", "12", "--modalidad", "FLAIR", "T1", "--mejora", "CLAHE",
                 "--k_folds", "3"] + target,
    ]
    if stage not in ("extraer_dataset",):
        argvs.append(plano + ["--num_cortes", "5", "--epochs", "7"] + target)
    if stage != "promediar_folds":
        argvs.append(plano + ["--num_cortes", "5", "--paciente_id", "P9", "--limpiar"])
    for argv in argvs:
        assert vars(t.parsear_args(argv)) == vars(j.parsear_args(argv)), argv
    for bad in (plano + target, plano + ["--num_cortes", "5", "--mejora", "XX"] + target):
        with pytest.raises(SystemExit):
            t.parsear_args(bad)


def test_stage_entry_points_default_to_the_card(chain):
    """Every entry point that computes names ``device="cuda"`` as its
    default, and without a card it raises before it touches a patient."""
    import inspect

    from tpu_mslesseg_torch.core.device import exigir

    fns = [text_.ejecutar_dataset_pipeline, text_.ejecutar_flujo_dataset,
           tgen.ejecutar_predicciones_pipeline, tgen.ejecutar_flujo_pred, tgen.cargar_predictor,
           trec.ejecutar_reconstrucciones_pipeline, trec.ejecutar_flujo_recvol,
           tcons.ejecutar_consenso_pipeline, tcons.ejecutar_flujo_consenso,
           teval.ejecutar_eval_pipeline, teval.ejecutar_flujo_eval]
    for fn in fns:
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn.__name__
    assert exigir("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        pytest.skip("this box has a CUDA device")
    root = chain["roots"]["port"]
    m = modelo(TModelo, "axial", chain["case"])
    files = tree_files(root, "datasets", "pred_vols", "results")
    before = stamps(root, files)
    fold = dict(modelo=m, epochs=EPOCHS, k_folds=K_FOLDS, fold_test=1, root=root)
    for run, cfg in (
        (text_.ejecutar_flujo_dataset,
         tpaths.ConfigDataset(modelo=m, k_folds=K_FOLDS, completo=True, root=root)),
        (tgen.ejecutar_flujo_pred, tpaths.ConfigPred(**fold)),
        (trec.ejecutar_flujo_recvol, tpaths.ConfigRecVol(**fold)),
        (tcons.ejecutar_flujo_consenso, tpaths.ConfigConsenso(**fold)),
        (teval.ejecutar_flujo_eval, tpaths.ConfigEval(**fold)),
    ):
        with pytest.raises(RuntimeError, match="no disponible"):
            run(cfg, limpiar=True)  # the gate comes before the cleanup
    assert stamps(root, files) == before


@pytest.mark.parametrize("error, del_dispositivo", [
    (RuntimeError("CUDA error: an illegal memory access was encountered"), True),
    (RuntimeError("mask union kernel launch failed: CUDA error 98"), True),
    (RuntimeError("nvcc failed for stem.cu (rc 1):\n..."), True),
    (RuntimeError("nvcc not found (PATH, CUDA_HOME)"), True),
    (torch.OutOfMemoryError("out of memory"), True),
    (RuntimeError("shape '[2, 3]' is invalid for input of size 5"), False),
    (ValueError("Dimensiones de corte inválidas"), False),
    (FileNotFoundError("P1_T1_FLAIR.nii.gz"), False),
])
def test_device_failures_are_told_from_data_errors(error, del_dispositivo):
    from tpu_mslesseg_torch.core.device import es_fallo_de_dispositivo

    assert es_fallo_de_dispositivo(error) is del_dispositivo


def test_kernels_named_for_a_stage():
    from tpu_mslesseg_torch.core.device import kernels_de

    assert kernels_de(None) == () and kernels_de("GC") == ()
    assert kernels_de("CLAHE") == ("clahe_tile_lut",)
    assert kernels_de(None, union=True) == ("mask_union", "bn_act")
    assert kernels_de("CLAHE", stem=True, union=True) == ("clahe_tile_lut", "stem", "mask_union",
                                                           "bn_act")
    # every name is a source the build knows
    csrc = Path(tgen.__file__).resolve().parents[2] / "csrc"
    assert all((csrc / f"{n}.cu").is_file() for n in kernels_de("CLAHE", True, True))


@pytest.mark.parametrize("depth", [1, 2, 4])
def test_queue_keeps_order_skips_data_errors_and_raises_device_failures(depth):
    from tpu_mslesseg_torch.pipeline.stages.cola import procesar_en_cola

    events, warned = [], []

    def despachar(pid):
        events.append(("d", pid))
        if pid == "bad_dispatch":
            raise ValueError("unreadable")
        return {"skip": None, "none": False}.get(pid, pid)

    def finalizar(pendiente):
        events.append(("f", pendiente))
        if pendiente == "bad_write":
            raise OSError("disk")
        return True

    pids = ["a", "skip", "bad_dispatch", "b", "none", "bad_write", "c"]
    res = procesar_en_cola(pids, despachar, finalizar, depth, lambda p, e: warned.append(p))
    assert res == [True, None, True, False, True]
    assert warned == ["bad_dispatch", "bad_write"]
    assert [p for k, p in events if k == "f"] == ["a", "b", "bad_write", "c"]
    # no more than `depth` results are ever pending
    pending = worst = 0
    for kind, pid in events:
        if kind == "d" and pid not in ("skip", "none", "bad_dispatch"):
            pending += 1
        elif kind == "f":
            pending -= 1
        worst = max(worst, pending)
    assert worst <= depth

    def falla(pid):
        raise RuntimeError("CUDA error: unspecified launch failure")

    with pytest.raises(RuntimeError, match="CUDA error"):
        procesar_en_cola(["a", "b"], falla, finalizar, depth, lambda p, e: warned.append(p))
    assert warned == ["bad_dispatch", "bad_write"]


@pytest.mark.parametrize("stage", ["s1", "s3", "s5"])
def test_a_kernel_failure_stops_the_stage_instead_of_skipping_patients(
        chain, tmp_path, monkeypatch, stage):
    """A patient's data error is warned about and skipped; a failure of the
    card or of a kernel ends the stage with the error."""
    root = tmp_path / "port"
    shutil.copytree(chain["roots"]["port"], root)
    m = modelo(TModelo, "axial", chain["case"])
    fold = dict(modelo=m, epochs=EPOCHS, k_folds=K_FOLDS, fold_test=1, root=root)

    def falla(*a, **k):
        raise RuntimeError("CLAHE tile-LUT kernel launch failed: CUDA error 209")

    if stage == "s1":
        monkeypatch.setattr(text_, "guardar_cortes", falla)
        run = lambda: text_.ejecutar_flujo_dataset(
            tpaths.ConfigDataset(modelo=m, k_folds=K_FOLDS, completo=True, root=root),
            limpiar=True, device="cpu")
    elif stage == "s3":
        monkeypatch.setattr(tgen, "cargar_predictor", falla)
        run = lambda: tgen.ejecutar_flujo_pred(tpaths.ConfigPred(**fold), limpiar=True,
                                               device="cpu")
    else:
        monkeypatch.setattr(tcons, "consensus_vote", falla)
        run = lambda: tcons.ejecutar_flujo_consenso(tpaths.ConfigConsenso(**fold), limpiar=True,
                                                    device="cpu")
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        run()
