"""The port's host layer and fast serving path (``pipeline/rapido.py``) vs
the JAX package, on one synthetic experiment tree.

The tree is built the way ``tests/test_rapido.py`` and
``tests/test_rapido_fold.py`` build theirs: volumes 24x28x24, FLAIR,
``k_folds=2``, ``TPU_MSLESSEG_IMGSZ=96``, three patients in fold 1, stage-1
image files named as extraction names them (only their names are read).
Each plane has its own weights (JAX ``init`` with perturbed BN statistics
and a detection head that keeps boxes, as in
``tests/test_torch_port_consensus.py``; the mask-coefficient bias is
lowered per plane so that the union logits straddle the threshold and the
masks are mixed, not full), saved side by side as the JAX
package's Orbax ``best.ckpt`` and the port's ``best.pt`` (through the
bridge). Each package serves a copy of the tree from its own checkpoint:
patient mode under GC, fold mode under CLAHE with ``lote_size=2`` (the
second dispatch repeats its last patient). The JAX fold runs on one device,
as the port does (its SPMD path is not ported).

Both serve in float32 (``TPU_MSLESSEG_DTYPE=float32``), as the rest of the
CPU parity suite compares. Every volume must equal JAX's, except voxels
where JAX's sampled mask logit is within 1e-3 of the threshold 0; every
metrics JSON must equal JAX's wherever its volume does.
"""

import json
import os
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_consensus import _jax_logit_volumes, _perturbed
from tpu_mslesseg.infer.consensus3 import ConsensusPredictor as JConsensus
from tpu_mslesseg.io import nifti as jnifti
from tpu_mslesseg.model.yolo11 import create_model as j_create
from tpu_mslesseg.pipeline import paciente as jpac
from tpu_mslesseg.pipeline import paths as jpaths
from tpu_mslesseg.pipeline import rapido as jrapido
from tpu_mslesseg.pipeline.modelo import Modelo as JModelo
from tpu_mslesseg.pipeline.stages import eval as jeval
from tpu_mslesseg.pipeline.stages import generar_predicciones as jgen
from tpu_mslesseg.train import checkpoint as jckpt
from tpu_mslesseg_torch.io import nifti as tnifti
from tpu_mslesseg_torch.model.bridge import state_dict_from_reference
from tpu_mslesseg_torch.model.yolo11 import create_model as t_create
from tpu_mslesseg_torch.pipeline import paciente as tpac
from tpu_mslesseg_torch.pipeline import paths as tpaths
from tpu_mslesseg_torch.pipeline import rapido as trapido
from tpu_mslesseg_torch.pipeline.modelo import Modelo as TModelo
from tpu_mslesseg_torch.pipeline.stages import eval as teval
from tpu_mslesseg_torch.pipeline.stages import generar_predicciones as tgen
from tpu_mslesseg_torch.train import checkpoint as tckpt

SHAPE = (24, 28, 24)
PLANES = ("axial", "coronal", "sagital")
EPOCHS = 1
PIDS = ("P1", "P2", "P3")  # all fold 1 of 2
IMGSZ = 96
# per-plane shift of the mask-coefficient bias: mixed masks at imgsz 96
MASK_BIAS = {"axial": -0.28, "coronal": -0.1, "sagital": -0.14}


def _modelo(mod, plano, mejora):
    return mod(plano=plano, num_cortes=6, modalidad=["FLAIR"], k_folds=2, mejora=mejora)


def _volumes(i, rng):
    vol = rng.normal(500, 150, SHAPE).astype(np.float32)
    mask = np.zeros(SHAPE, np.float32)
    mask[6 + i : 14, 8 + i : 18, 6 : 18 - i] = 1
    vol[mask > 0] += 900.0
    return vol, mask


class _State:
    """The fields the JAX package's ``save_checkpoint`` reads."""

    def __init__(self, v):
        self.params = v["params"]
        self.batch_stats = v["batch_stats"]
        self.ema_params = v["params"]
        self.step = np.int32(1)
        self.opt_state = ()


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    base = tmp_path_factory.mktemp("rapido_port")
    src = base / "src"
    rng = np.random.default_rng(3)
    for i, pid in enumerate(PIDS):
        vol, mask = _volumes(i, rng)
        pdir = src / "MSLesSeg-Dataset" / "train" / pid / "T1"
        jnifti.save(vol, np.eye(4), pdir / f"{pid}_T1_FLAIR.nii.gz")
        jnifti.save(mask, np.eye(4), pdir / f"{pid}_T1_MASK.nii.gz")
        jnifti.save(mask.astype(np.uint8), np.eye(4),
                    src / "GT" / "train" / pid / f"{pid}_MASK.nii.gz")
        for mejora in ("GC", "CLAHE"):
            for plano in PLANES:
                pac = jpac.Paciente(id=pid, plano=plano, modalidad=["FLAIR"],
                                    dataset_dir=src / "MSLesSeg-Dataset" / "train")
                m = _modelo(JModelo, plano, mejora)
                images = src / "datasets" / m.base_path / "fold1" / pid / plano / "images"
                images.mkdir(parents=True)
                for k in pac.indices_a_usar(6):  # stage 1's file names
                    (images / f"{pid}_FLAIR_{k}.png").touch()

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
        gc, clahe = (jpaths.ConfigTrain(modelo=_modelo(JModelo, plano, m), epochs=EPOCHS,
                                        fold_test=1, root=src) for m in ("GC", "CLAHE"))
        jckpt.save_checkpoint(gc.weights_dir / "best.ckpt", _State(jvars[plano]))
        tckpt.save_checkpoint(gc.weights_dir / "best.pt",
                              state_dict_from_reference(jvars[plano], tmodel))
        shutil.copytree(gc.weights_dir, clahe.weights_dir)  # the same weights
    out = {"jax": base / "jax", "port": base / "port", "jvars": jvars, "jmodel": jmodel}
    shutil.copytree(src, out["jax"])
    shutil.copytree(src, out["port"])
    return out


class _Env:
    """cwd at one root, and the serving model at imgsz 96 in float32, for
    the duration."""

    ENV = {"TPU_MSLESSEG_IMGSZ": str(IMGSZ), "TPU_MSLESSEG_DTYPE": "float32"}

    def __init__(self, root):
        self.root = root

    def __enter__(self):
        self.old = os.getcwd()
        self.saved = {k: os.environ.get(k) for k in self.ENV}
        os.environ.update(self.ENV)
        os.chdir(self.root)

    def __exit__(self, *exc):
        os.chdir(self.old)
        for k, v in self.saved.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v


def _serve(pkg, modelo_cls, **kw):
    """Patient mode (GC, P1) and fold mode (CLAHE, lote_size=2)."""
    pac_mod = jpac if pkg is jrapido else tpac
    gc = _modelo(modelo_cls, "axial", "GC")
    pac = pac_mod.Paciente(id="P1", plano="axial", modalidad=["FLAIR"], mejora="GC",
                           dataset_dir="MSLesSeg-Dataset/train")
    assert pkg.ejecutar_paciente_rapido(gc, pac, epochs=EPOCHS, k_folds=2, **kw)
    clahe = _modelo(modelo_cls, "axial", "CLAHE")
    assert pkg.ejecutar_fold_rapido(clahe, epochs=EPOCHS, k_folds=2, fold_test=1,
                                    lote_size=2, **kw)


@pytest.fixture(scope="module")
def served(roots):
    with _Env(roots["jax"]):
        mp = pytest.MonkeyPatch()
        mp.setattr(jrapido, "_mesh_para_servicio", lambda: None)
        try:
            _serve(jrapido, JModelo)
        finally:
            mp.undo()
    with _Env(roots["port"]):
        _serve(trapido, TModelo, device="cpu")
    return roots


def _artifacts(root):
    return sorted(
        p.relative_to(root) for d in ("pred_vols", "results") for p in (root / d).rglob("*")
        if p.is_file()
    )


def _jax_plane_logits(roots, rel):
    """JAX's sampled mask logits for the patient and plane of one volume."""
    exp, pid, name = rel.parts[1], rel.parts[-2], rel.parts[-1]
    mejora = exp
    plane = name.removeprefix(f"{pid}_").removesuffix(".nii.gz")
    slices, idx = {}, {}
    for p in PLANES:
        pac = jpac.Paciente(id=pid, plano=p, modalidad=["FLAIR"],
                            dataset_dir=roots["jax"] / "MSLesSeg-Dataset" / "train")
        ids = np.asarray(pac.indices_a_usar(6))
        slices[p], idx[p] = pac.cortes_imagen_batch(ids, "FLAIR"), ids[None]
    jcp = JConsensus(roots["jmodel"], roots["jvars"], SHAPE, mejora=mejora,
                     imgsz=IMGSZ, umbral=2, per_plane_counts=True)
    logits = {p: v[0] for p, v in _jax_logit_volumes(jcp, slices, idx, 1).items()}
    return logits if plane == "consenso" else {plane: logits[plane]}


def test_rapido_artifacts_equal_jax(served):
    roots = served
    jfiles, tfiles = _artifacts(roots["jax"]), _artifacts(roots["port"])
    # patient P1 under GC, the three fold patients under CLAHE; 3 planes +
    # consenso, a volume and a JSON each
    assert len(jfiles) == (1 + 3) * 4 * 2
    assert tfiles == jfiles
    differ = {}
    for rel in (f for f in jfiles if f.name.endswith(".nii.gz")):
        j = jnifti.load(roots["jax"] / rel).get_fdata()
        t = tnifti.load(roots["port"] / rel).get_fdata()
        assert t.shape == j.shape == SHAPE
        d = j != t
        if d.any():
            logits = _jax_plane_logits(roots, rel)
            near = np.zeros(SHAPE, bool)
            for lg in logits.values():
                near |= np.abs(np.nan_to_num(lg, nan=1.0)) < 1e-3
            assert near[d].all(), (str(rel), int(d.sum()))
            differ[rel.parts[-2:]] = True
    # the masks are mixed: every served slice of every volume is neither
    # empty nor full somewhere
    for rel in (f for f in jfiles if f.name.endswith("_consenso.nii.gz")):
        cons = jnifti.load(roots["jax"] / rel).get_fdata()
        assert 0 < cons.mean() and (cons[6:14, 8:18, 6:18] == 0).any(), str(rel)
    for rel in (f for f in jfiles if f.suffix == ".json"):
        name = rel.name.replace("_results.json", ".nii.gz")
        if (rel.parts[-2], name) in differ:
            continue
        jm = json.loads((roots["jax"] / rel).read_text())
        tm = json.loads((roots["port"] / rel).read_text())
        assert tm == jm, str(rel)


def test_rapido_skips_a_complete_fold_and_limpiar_rewrites(served):
    roots = served
    with _Env(roots["port"]):
        clahe = _modelo(TModelo, "axial", "CLAHE")
        files = _artifacts(roots["port"])
        stamps = [(roots["port"] / f).stat().st_mtime_ns for f in files]
        assert trapido.ejecutar_fold_rapido(clahe, epochs=EPOCHS, k_folds=2, fold_test=1,
                                            lote_size=2, device="cpu")
        assert [(roots["port"] / f).stat().st_mtime_ns for f in files] == stamps

        gc = _modelo(TModelo, "axial", "GC")
        pac = tpac.Paciente(id="P1", plano="axial", modalidad=["FLAIR"], mejora="GC",
                            dataset_dir="MSLesSeg-Dataset/train")
        rel = Path("pred_vols") / f"{gc.base_path}_{EPOCHS}epochs" / "fold1" / "P1"
        vp = rel / "P1_coronal.nii.gz"
        good = tnifti.load(vp).get_fdata()
        tnifti.save(np.zeros(SHAPE, np.float32), np.eye(4), vp)  # a stale volume
        assert trapido.ejecutar_paciente_rapido(gc, pac, epochs=EPOCHS, k_folds=2,
                                                limpiar=True, device="cpu")
        np.testing.assert_array_equal(tnifti.load(vp).get_fdata(), good)


def test_rapido_returns_false_without_its_preconditions(served):
    with _Env(served["port"]):
        lt = _modelo(TModelo, "axial", "LT")  # never trained: no best.pt
        pac = tpac.Paciente(id="P1", plano="axial", modalidad=["FLAIR"], mejora="LT",
                            dataset_dir="MSLesSeg-Dataset/train")
        assert trapido.ejecutar_paciente_rapido(lt, pac, epochs=EPOCHS, k_folds=2,
                                                device="cpu") is False
        gc = _modelo(TModelo, "axial", "GC")
        assert trapido.ejecutar_fold_rapido(gc, epochs=EPOCHS, k_folds=2, fold_test=2,
                                            device="cpu") is False
        # a JAX checkpoint directory alone is not a port checkpoint
        cfg = tpaths.ConfigTrain(modelo=gc, epochs=EPOCHS, fold_test=1)
        (cfg.weights_dir / "best.pt").rename(cfg.weights_dir / "moved.pt")
        try:
            assert (cfg.weights_dir / "best.ckpt").is_dir()
            assert trapido.ejecutar_paciente_rapido(gc, pac, epochs=EPOCHS, k_folds=2,
                                                    device="cpu") is False
        finally:
            (cfg.weights_dir / "moved.pt").rename(cfg.weights_dir / "best.pt")


# --------------------------------------------------------------------------
# host layer
# --------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.float32, np.uint8, np.int16, np.float64])
def test_nifti_round_trips_across_packages(tmp_path, dtype):
    rng = np.random.default_rng(4)
    data = (rng.uniform(0, 100, (5, 6, 7))).astype(dtype)
    affine = np.array([[-1.0, 0, 0, 90], [0, 1.2, 0, -126], [0, 0, 0.9, -72], [0, 0, 0, 1]])
    for writer, reader in ((tnifti, tnifti), (tnifti, jnifti), (jnifti, tnifti)):
        path = tmp_path / f"{writer.__name__}_{reader.__name__}.nii.gz"
        writer.save(data, affine, path)
        img = reader.load(path)
        assert img.data.dtype == data.dtype
        np.testing.assert_array_equal(img.data, data)
        np.testing.assert_allclose(img.affine, affine, rtol=0, atol=1e-6)
        np.testing.assert_array_equal(reader.load_header(path)[1], img.affine)
    plain = tmp_path / "plain.nii"
    tnifti.save(tnifti.NiftiImage(data, affine), path=plain)
    np.testing.assert_array_equal(jnifti.load(plain).get_fdata(), data.astype(np.float64))


def test_paciente_fold_and_listing_match_jax(roots):
    ds = roots["jax"] / "MSLesSeg-Dataset" / "train"
    for plano in PLANES:
        j = jpac.Paciente(id="P2", plano=plano, modalidad=["FLAIR"], dataset_dir=ds)
        t = tpac.Paciente(id="P2", plano=plano, modalidad=["FLAIR"], dataset_dir=ds)
        assert t.indices_cortes_con_lesion() == j.indices_cortes_con_lesion()
        assert t.indices_a_usar(6) == j.indices_a_usar(6)
        assert t.num_cortes == j.num_cortes
        assert t.volumen_path("FLAIR") == j.volumen_path("FLAIR")
        ids = j.indices_a_usar(6)
        got = t.cortes_imagen_batch(ids, "FLAIR")
        assert got.dtype == np.float32 and got.flags.c_contiguous
        np.testing.assert_array_equal(got, j.cortes_imagen_batch(ids, "FLAIR"))
        np.testing.assert_array_equal(t.cortes_mascara_batch(ids), j.cortes_mascara_batch(ids))
    for k in (2, 5, 10):
        for n in range(1, 54):
            assert tpac.calcular_fold(f"P{n}", k) == jpac.calcular_fold(f"P{n}", k)
    (ds / "P40.tmp").mkdir()
    (ds / "README").touch()
    try:
        assert tpac.listar_pacientes(ds) == jpac.listar_pacientes(ds) == list(PIDS)
    finally:
        (ds / "P40.tmp").rmdir()
        (ds / "README").unlink()
    with pytest.raises(FileNotFoundError):
        tpac.listar_pacientes(roots["jax"] / "GT")


def _swap_ckpt(p):
    return Path(str(p).replace("best.ckpt", "best.pt"))


def test_paths_match_jax_but_for_the_checkpoint_file(roots):
    root = roots["jax"]
    for mejora in (None, "CLAHE"):
        for plano in PLANES:
            jm, tm = _modelo(JModelo, plano, mejora), _modelo(TModelo, plano, mejora)
            assert tpaths.construir_nombre_configuracion(tm, 3) == \
                jpaths.construir_nombre_configuracion(jm, 3)
            jt = jpaths.ConfigTrain(modelo=jm, epochs=EPOCHS, fold_test=1, root=root)
            tt = tpaths.ConfigTrain(modelo=tm, epochs=EPOCHS, fold_test=1, root=root)
            for attr in ("dataset_entrada", "gt_dir", "output_dir", "fold_dir", "weights_dir"):
                assert getattr(tt, attr) == getattr(jt, attr), attr
            assert tt.best_ckpt == _swap_ckpt(jt.best_ckpt) and tt.best_ckpt.name == "best.pt"
            assert tpaths.existe_modelo_entrenado(tm, EPOCHS, 1, root) == \
                jpaths.existe_modelo_entrenado(jm, EPOCHS, 1, root) == (mejora == "CLAHE")
            jpac_ = jpac.Paciente(id="P3", plano=plano, modalidad=["FLAIR"], dataset_dir=root)
            tpac_ = tpac.Paciente(id="P3", plano=plano, modalidad=["FLAIR"], dataset_dir=root)
            jp = jpaths.ConfigPred(modelo=jm, epochs=EPOCHS, k_folds=2, paciente=jpac_, root=root)
            tp = tpaths.ConfigPred(modelo=tm, epochs=EPOCHS, k_folds=2, paciente=tpac_, root=root)
            assert tp.fold_test == jp.fold_test == 1
            assert (tp.model_dir, tp.dataset_fold_dir) == (jp.model_dir, jp.dataset_fold_dir)
            assert tp.model_path == _swap_ckpt(jp.model_path)
            assert tp.paciente_dirs("P3") == jp.paciente_dirs("P3")
            jc = jpaths.ConfigConsenso(modelo=jm, epochs=EPOCHS, k_folds=2, paciente=jpac_,
                                       root=root)
            tc = tpaths.ConfigConsenso(modelo=tm, epochs=EPOCHS, k_folds=2, paciente=tpac_,
                                       root=root)
            assert tc.vol_paths("P3") == jc.vol_paths("P3")
            assert (tc.consenso_path("P3"), tc.gt_path("P3")) == \
                (jc.consenso_path("P3"), jc.gt_path("P3"))
            for forced in (None, "consenso"):
                je = jpaths.ConfigEval(modelo=jm, epochs=EPOCHS, k_folds=2, paciente=jpac_,
                                       plano_forzado=forced, root=root)
                te = tpaths.ConfigEval(modelo=tm, epochs=EPOCHS, k_folds=2, paciente=tpac_,
                                       plano_forzado=forced, root=root)
                assert te.paths_paciente("P3") == je.paths_paciente("P3")
                for attr in ("results_fold_dir", "results_fold_json", "global_json",
                             "pred_vols_fold_dir"):
                    assert getattr(te, attr) == getattr(je, attr), attr
                assert te.fold_jsons() == je.fold_jsons()


def test_image_indices_json_and_checkpoint(tmp_path):
    images = tmp_path / "images"
    images.mkdir()
    for name in ("P7_FLAIR_12.png", "P7_FLAIR_3.png", "P7_T1_12.png", "P7_12_mask.png",
                 "notes.png", "P7_FLAIR_40.txt", "P7_FLAIR_8.png"):
        (images / name).touch()
    assert tgen.indices_de_imagenes(images) == jgen.indices_de_imagenes(images) == [3, 8, 12]
    assert tgen._SLICE_RE.pattern == jgen._SLICE_RE.pattern
    met = {"DSC": 0.5, "AUC": float("nan"), "Precision": 0.25, "Recall": 1.0}
    teval.escribir_json(met, tmp_path / "t" / "r.json")
    jeval.escribir_json(met, tmp_path / "j" / "r.json")
    assert (tmp_path / "t" / "r.json").read_bytes() == (tmp_path / "j" / "r.json").read_bytes()

    sd = {"a.weight": torch.arange(6.0).reshape(2, 3), "n": torch.tensor(3)}
    path = tmp_path / "w" / "best.pt"
    assert not tckpt.checkpoint_exists(path)
    tckpt.save_checkpoint(path, sd)
    assert tckpt.checkpoint_exists(path) and not list(path.parent.glob("*.tmp"))
    back = tckpt.load_checkpoint(path)
    assert set(back) == set(sd) and all(torch.equal(back[k], sd[k]) for k in sd)
    assert not tckpt.checkpoint_exists(tmp_path / "w")  # a directory is not one
