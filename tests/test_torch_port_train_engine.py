"""The port's fold-training engine (``train/engine.py``) against the JAX package's.

One JAX ``train_fold`` and one port ``train_fold`` (float32, CPU) on the same
tree (``test_torch_port_stages``'s: fold 1 of 2, 6 train slices of P30, 12
val slices of P1 and P2, FLAIR under CLAHE) with the same options: imgsz 64,
4 epochs, ``close_mosaic`` 2, ``save_period`` 1, ``patience`` 1, batch 8
(which the dataset rule shrinks to 4). The fitness is stubbed in both with
the sequence 0.1, 0.1, 0.05, ... (a tie counts as an improvement, then one
validation without one stops the run at epoch 3 of 4). The JAX run is made
once, in a module fixture: it compiles two epoch programs and a validation
step, most of this file's time.

Compared: the artifact sets (``args.yaml`` parsed, the ``results.csv``
header, rows and epoch column, the ``lr/pg*`` columns within 1e-7, which
weight files exist and ``fitness.json``) and the decisions (the batch after
the rules, ``steps_per_epoch``, which epochs ran the mosaic, validated and
saved which files, the epoch the stop came at). Loss values are not
compared across the frameworks: the two draw their batches from different
generators, and training at this size is chaotic (ROADMAP C6), so the same
step on two frameworks' batches says nothing about either.

Port only: a 4-epoch run equals a run interrupted after epoch 2 and resumed
from its ``last.pt`` (parameters, EMA, BatchNorm statistics, optimizer
state, ``results.csv`` but for its time column, and the batches drawn),
exactly.
"""

import csv
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from test_torch_port_stages import write_dataset
from tpu_mslesseg.model.yolo11 import create_model as j_create
from tpu_mslesseg.train import checkpoint as jckpt
from tpu_mslesseg.train import data as jdata
from tpu_mslesseg.train import engine as jengine
from tpu_mslesseg.train import trainer as jtrainer
from tpu_mslesseg.train import validate as jval
from tpu_mslesseg.train.trainer import TrainConfig as JConfig
from tpu_mslesseg_torch.model.yolo11 import create_model as t_create
from tpu_mslesseg_torch.train import augment as taug
from tpu_mslesseg_torch.train import checkpoint as tckpt
from tpu_mslesseg_torch.train import data as tdata
from tpu_mslesseg_torch.train import engine as tengine
from tpu_mslesseg_torch.train import trainer as ttrainer
from tpu_mslesseg_torch.train import validate as tval
from tpu_mslesseg_torch.train.trainer import TrainConfig as TConfig
from torch_threads import one_torch_thread  # noqa: F401

OPTS = dict(epochs=4, batch_size=8, imgsz=64, max_fg=8, close_mosaic=2, save_period=1,
            patience=1, plots=False, amp=False)
FITS = [0.1, 0.1, 0.05, 0.3]
FOLD = dict(fold_test=1, patients=["P1", "P2", "P30"], plano="axial", modalidades=["FLAIR"],
            mejora="CLAHE", num_cortes=6, k_folds=2)


def _spy(mp, engine, data, trainer, validate, checkpoint):
    """Records the engine's decisions through the functions it calls."""
    log = {"mosaic": [], "validated": 0, "saved": [], "init": []}
    fits = iter(FITS)
    mp.setattr(engine, "fitness", lambda m: next(fits))

    def wrap(mod, name, record):
        real = getattr(mod, name)

        def spy(*a, **kw):
            record(*a, **kw)
            return real(*a, **kw)

        mp.setattr(mod, name, spy)

    wrap(data, "epoch_indices", lambda *a, **kw: log["mosaic"].append(bool(a[3])))
    wrap(validate, "run_validation", lambda *a, **kw: log.__setitem__(
        "validated", log["validated"] + 1))
    wrap(checkpoint, "save_checkpoint", lambda path, *a, **kw: log["saved"].append(
        (len(log["mosaic"]), path.name.rsplit(".", 1)[0])))
    wrap(trainer, "init_train_state", lambda model, cfg, spe, *a, **kw: log["init"].append(
        (cfg.batch_size, spe)))
    return log


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("engine")
    write_dataset(root)
    ds = root / "MSLesSeg-Dataset" / "train"
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        log = _spy(mp, jengine, jdata, jtrainer, jval, jckpt)
        model, _ = j_create(nc=1, scale="n", dtype=jnp.float32, remat=False)
        summary = jengine.train_fold(model=model, dataset_dir=ds, output_dir=root / "jax",
                                     cfg=JConfig(remat=False, **OPTS), **FOLD)
        out["jax"] = (root / "jax", log, summary)
    with pytest.MonkeyPatch.context() as mp:
        log = _spy(mp, tengine, tdata, ttrainer, tval, tckpt)
        model, _ = t_create(nc=1, scale="n", remat=False)
        summary = tengine.train_fold(model=model, dataset_dir=ds, output_dir=root / "port",
                                     cfg=TConfig(remat=False, **OPTS), device="cpu", **FOLD)
        out["port"] = (root / "port", log, summary)
    return out


def _rows(path):
    with open(path / "results.csv") as f:
        return list(csv.reader(f))


def test_args_yaml_equals_jax(runs):
    j = yaml.safe_load((runs["jax"][0] / "args.yaml").read_text())
    t = yaml.safe_load((runs["port"][0] / "args.yaml").read_text())
    assert t == j and t["remat"] is False
    assert list(t) == sorted(t)


def test_results_csv_equals_jax(runs):
    j, t = _rows(runs["jax"][0]), _rows(runs["port"][0])
    assert t[0] == j[0] == ttrainer.RESULTS_HEADER
    assert [r[0] for r in t[1:]] == [r[0] for r in j[1:]] == ["1", "2", "3"]
    lr = [j[0].index(c) for c in ("lr/pg0", "lr/pg1", "lr/pg2")]
    for rt, rj in zip(t[1:], j[1:]):
        assert len(rt) == len(rj)
        for i in lr:
            assert abs(float(rt[i]) - float(rj[i])) <= 1e-7, (rt[i], rj[i])
        for v in rt[2:6] + rt[14:18]:  # train and val losses: finite
            assert np.isfinite(float(v))


def test_weight_files_and_fitness_note_equal_jax(runs):
    jw, tw = runs["jax"][0] / "weights", runs["port"][0] / "weights"
    j = sorted(p.name.rsplit(".", 1)[0] for p in jw.iterdir() if p.suffix == ".ckpt")
    t = sorted(p.name.rsplit(".", 1)[0] for p in tw.iterdir() if p.suffix == ".pt")
    assert t == j == ["best", "epoch1", "epoch2", "epoch3", "last"]
    assert json.loads((tw / "fitness.json").read_text()) == \
        json.loads((jw / "fitness.json").read_text()) == {"best_fitness": 0.1, "best_epoch": 2}
    assert tengine.entrenamiento_exitoso(runs["port"][0])
    assert jengine.entrenamiento_exitoso(runs["jax"][0])
    # every file the port writes reads back with weights_only=True
    for p in tw.glob("*.pt"):
        assert isinstance(tckpt.load_checkpoint(p), dict)


def test_decisions_equal_jax(runs):
    _, jl, js = runs["jax"]
    _, tl, ts = runs["port"]
    assert tl["init"] == jl["init"] == [(4, 1)]  # batch 8 shrunk to 4; one step an epoch
    assert tl["mosaic"] == jl["mosaic"] == [True, True, False]
    assert tl["validated"] == jl["validated"] == 3
    # (epoch, file): a snapshot every epoch, best on the tie, last at the early stop
    assert tl["saved"] == jl["saved"] == [(1, "epoch1"), (1, "best"), (2, "epoch2"),
                                          (2, "best"), (3, "epoch3"), (3, "last")]
    assert {k: ts[k] for k in js if k != "weights_dir"} == \
        {k: js[k] for k in js if k != "weights_dir"}
    assert ts["epochs"] == 3 and (ts["batch_size"], ts["steps_per_epoch"]) == (4, 1)


# --------------------------------------------------------------------------
# resume, port only
# --------------------------------------------------------------------------

RESUME = dict(epochs=4, batch_size=2, imgsz=64, max_fg=8, close_mosaic=1, plots=False,
              amp=False)


class Interrupted(Exception):
    pass


def _train(root, out, mp, stop_at_epoch=None):
    """A port train_fold with last.pt written every epoch; records the
    batches drawn; raises Interrupted when epoch `stop_at_epoch` begins."""
    drawn, epochs = [], []
    real_idx, real_batch = tdata.epoch_indices, taug.make_batch

    def epoch_indices(*a, **kw):
        epochs.append(1)
        if len(epochs) + start[0] == stop_at_epoch:
            raise Interrupted
        return real_idx(*a, **kw)

    def make_batch(params, dd, idx, cfg):
        drawn.append((tuple(t.clone() for t in params), idx.clone(), cfg.mosaic))
        return real_batch(params, dd, idx, cfg)

    start = [0]
    mp.setattr(tengine, "LAST_EVERY", 1)
    mp.setattr(tdata, "epoch_indices", epoch_indices)
    mp.setattr(taug, "make_batch", make_batch)
    if (out / "weights" / "last.pt").exists():
        start[0] = tckpt.load_checkpoint(out / "weights" / "last.pt")["step"] // 3
    model, _ = t_create(nc=1, scale="n")
    try:
        tengine.train_fold(model=model, dataset_dir=root / "MSLesSeg-Dataset" / "train",
                           output_dir=out, cfg=TConfig(**RESUME), device="cpu", **FOLD)
    except Interrupted:
        pass
    return drawn


def test_resume_equals_the_uninterrupted_run(tmp_path):
    write_dataset(tmp_path)
    with pytest.MonkeyPatch.context() as mp:
        whole = _train(tmp_path, tmp_path / "whole", mp)
    with pytest.MonkeyPatch.context() as mp:
        first = _train(tmp_path, tmp_path / "resumed", mp, stop_at_epoch=3)
    with pytest.MonkeyPatch.context() as mp:
        second = _train(tmp_path, tmp_path / "resumed", mp)
    # an epoch: 3 train batches and 6 validation batches
    assert len(first) == 18 and len(whole) == len(first) + len(second) == 36
    for (pw, iw, mw), (pr, ir, mr) in zip(whole, first + second):
        assert mw == mr and torch.equal(iw, ir)
        assert all(torch.equal(a, b) for a, b in zip(pw, pr))

    a = tckpt.load_checkpoint(tmp_path / "whole" / "weights" / "last.pt")
    b = tckpt.load_checkpoint(tmp_path / "resumed" / "weights" / "last.pt")
    assert (a["step"], a["applies"]) == (b["step"], b["applies"]) == (12, a["applies"])
    for part in ("model", "ema", "grads"):
        assert a[part].keys() == b[part].keys()
        for k in a[part]:
            assert torch.equal(a[part][k], b[part][k]), (part, k)
    sa, sb = a["optimizer"]["state"], b["optimizer"]["state"]
    assert sa.keys() == sb.keys()
    for i in sa:
        for k in sa[i]:
            assert torch.equal(sa[i][k], sb[i][k]), (i, k)
    assert a["optimizer"]["param_groups"] == b["optimizer"]["param_groups"]
    assert torch.equal(a["gen"], b["gen"]) and a["lr"] == b["lr"]
    ra, rb = _rows(tmp_path / "whole"), _rows(tmp_path / "resumed")
    assert len(ra) == len(rb) == 5
    assert [r[:1] + r[2:] for r in ra] == [r[:1] + r[2:] for r in rb]
    assert (tmp_path / "resumed" / "weights" / "best.pt").exists()


def test_a_fold_without_validation_slices_keeps_its_final_weights_as_best(tmp_path):
    """The reference's rule for a fold whose test patients give no slice:
    no validation runs, and the final weights become ``best.pt`` (no
    ``fitness.json``)."""
    write_dataset(tmp_path, pids=("P1", "P2"))  # both in fold 1: fold 2 tests no one
    out = tmp_path / "fold2"
    model, _ = t_create(nc=1, scale="n")
    summary = tengine.train_fold(
        model=model, dataset_dir=tmp_path / "MSLesSeg-Dataset" / "train", output_dir=out,
        cfg=TConfig(epochs=2, batch_size=4, imgsz=64, max_fg=8, plots=False, amp=False),
        device="cpu", **{**FOLD, "patients": ["P1", "P2"], "fold_test": 2})
    assert summary["val_slices"] == 0 and summary["best_fitness"] == -1.0
    assert sorted(p.name for p in (out / "weights").iterdir()) == ["best.pt", "last.pt"]
    rows = _rows(out)
    assert [r[0] for r in rows[1:]] == ["1", "2"]
    assert all(float(v) == 0.0 for r in rows[1:] for v in r[6:18])  # no metric, no val loss
