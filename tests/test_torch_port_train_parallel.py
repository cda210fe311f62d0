"""The port's all-folds engine (``train/engine_parallel.py``) against the JAX
package's ``train_folds_parallel``.

One JAX run and one port run (float32, CPU) on ``test_torch_port_stages``'s
tree (P1 and P2 in fold 1 of 2, P30 in fold 2; FLAIR under CLAHE, 6 slices a
patient) with the same options: imgsz 64, 4 epochs, ``close_mosaic`` 2,
``save_period`` 1, ``patience`` 1, batch 8 (which the ``n_min`` rule
shrinks to 4: fold 1 trains on P30's 6 slices). The fitness is stubbed in
both with one sequence read fold by fold, epoch by epoch: fold 1 improves
at epoch 1 only, fold 2 at epochs 1 and 2, so the collective stop comes at
epoch 3, when both have gone one validation without a gain. The JAX run is
made once, in a module fixture: it compiles two whole-epoch programs over
both folds and a validation step, most of this file's time.

Compared: the decisions (the batch and ``steps_per_epoch`` after the rules,
which epochs ran the mosaic, how many validation passes, which file was
saved when, in order, and the summary) and the artifacts (each fold's
``args.yaml`` parsed, the ``results.csv`` header, epochs and ``lr/pg*``
columns within 1e-7, the weight files, ``fitness.json``, the stacked
resume point). Loss values are not compared across the frameworks: the two
draw their batches from different generators (``test_torch_port_fold_parallel``
holds one micro-step against the reference's on the reference's draws).

Port only: a 3-epoch run equals a run interrupted after epoch 1 and resumed
from ``_parallel/last.pt`` (every fold's parameters, EMA, BatchNorm
statistics, optimizer state, generator, ``results.csv`` but for its time
column, and the batches drawn), exactly; and each fold inside the engine
equals the single-fold ``trainer.train_step`` on the same batches from
``fold_parallel.init_fold_state``, bit for bit.
"""

import csv
import json
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from test_torch_port_stages import write_dataset
from tpu_mslesseg.model.yolo11 import create_model as j_create
from tpu_mslesseg.train import checkpoint as jckpt
from tpu_mslesseg.train import engine_parallel as jengine
from tpu_mslesseg.train import fold_parallel as jfp
from tpu_mslesseg.train import trainer as jtrainer
from tpu_mslesseg.train import validate as jval
from tpu_mslesseg.train.trainer import TrainConfig as JConfig
from tpu_mslesseg_torch.model.yolo11 import create_model as t_create
from tpu_mslesseg_torch.train import augment as taug
from tpu_mslesseg_torch.train import checkpoint as tckpt
from tpu_mslesseg_torch.train import engine as tengine_seq
from tpu_mslesseg_torch.train import engine_parallel as tengine
from tpu_mslesseg_torch.train import fold_parallel as tfp
from tpu_mslesseg_torch.train import trainer as ttrainer
from tpu_mslesseg_torch.train import validate as tval
from tpu_mslesseg_torch.train.trainer import TrainConfig as TConfig
from torch_threads import one_torch_thread  # noqa: F401


OPTS = dict(epochs=4, batch_size=8, imgsz=64, max_fg=8, close_mosaic=2, save_period=1,
            patience=1, plots=False, amp=False)
# read fold by fold, epoch by epoch: (fold 1, fold 2) = (0.1, 0.1), (0.05, 0.2), (0.05, 0.1)
FITS = [0.1, 0.1, 0.05, 0.2, 0.05, 0.1, 0.3, 0.3]
RUN = dict(patients=["P1", "P2", "P30"], plano="axial", modalidades=["FLAIR"], mejora="CLAHE",
           num_cortes=6, k_folds=2)


def _spy(mp, engine, fold_parallel, trainer, validate, checkpoint, port):
    """Records the engine's decisions through the functions it calls."""
    log = {"epochs": [], "mosaic": [], "validated": 0, "saved": [], "init": []}
    fits = iter(FITS)
    mp.setattr(engine, "fitness", lambda m: next(fits))

    def wrap(mod, name, record):
        real = getattr(mod, name)

        def spy(*a, **kw):
            record(*a, **kw)
            return real(*a, **kw)

        mp.setattr(mod, name, spy)

    real_write = trainer.ResultsWriter.write_epoch

    def write_epoch(self, epoch, *a, **kw):
        if not log["epochs"] or log["epochs"][-1] != epoch:
            log["epochs"].append(epoch)
        return real_write(self, epoch, *a, **kw)

    mp.setattr(trainer.ResultsWriter, "write_epoch", write_epoch)
    if port:
        wrap(fold_parallel, "fold_step", lambda st, pool, count, dd, acfg, axis=None: (
            len(log["mosaic"]) == len(log["epochs"]) and log["mosaic"].append(acfg.mosaic)))
        wrap(validate, "run_validation", lambda *a, **kw: log.__setitem__(
            "validated", log["validated"] + 1))
    else:
        real_epoch_fn = fold_parallel.make_multi_fold_epoch_fn

        def epoch_fn(model, cfg, spe, acfg, mesh=None):
            fn = real_epoch_fn(model, cfg, spe, acfg, mesh=mesh)
            return lambda *a: (log["mosaic"].append(acfg.mosaic), fn(*a))[1]

        mp.setattr(fold_parallel, "make_multi_fold_epoch_fn", epoch_fn)
        wrap(validate, "dispatch_validation", lambda *a, **kw: log.__setitem__(
            "validated", log["validated"] + 1))
    wrap(checkpoint, "save_checkpoint", lambda path, *a, **kw: log["saved"].append(
        (len(log["epochs"]), path.parent.name if path.parent.name == "_parallel"
         else path.parent.parent.name, path.name.rsplit(".", 1)[0])))
    wrap(fold_parallel, "init_multi_fold_state", lambda model, cfg, spe, *a, **kw: log[
        "init"].append((cfg.batch_size, spe)))
    return log


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("engine_parallel")
    write_dataset(root)
    ds = root / "MSLesSeg-Dataset" / "train"
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        log = _spy(mp, jengine, jfp, jtrainer, jval, jckpt, port=False)
        model, _ = j_create(nc=1, scale="n", dtype=jnp.float32, remat=False)
        summary = jengine.train_folds_parallel(model=model, dataset_dir=ds,
                                               output_root=root / "jax",
                                               cfg=JConfig(remat=False, **OPTS), **RUN)
        out["jax"] = (root / "jax", log, summary)
    with pytest.MonkeyPatch.context() as mp:
        log = _spy(mp, tengine, tfp, ttrainer, tval, tckpt, port=True)
        model, _ = t_create(nc=1, scale="n", remat=False)
        summary = tengine.train_folds_parallel(model=model, dataset_dir=ds,
                                               output_root=root / "port",
                                               cfg=TConfig(remat=False, **OPTS), device="cpu",
                                               **RUN)
        out["port"] = (root / "port", log, summary)
    yield out
    shutil.rmtree(root, ignore_errors=True)  # checkpoints: hundreds of MB


def _rows(path):
    with open(path / "results.csv") as f:
        return list(csv.reader(f))


def test_decisions_equal_jax(runs):
    _, jl, js = runs["jax"]
    _, tl, ts = runs["port"]
    assert tl["init"] == jl["init"] == [(4, 1)]  # batch 8 shrunk to 4 by n_min 6; one step
    assert tl["epochs"] == jl["epochs"] == [1, 2, 3]  # the collective stop at epoch 3 of 4
    assert tl["mosaic"] == jl["mosaic"] == [True, True, False]
    assert tl["validated"] == jl["validated"] == 6  # both folds, three epochs
    # (epoch, where, file): best on a gain, a snapshot every epoch, and the
    # stacked point with every fold's last at the stop
    assert tl["saved"] == jl["saved"] == [
        (1, "fold1", "best"), (1, "fold2", "best"), (1, "fold1", "epoch1"),
        (1, "fold2", "epoch1"), (2, "fold2", "best"), (2, "fold1", "epoch2"),
        (2, "fold2", "epoch2"), (3, "fold1", "epoch3"), (3, "fold2", "epoch3"),
        (3, "_parallel", "last"), (3, "fold1", "last"), (3, "fold2", "last")]
    assert ts == js == {"fold1": {"fitness": 0.1}, "fold2": {"fitness": 0.2}}


@pytest.mark.parametrize("fold", [1, 2])
def test_fold_artifacts_equal_jax(runs, fold):
    jdir, tdir = runs["jax"][0] / f"fold{fold}", runs["port"][0] / f"fold{fold}"
    j = yaml.safe_load((jdir / "args.yaml").read_text())
    t = yaml.safe_load((tdir / "args.yaml").read_text())
    assert t == j and t["fold_test"] == fold and t["batch_size"] == 4 and t["remat"] is False

    jr, tr = _rows(jdir), _rows(tdir)
    assert tr[0] == jr[0] == ttrainer.RESULTS_HEADER
    assert [r[0] for r in tr[1:]] == [r[0] for r in jr[1:]] == ["1", "2", "3"]
    lr = [jr[0].index(c) for c in ("lr/pg0", "lr/pg1", "lr/pg2")]
    for rt, rj in zip(tr[1:], jr[1:]):
        assert len(rt) == len(rj)
        for i in lr:
            assert abs(float(rt[i]) - float(rj[i])) <= 1e-7, (rt[i], rj[i])
        for v in rt[2:6] + rt[14:18]:
            assert np.isfinite(float(v)) and float(v) > 0

    jw = sorted(p.name.rsplit(".", 1)[0] for p in (jdir / "weights").iterdir()
                if p.suffix == ".ckpt")
    tw = sorted(p.name.rsplit(".", 1)[0] for p in (tdir / "weights").iterdir()
                if p.suffix == ".pt")
    assert tw == jw == ["best", "epoch1", "epoch2", "epoch3", "last"]
    best = {1: (0.1, 1), 2: (0.2, 2)}[fold]
    assert json.loads((tdir / "weights" / "fitness.json").read_text()) == \
        json.loads((jdir / "weights" / "fitness.json").read_text()) == \
        {"best_fitness": best[0], "best_epoch": best[1]}
    assert tengine_seq.entrenamiento_exitoso(tdir)
    for p in (tdir / "weights").glob("*.pt"):
        assert isinstance(tckpt.load_checkpoint(p), dict)


def test_the_stacked_resume_point_holds_every_fold(runs):
    root = runs["port"][0]
    assert (runs["jax"][0] / "_parallel" / "last.ckpt").exists()
    stacked = tckpt.load_checkpoint(root / "_parallel" / "last.pt")
    assert sorted(stacked["folds"]) == [0, 1]
    for f in (0, 1):
        sd = tfp.extract_fold_state(stacked, f)
        last = tckpt.load_checkpoint(root / f"fold{f + 1}" / "weights" / "last.pt")
        assert sd["step"] == last["step"] == 3  # 3 epochs of one micro-step
        for k in sd["model"]:
            assert torch.equal(sd["model"][k], last["model"][k])
    a, b = (tckpt.load_checkpoint(root / f"fold{f}" / "weights" / "best.pt") for f in (1, 2))
    assert not torch.equal(a["model.0.conv.weight"], b["model.0.conv.weight"])


# --------------------------------------------------------------------------
# port only: resume, and a fold inside the engine against the single step
# --------------------------------------------------------------------------

RESUME = dict(epochs=3, batch_size=2, imgsz=64, max_fg=8, close_mosaic=1, plots=False,
              amp=False)
SPE, K = 3, 2  # n_min 6 at batch 2


class Interrupted(Exception):
    pass


def _train(root, out, mp, stop_at_epoch=None):
    """A port train_folds_parallel with the stacked point written every
    epoch; records each micro-step's fold and the batch it drew, and the
    config after the rules; raises Interrupted when epoch `stop_at_epoch`
    begins."""
    drawn, calls, cfgs, owners = [], [0], [], {}
    real_step, real_batch, real_init = tfp.fold_step, taug.make_batch, tfp.init_multi_fold_state
    start = [0]
    stacked = out / "_parallel" / "last.pt"
    if stacked.exists():
        start[0] = tckpt.load_checkpoint(stacked)["folds"][0]["step"] // SPE

    def init(model, cfg, *a, **kw):
        cfgs.append(cfg)
        states = real_init(model, cfg, *a, **kw)
        owners.update({id(st): f for f, st in states.items()})
        return states

    def fold_step(state, pool, count, dd, acfg, axis=None):
        if calls[0] // (SPE * K) + 1 + start[0] == stop_at_epoch:
            raise Interrupted
        calls[0] += 1
        drawn.append(("fold", owners[id(state)], dd, acfg))
        return real_step(state, pool, count, dd, acfg, axis)

    def make_batch(params, dd, idx, cfg):
        drawn.append((tuple(t.clone() for t in params), idx.clone(), cfg.mosaic))
        return real_batch(params, dd, idx, cfg)

    mp.setattr(tengine_seq, "LAST_EVERY", 1)
    mp.setattr(tfp, "init_multi_fold_state", init)
    mp.setattr(tfp, "fold_step", fold_step)
    mp.setattr(taug, "make_batch", make_batch)
    model, _ = t_create(nc=1, scale="n")
    try:
        tengine.train_folds_parallel(model=model, dataset_dir=root / "MSLesSeg-Dataset" / "train",
                                     output_root=out, cfg=TConfig(**RESUME), device="cpu", **RUN)
    except Interrupted:
        pass
    return drawn, cfgs


@pytest.fixture(scope="module")
def resumed(tmp_path_factory):
    root = tmp_path_factory.mktemp("parallel_resume")
    write_dataset(root)
    with pytest.MonkeyPatch.context() as mp:
        whole, cfgs = _train(root, root / "whole", mp)
    with pytest.MonkeyPatch.context() as mp:
        first, _ = _train(root, root / "resumed", mp, stop_at_epoch=2)
    with pytest.MonkeyPatch.context() as mp:
        second, _ = _train(root, root / "resumed", mp)
    yield root, whole, first, second, cfgs[0]
    shutil.rmtree(root, ignore_errors=True)  # checkpoints: hundreds of MB


def _equal_states(a, b, gen=True):
    assert (a["step"], a["applies"], a["lr"]) == (b["step"], b["applies"], b["lr"])
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
    assert not gen or torch.equal(a["gen"], b["gen"])


def test_resume_from_the_stacked_point_equals_the_uninterrupted_run(resumed):
    root, whole, first, second, _ = resumed
    # an epoch: 2 folds x 3 micro-steps (a marker and a batch each), then the
    # validation batches of 2 slices: 6 of fold 1 (P1, P2), 3 of fold 2 (P30)
    assert len(whole) == len(first) + len(second) == 3 * (2 * K * SPE + 9)
    for w, r in zip(whole, first + second):
        if w[0] == "fold":
            assert w[1] == r[1] and w[3] == r[3]
            continue
        (pw, iw, mw), (pr, ir, mr) = w, r
        assert mw == mr and torch.equal(iw, ir)
        assert all(torch.equal(x, y) for x, y in zip(pw, pr))
    a = tckpt.load_checkpoint(root / "whole" / "_parallel" / "last.pt")
    b = tckpt.load_checkpoint(root / "resumed" / "_parallel" / "last.pt")
    for f in range(K):
        assert a["folds"][f]["step"] == 3 * SPE
        _equal_states(a["folds"][f], b["folds"][f])
        ra, rb = (_rows(root / run / f"fold{f + 1}") for run in ("whole", "resumed"))
        assert len(ra) == len(rb) == 4
        assert [r[:1] + r[2:] for r in ra] == [r[:1] + r[2:] for r in rb]


def test_each_fold_in_the_engine_equals_the_single_fold_step(resumed):
    """Fold f's states inside the engine, replayed: `init_fold_state` and
    `trainer.train_step` on the batches fold f drew give its ``last.pt``,
    bit for bit (the other fold, validation and the checkpoints touch
    nothing of it)."""
    root, whole, _, _, cfg = resumed
    batches = {f: [] for f in range(K)}
    for i, item in enumerate(whole):
        if item[0] == "fold":  # the train batch right after its marker
            _, f, dd, acfg = item
            params, idx, _ = whole[i + 1]
            batches[f].append((params, idx, dd, acfg))
    for f in range(K):
        assert len(batches[f]) == 3 * SPE
        model, _ = t_create(nc=1, scale="n")
        state = tfp.init_fold_state(model, cfg, SPE, f, device="cpu")
        for params, idx, dd, acfg in batches[f]:
            ttrainer.train_step(state, taug.make_batch(taug.AugParams(*params), dd, idx, acfg))
        want = tckpt.load_checkpoint(root / "whole" / f"fold{f + 1}" / "weights" / "last.pt")
        # the replay draws nothing: its generator is not the fold's
        _equal_states(tckpt._to_cpu(state.state_dict()), want, gen=False)
