"""Several ranks on the CPU: ``core/distributed.py``, ``core/mesh.py``, the
data-parallel step, the fold-parallel engine over ranks, rank-0 writes and
the slice axis split over devices in serving.

Ranks are CPU processes joined by ``gloo`` (``torch.multiprocessing``'s
spawn, ``init_method="file://"`` under the test's temporary directory, so
parallel test workers never contend for a TCP port), one thread each, each
joined with its own deadline. The JAX package's multi-device tests run a
virtual 8-device mesh in one process; a torch rank is a process, so these
are the port's only evidence for more than one rank (the card's machine has
one card).

* The data-parallel step over one batch split across 2 ranks
  (``DataAxis(global_batch=True)``, the sequential engine's semantics),
  with the model's ``remat`` off and on, equals one process's step on the
  concatenated batch: loss parts within
  rtol 1e-3 (the reference's ``tests/test_data_parallel.py`` holds 1 device
  against 8 to that), gradients within 1e-3 of each leaf's largest (but for
  the three C2PSA BatchNorm biases whose gradient is zero analytically and
  rounding noise numerically, as ``tests/test_torch_port_train_step.py``
  leaves them out), BatchNorm running statistics within 1e-4.
* The fold group's step (``global_batch=False``, the reference's
  ``shard_map`` with ``pmean``) equals the mean of the ranks' own
  one-process steps: gradients, running statistics and losses within
  float32 rounding of an average.
* One rank through the collective path equals the plain step bit for bit,
  optimizer applies included (what ``chip_smoke.py`` phase 17 checks under
  ``nccl`` on the card).
* ``train_folds_parallel`` over 2 ranks (fold 2 x data 1) writes what one
  process writes, every fold's weights bit for bit, and only rank 0 writes.
"""

import datetime
import importlib.util
import multiprocessing
import os
import shutil
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from tpu_mslesseg_torch.core import distributed, geometry, mesh
from tpu_mslesseg_torch.infer.consensus3 import ConsensusPredictor
from tpu_mslesseg_torch.model.yolo11 import create_model, init_variables
from tpu_mslesseg_torch.tools.train_batches import synthetic_batch
from tpu_mslesseg_torch.train import augment, checkpoint, fold_parallel, trainer
from tpu_mslesseg_torch.train.trainer import TrainConfig

RANK_TIMEOUT = 240  # seconds a spawned rank may take
S, B = 64, 4
PARTS = ("loss", "box", "seg", "cls", "dfl")
NOISE_LEAVES = ("model.10.m.0.attn.pe.bn.bias", "model.10.m.0.attn.proj.bn.bias",
                "model.10.m.0.ffn.1.bn.bias")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Torch on one thread here: the suite runs several test processes at
    once, and each torch process's own thread pool would contend for the
    same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def tree(tmp_path):
    """`tmp_path`, removed after the test: the runs' trees hold checkpoints."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


def _rank_main(fn, rank, world, tmp, args):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store", world_size=world,
                            rank=rank, timeout=datetime.timedelta(seconds=RANK_TIMEOUT))
    try:
        out = fn(rank, world, Path(tmp), *args)
        torch.save(out, Path(tmp) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def _spawn(fn, world, tmp, *args):
    """`fn(rank, world, tmp, *args)` in `world` gloo ranks; their results."""
    tmp.mkdir(parents=True, exist_ok=True)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(fn, r, world, str(tmp), args))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + RANK_TIMEOUT
    for p in procs:
        p.join(max(deadline - time.monotonic(), 1.0))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    assert not hung, f"ranks {hung} did not finish within {RANK_TIMEOUT} s"
    assert [p.exitcode for p in procs] == [0] * world
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(world)]


# --------------------------------------------------------------------------
# core/distributed.py and core/mesh.py
# --------------------------------------------------------------------------

LAUNCH_VARS = (distributed.ENV_COORD, distributed.ENV_NPROC, distributed.ENV_PID,
               distributed.ENV_OPTIN, "RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT",
               "LOCAL_RANK")


@pytest.fixture
def no_launcher(monkeypatch):
    for v in LAUNCH_VARS:
        monkeypatch.delenv(v, raising=False)


def test_a_single_process_is_rank_zero_of_one(no_launcher):
    assert distributed.maybe_initialize(device="cpu") is False
    assert not dist.is_initialized()
    assert distributed.is_main_process() and distributed.process_count() == 1
    assert distributed.process_index() == distributed.env_rank() == 0
    assert distributed.broadcast_from_main([0.1, 3]) == [0.1, 3.0]
    assert distributed.all_gather_objects({"a": 1}) == [{"a": 1}]
    assert distributed.gather_to_main([1]) == [[1]]
    distributed.barrier()
    assert distributed.main_process_only(lambda x: x + 1)(1) == 2
    grid = mesh.make_grid()
    assert (grid.fold, grid.data, grid.rank) == (1, 1, 0)
    assert grid.data_axis(True) is None and list(grid.folds_of(5)) == [0, 1, 2, 3, 4]
    with pytest.raises(ValueError):
        mesh.make_grid(fold_parallel=2)


def test_a_launch_without_a_rank_or_size_is_refused(no_launcher, monkeypatch):
    monkeypatch.setenv(distributed.ENV_COORD, "localhost:1")
    with pytest.raises(ValueError, match="torchrun"):
        distributed.maybe_initialize(device="cpu")
    assert not dist.is_initialized()


def test_the_launchers_rank_is_read_before_initialisation(no_launcher, monkeypatch):
    monkeypatch.setenv("RANK", "3")
    assert distributed.env_rank() == 3
    monkeypatch.setenv(distributed.ENV_PID, "1")
    assert distributed.env_rank() == 1  # the reference's variable first


def test_pad_to_multiple():
    assert [mesh.pad_to_multiple(n, 4) for n in (1, 4, 5, 8, 9)] == [4, 4, 8, 8, 12]


def _launch(rank, world, tmp, route, port):
    """maybe_initialize from the launcher's variables (run outside
    `_rank_main`: the group is this function's to make)."""
    torch.set_num_threads(1)
    for v in LAUNCH_VARS:
        os.environ.pop(v, None)
    if route == "reference":
        os.environ.update({distributed.ENV_COORD: f"127.0.0.1:{port}",
                           distributed.ENV_NPROC: str(world), distributed.ENV_PID: str(rank)})
    else:
        os.environ.update({"RANK": str(rank), "WORLD_SIZE": str(world),
                           "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)})
    assert distributed.maybe_initialize(device="cpu") is True
    assert distributed.maybe_initialize(device="cpu") is True  # already up
    out = {"rank": distributed.process_index(), "world": distributed.process_count(),
           "main": distributed.is_main_process(), "backend": dist.get_backend(),
           "bcast": distributed.broadcast_from_main([0.1 + rank, 1e-12 * (rank + 1)]),
           "gathered": distributed.all_gather_objects(rank * 10),
           "to_main": distributed.gather_to_main(rank)}
    distributed.barrier()
    distributed.shutdown()
    torch.save(out, tmp / f"rank{rank}.pt")


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("route", ["reference", "torchrun"])
def test_maybe_initialize_from_the_launchers_variables(tmp_path, route):
    ctx = multiprocessing.get_context("spawn")
    port = _free_port()
    procs = [ctx.Process(target=_launch, args=(r, 2, tmp_path, route, port)) for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(RANK_TIMEOUT)
        if p.is_alive():
            p.kill()
    assert [p.exitcode for p in procs] == [0, 0]
    outs = [torch.load(tmp_path / f"rank{r}.pt") for r in range(2)]
    for r, o in enumerate(outs):
        assert (o["rank"], o["world"], o["main"], o["backend"]) == (r, 2, r == 0, "gloo")
        assert o["bcast"] == [0.1, 1e-12]  # rank 0's, exactly
        assert o["gathered"] == [0, 10]
    assert outs[0]["to_main"] == [0, 1] and outs[1]["to_main"] is None


def _grid_rank(rank, world, tmp, fold_parallel_):
    grid = mesh.make_grid(fold_parallel=fold_parallel_)
    axis = grid.data_axis(global_batch=False)
    got = {"fold": grid.fold_index, "data": grid.data_index, "lead": grid.is_data_lead,
           "folds": list(grid.folds_of(2 * grid.fold))}
    if axis is not None:
        got["ranks"] = axis.ranks
        got["sum"] = float(axis.all_reduce(torch.tensor([float(rank)])))
        got["rows"] = axis.all_gather_rows(torch.tensor([[rank, rank], [rank, 1]])).tolist()
        # a fold slot's share of a fold's batch: the rows and parameters of
        # the whole batch's draw, this rank's part
        rng = np.random.default_rng(0)
        data = {"images": torch.from_numpy(rng.integers(0, 255, (6, 24, 20), np.uint8)),
                "instmaps": torch.zeros((6, 24, 20), dtype=torch.uint8),
                "boxes": torch.zeros((6, 2, 4)), "valid": torch.zeros((6, 2), dtype=torch.bool)}
        model, _ = create_model()
        state = fold_parallel.init_fold_state(model, TrainConfig(batch_size=4, imgsz=32), 1,
                                              grid.fold_index, device="cpu")
        acfg = augment.AugConfig(imgsz=32, max_inst=2)
        got["images"] = fold_parallel.fold_batch(state, torch.arange(6), 6, data, acfg, 4,
                                                 axis)["images"]
        got["whole"] = fold_parallel.fold_batch(
            fold_parallel.init_fold_state(model, TrainConfig(batch_size=4, imgsz=32), 1,
                                          grid.fold_index, device="cpu"),
            torch.arange(6), 6, data, acfg, 4)["images"]
    return got


def test_the_ranks_form_a_fold_by_data_grid(tmp_path):
    outs = _spawn(_grid_rank, 4, tmp_path, 2)
    assert [(o["fold"], o["data"], o["lead"]) for o in outs] == \
        [(0, 0, True), (0, 1, False), (1, 0, True), (1, 1, False)]
    assert [o["folds"] for o in outs] == [[0, 1], [0, 1], [2, 3], [2, 3]]
    # each slot's data group holds its two ranks and no other
    assert [o["ranks"] for o in outs] == [(0, 1), (0, 1), (2, 3), (2, 3)]
    assert [o["sum"] for o in outs] == [1.0, 1.0, 5.0, 5.0]
    assert outs[2]["rows"] == [[2, 2], [2, 1], [3, 3], [3, 1]]
    for slot in (0, 1):
        a, b = outs[2 * slot], outs[2 * slot + 1]
        assert torch.equal(torch.cat([a["images"], b["images"]]), a["whole"])
        assert not torch.equal(a["images"], b["images"])


def test_a_pure_data_grid_over_two_ranks(tmp_path):
    outs = _spawn(_grid_rank, 2, tmp_path, 1)
    assert [(o["fold"], o["data"], o["folds"]) for o in outs] == [(0, 0, [0, 1]), (0, 1, [0, 1])]
    assert [o["sum"] for o in outs] == [1.0, 1.0]


# --------------------------------------------------------------------------
# the data-parallel step
# --------------------------------------------------------------------------

# warmup_epochs 0: the optimizer fires every round(64 / 4) = 16 micro-steps,
# so after one micro-step the gradients are still in .grad
QUIET = dict(epochs=1, batch_size=B, imgsz=S, max_fg=8, warmup_epochs=0.0)


def _state(cfg=QUIET, remat=False):
    model, _ = create_model(remat=remat)
    return trainer.init_train_state(model, TrainConfig(**cfg), 2,
                                    variables=init_variables(model, 0), device="cpu")


def _batch(seed=1):
    return synthetic_batch(seed, B, S, slots=4, max_valid=3, size=(0.2, 0.5))


def _result(state, m):
    return {"metrics": {k: float(m[k]) for k in PARTS},
            "grads": {n: p.grad.clone() for n, p in state.model.named_parameters()},
            "stats": {n: b.clone() for n, b in state.model.named_buffers() if "running" in n}}


def _dp_rank(rank, world, tmp, global_batch, remat=False):
    state = _state(remat=remat)
    axis = mesh.DataAxis(dist.group.WORLD, tuple(range(world)), rank, global_batch)
    part = axis.local_slice(B)
    batch = {k: v[part] for k, v in _batch().items()}
    return _result(state, trainer.train_step(state, batch, axis))


@pytest.fixture(scope="module")
def one_process():
    """One process's micro-steps: on the whole batch, and on each half."""
    run = lambda batch: (lambda st: _result(st, trainer.train_step(st, batch)))(_state())
    whole = _batch()
    return {"whole": run(whole),
            "halves": [run({k: v[h * B // 2:(h + 1) * B // 2] for k, v in whole.items()})
                       for h in (0, 1)]}


@pytest.mark.parametrize("remat", [False, True])
def test_two_ranks_over_one_batch_equal_one_process_on_it(tmp_path, one_process, remat):
    """With `remat` each rank recomputes its rematerialised blocks in the
    backward, after the step has left the BatchNorm axis: the recompute
    normalises over the whole batch again, with the same collectives."""
    outs = _spawn(_dp_rank, 2, tmp_path, True, remat)
    want = one_process["whole"]
    for k in PARTS:
        assert want["metrics"][k] > 0.01
        for o in outs:
            np.testing.assert_allclose(o["metrics"][k], want["metrics"][k], rtol=1e-3,
                                       err_msg=k)
    for n, g in want["grads"].items():
        assert torch.equal(outs[0]["grads"][n], outs[1]["grads"][n])  # the ranks agree
        if n in NOISE_LEAVES:
            continue
        scale = float(g.abs().max())
        assert float((outs[0]["grads"][n] - g).abs().max()) <= 1e-3 * scale + 1e-8, n
    for n, s in want["stats"].items():
        assert torch.equal(outs[0]["stats"][n], outs[1]["stats"][n])
        torch.testing.assert_close(outs[0]["stats"][n], s, rtol=0, atol=1e-4)
    # the halves' own statistics are not the whole batch's: the test tells
    # global from per-rank BatchNorm
    half = one_process["halves"][0]["stats"]
    assert max(float((half[n] - s).abs().max()) for n, s in want["stats"].items()) > 1e-3


def test_a_fold_groups_step_is_the_mean_of_its_ranks_steps(tmp_path, one_process):
    outs = _spawn(_dp_rank, 2, tmp_path, False)
    h0, h1 = one_process["halves"]
    for k in PARTS:
        mean = (h0["metrics"][k] + h1["metrics"][k]) / 2
        for o in outs:
            np.testing.assert_allclose(o["metrics"][k], mean, rtol=1e-5, err_msg=k)
    for what in ("grads", "stats"):
        for n in h0[what]:
            assert torch.equal(outs[0][what][n], outs[1][what][n])
            want = (h0[what][n] + h1[what][n]) / 2
            torch.testing.assert_close(outs[0][what][n], want, rtol=1e-5, atol=1e-7)


def _one_rank_steps(rank, world, tmp):
    """Three micro-steps (applies at 0 and 1) through the collective path of
    a one-rank axis and through the plain path, from the same state."""
    cfg = dict(QUIET, warmup_epochs=3.0)
    out = {}
    for name, axis in (("plain", None), ("axis", mesh.DataAxis(dist.group.WORLD, (0,), 0, True))):
        state = _state(cfg)
        ms = [trainer.train_step(state, _batch(seed), axis) for seed in (1, 2, 3)]
        out[name] = {"metrics": [{k: m[k].clone() for k in PARTS} for m in ms],
                     "applied": [m["applied"] for m in ms], "state": state.state_dict()}
    return out


def test_one_rank_through_the_collectives_equals_the_plain_step_bit_for_bit(tree):
    (out,) = _spawn(_one_rank_steps, 1, tree)
    a, b = out["plain"], out["axis"]
    assert a["applied"] == b["applied"] and a["applied"][:2] == [True, True]
    for ma, mb in zip(a["metrics"], b["metrics"]):
        assert all(torch.equal(ma[k], mb[k]) for k in PARTS)
    sa, sb = a["state"], b["state"]
    for part in ("model", "ema", "grads"):
        for k in sa[part]:
            assert torch.equal(sa[part][k], sb[part][k]), (part, k)
    for i in sa["optimizer"]["state"]:
        for k, v in sa["optimizer"]["state"][i].items():
            assert torch.equal(v, sb["optimizer"]["state"][i][k])


# --------------------------------------------------------------------------
# the fold-parallel engine over ranks, and rank-0 writes
# --------------------------------------------------------------------------

# plots on: rank 0 draws every fold's figures, the curves from the
# accumulator of the rank that validated the fold
FOLDS_CFG = dict(epochs=2, batch_size=4, imgsz=S, max_fg=8, close_mosaic=1, save_period=1,
                 plots=True, amp=False)
FOLDS_RUN = dict(patients=["P1", "P2", "P30"], plano="axial", modalidades=["FLAIR"],
                 mejora="CLAHE", num_cortes=6, k_folds=2)


def _train_folds(root, out, grid=None):
    from tpu_mslesseg_torch.train import engine_parallel

    model, _ = create_model()
    return engine_parallel.train_folds_parallel(
        model=model, dataset_dir=root / "MSLesSeg-Dataset" / "train", output_root=out,
        cfg=TrainConfig(**FOLDS_CFG), grid=grid, device="cpu", **FOLDS_RUN)


def _folds_rank(rank, world, tmp):
    writes = []
    real_save, real_row = checkpoint.save_checkpoint, trainer.ResultsWriter.write_epoch

    def save(path, sd):
        writes.append(str(path))
        real_save(path, sd)

    def row(self, *a, **kw):
        if self.enabled:
            writes.append(str(self.path))
        real_row(self, *a, **kw)

    checkpoint.save_checkpoint = save
    trainer.ResultsWriter.write_epoch = row
    fold_par, _ = fold_parallel.plan_fold_mesh(world, FOLDS_RUN["k_folds"])
    summary = _train_folds(tmp, tmp / "ranks", mesh.make_grid(fold_parallel=fold_par))
    return {"summary": summary, "writes": writes}


def test_two_ranks_train_the_folds_as_one_process_and_only_rank_zero_writes(tree):
    from test_torch_port_stages import write_dataset

    tmp_path = tree
    write_dataset(tmp_path)
    alone = _train_folds(tmp_path, tmp_path / "alone")
    outs = _spawn(_folds_rank, 2, tmp_path)
    assert outs[0]["summary"] == outs[1]["summary"] == alone
    assert outs[1]["writes"] == [] and outs[0]["writes"]
    files = lambda d: sorted(str(p.relative_to(d)) for p in d.rglob("*") if p.is_file())
    assert files(tmp_path / "ranks") == files(tmp_path / "alone")
    if importlib.util.find_spec("matplotlib") is not None:
        assert {"fold2/results.png", "fold2/labels.jpg", "fold2/BoxPR_curve.png",
                "fold2/confusion_matrix.png"} <= set(files(tmp_path / "ranks"))
    for f in (1, 2):
        for name in ("last.pt", "best.pt", "epoch2.pt"):
            a = checkpoint.load_checkpoint(tmp_path / "alone" / f"fold{f}" / "weights" / name)
            b = checkpoint.load_checkpoint(tmp_path / "ranks" / f"fold{f}" / "weights" / name)
            sa, sb = (x["model"] if "model" in x else x for x in (a, b))
            assert sa.keys() == sb.keys()
            assert all(torch.equal(sa[k], sb[k]) for k in sa), (f, name)
        rows = [(tmp_path / run / f"fold{f}" / "results.csv").read_text().splitlines()
                for run in ("alone", "ranks")]
        strip = lambda r: [line.split(",", 2)[::2] for line in r]  # all but the time
        assert strip(rows[0]) == strip(rows[1]) and len(rows[0]) == 3
    stacked = checkpoint.load_checkpoint(tmp_path / "ranks" / "_parallel" / "last.pt")
    assert sorted(stacked["folds"]) == [0, 1]


SEQ_CFG = dict(epochs=2, batch_size=4, imgsz=S, max_fg=8, close_mosaic=1, plots=False,
               amp=False)


def _train_fold(root, out, axis=None):
    from tpu_mslesseg_torch.train import engine

    model, _ = create_model()
    run = {k: v for k, v in FOLDS_RUN.items()}
    return engine.train_fold(model=model, fold_test=2, dataset_dir=root / "MSLesSeg-Dataset" /
                             "train", output_dir=out, cfg=TrainConfig(**SEQ_CFG), device="cpu",
                             axis=axis, **run)


def _fold_rank(rank, world, tmp):
    writes = []
    real_save = checkpoint.save_checkpoint
    checkpoint.save_checkpoint = lambda path, sd: writes.append(str(path)) or real_save(path, sd)
    axis = mesh.make_grid(fold_parallel=1).data_axis(global_batch=True)
    return {"summary": _train_fold(tmp, tmp / "ranks", axis), "writes": writes}


def test_two_ranks_train_one_fold_as_one_process_on_its_batches(tree):
    """The sequential engine over a data axis (the reference's ``mesh=``):
    each rank takes half of every train and validation batch; the run's
    decisions, files and numbers are one process's (losses within rtol
    1e-3, validation metrics within 1e-3), and only rank 0 writes."""
    from test_torch_port_stages import write_dataset

    tmp_path = tree
    write_dataset(tmp_path)
    alone = _train_fold(tmp_path, tmp_path / "alone")
    outs = _spawn(_fold_rank, 2, tmp_path)
    for o in outs:
        got = {k: v for k, v in o["summary"].items() if k not in ("weights_dir", "best_fitness")}
        assert got == {k: v for k, v in alone.items() if k not in ("weights_dir", "best_fitness")}
    assert alone["batch_size"] == 4 and alone["steps_per_epoch"] == 3
    assert outs[1]["writes"] == [] and outs[0]["writes"]
    files = lambda d: sorted(str(p.relative_to(d)) for p in d.rglob("*") if p.is_file())
    assert files(tmp_path / "ranks") == files(tmp_path / "alone")
    rows = [[list(map(float, r.split(",")[2:18])) for r in
             (tmp_path / run / "results.csv").read_text().splitlines()[1:]]
            for run in ("alone", "ranks")]
    assert len(rows[0]) == len(rows[1]) == 2
    for a, b in zip(*rows):
        np.testing.assert_allclose(b[:4], a[:4], rtol=1e-3)  # train losses
        np.testing.assert_allclose(b[4:12], a[4:12], rtol=0, atol=1e-3)  # box/mask metrics
        np.testing.assert_allclose(b[12:], a[12:], rtol=1e-3)  # validation losses


def test_host_writes_are_rank_zeros(tmp_path, monkeypatch):
    """Off rank 0: no results.csv, args.yaml, dataset YAML, checkpoint or
    log file."""
    import logging

    from tpu_mslesseg_torch.pipeline import logging_setup
    from tpu_mslesseg_torch.pipeline.modelo import Modelo
    from tpu_mslesseg_torch.pipeline.stages import train as stage
    from tpu_mslesseg_torch.train import engine

    monkeypatch.setattr(distributed, "process_index", lambda: 1)
    assert not distributed.is_main_process()
    assert distributed.main_process_only(lambda: 1)() is None
    w = trainer.ResultsWriter(tmp_path / "results.csv")
    w.write_epoch(1, {"box": 1.0}, {}, {}, 0.01)
    engine._write_args_yaml(tmp_path / "args.yaml", TrainConfig())
    engine._save(tmp_path / "best.pt", {"a": torch.zeros(1)})
    modelo = Modelo(plano="axial", num_cortes=6, modalidad=["FLAIR"], k_folds=2)
    stage._escribir_dataset_yaml(tmp_path, modelo, tmp_path, ["P1", "P30"], 1, 2)
    assert list(tmp_path.iterdir()) == []
    monkeypatch.setenv("RANK", "1")
    root = logging.getLogger()
    before = list(root.handlers)
    try:
        logging_setup.configure_logging(log_file=str(tmp_path / "pipeline.log"))
        assert not any(isinstance(h, logging.FileHandler) for h in root.handlers)
    finally:
        root.handlers[:] = before
    assert not (tmp_path / "pipeline.log").exists()


def test_one_process_with_several_cards_uses_the_first_and_says_so_once(monkeypatch, caplog):
    from tpu_mslesseg_torch.pipeline import rapido

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(distributed, "_warned_one_card", False)
    with caplog.at_level("WARNING"):
        distributed.advertir_una_gpu(torch.device("cuda"))
        distributed.advertir_una_gpu(torch.device("cuda"))
        distributed.advertir_una_gpu(torch.device("cpu"))
    assert caplog.text.count("torchrun --nproc_per_node 2") == 1
    # serving: one process splits the slice axis over the cards it sees;
    # the CPU and several ranks do not
    assert rapido._dispositivos_para_servicio("cuda") == [torch.device("cuda", 0),
                                                          torch.device("cuda", 1)]
    assert rapido._dispositivos_para_servicio("cpu") is None
    monkeypatch.setattr(distributed, "process_count", lambda: 2)
    assert rapido._dispositivos_para_servicio("cuda") is None
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(distributed, "process_count", lambda: 1)
    assert rapido._dispositivos_para_servicio("cuda") is None


# --------------------------------------------------------------------------
# serving: the slice axis split over devices
# --------------------------------------------------------------------------

VOL = (24, 28, 24)
N_SLICES = 5  # two devices do not divide it


def _serving_case(seed, multimodal):
    rng = np.random.default_rng(seed)
    n_pat = 2
    gts = np.zeros((n_pat,) + VOL, np.float32)
    gts[:, 8:16, 10:18, 8:16] = 1
    slices, idx = {}, {}
    for plane in geometry.PLANES:
        axis, shape = geometry.plane_axis(plane), geometry.slice_shape(VOL, plane)
        raw = lambda: rng.integers(0, 400, (n_pat, N_SLICES, *shape)).astype(np.float32)
        slices[plane] = {"T1": raw(), "FLAIR": raw()} if multimodal else raw()
        idx[plane] = np.stack([rng.permutation(VOL[axis])[:N_SLICES] for _ in range(n_pat)])
    idx["axial"][1, -1] = max(VOL)  # an out-of-range slot already in the group
    return slices, idx, gts


@pytest.mark.parametrize("mejora,per_plane,multimodal", [("GC", False, False),
                                                          ("CLAHE", True, True)])
def test_a_lote_split_over_two_devices_equals_one_device(mejora, per_plane, multimodal):
    model, _ = create_model()
    variables = init_variables(model, 3)
    for i in range(3):  # no class prior: NMS keeps detections
        variables[f"model.23.cv3.{i}.2.bias"].zero_()
    if per_plane:
        variables = {p: init_variables(model, 10 + i) for i, p in
                     enumerate(("axial", "coronal", "sagital"))}
        for v in variables.values():
            for i in range(3):
                v[f"model.23.cv3.{i}.2.bias"].zero_()
    slices, idx, gts = _serving_case(0, multimodal)
    kw = dict(mejora=mejora, imgsz=S, per_plane_counts=True)
    one = ConsensusPredictor(model, variables, VOL, device="cpu", **kw)
    two = ConsensusPredictor(model, variables, VOL, devices=["cpu", "cpu"], **kw)
    assert two.device == torch.device("cpu") and len(two._replicas) == 2
    c1, cons1, v1 = one.lote(slices, idx, gts)
    c2, cons2, v2 = two.lote(slices, idx, gts)
    assert c1.keys() == c2.keys()
    for k in c1:
        assert torch.equal(c1[k], c2[k]), k
    assert torch.equal(cons1, cons2)
    for p in v1:
        assert torch.equal(v1[p], v2[p]), p
        assert bool(v1[p].any())  # something was served
    # the padded slot and the out-of-range one wrote nothing
    axis = geometry.plane_axis("axial")
    untouched = np.setdiff1d(np.arange(VOL[axis]), idx["axial"][1][:-1])
    assert not bool(v2["axial"][1].index_select(axis, torch.as_tensor(untouched)).any())
