"""The port's training figures (``train/plots.py``) against the JAX package's.

The curves' arrays equal the reference's on seeded accumulators, an empty
one included; each function writes the reference's file names; the
validation preview draws the boxes that the port's decode and NMS keep; with
matplotlib missing, one warning and no file; a device error in the preview's
forward propagates. A port ``train_fold`` (float32, CPU, imgsz 64) with
``plots`` on writes the reference's figures beside its files and leaves
``results.csv`` (but for its time column), ``best.pt`` and ``last.pt`` (the
resume point) bit for bit as the same run with ``plots`` off. Images are not
compared byte for byte: matplotlib's rendering is not the point.
"""

import csv
import logging
import sys

import numpy as np
import pytest
import torch

from test_torch_port_stages import write_dataset
from tpu_mslesseg.train import plots as jplots
from tpu_mslesseg_torch.evalx.seg_map import SegMapAccumulator
from tpu_mslesseg_torch.infer import decode as dec
from tpu_mslesseg_torch.infer.nms import nms_batch
from tpu_mslesseg_torch.model.yolo11 import create_model
from tpu_mslesseg_torch.train import checkpoint as tckpt
from tpu_mslesseg_torch.train import engine as tengine
from tpu_mslesseg_torch.train import plots
from tpu_mslesseg_torch.train.trainer import TrainConfig
from torch_threads import one_torch_thread  # noqa: F401

CURVES = {f"{k}{c}.png" for k in ("Box", "Mask")
          for c in ("P_curve", "R_curve", "F1_curve", "PR_curve")}
CONFUSION = {"confusion_matrix.png", "confusion_matrix_normalized.png"}
PREVIEWS = {"train_batch0.jpg", "train_batch1.jpg", "train_batch2.jpg", "val_batch0_labels.jpg",
            "val_batch0_pred.jpg"}
FIGURES = {"results.png", "labels.jpg"} | CURVES | CONFUSION | PREVIEWS


def _accumulator(seed: int, n_images: int) -> SegMapAccumulator:
    rng = np.random.default_rng(seed)
    acc = SegMapAccumulator()
    for _ in range(n_images):
        k = int(rng.integers(0, 12))
        acc.add_image(rng.random(k).astype(np.float32), rng.random(k) < 0.8,
                      rng.random((k, 10)) < 0.4, rng.random((k, 10)) < 0.3,
                      int(rng.integers(0, 4)))
    return acc


def _names(d):
    return {p.name for p in d.iterdir()}


@pytest.mark.parametrize("seed,n_images", [(0, 6), (1, 20), (2, 1), (3, 0)])
def test_curve_data_equals_the_reference(seed, n_images):
    acc = _accumulator(seed, n_images)
    scores = np.concatenate(acc.scores) if acc.scores else np.zeros(0, np.float32)
    tps = np.concatenate(acc.tp_box) if acc.tp_box else np.zeros((0, 10), bool)
    want = jplots._curve_data(scores, tps, acc.n_gt)
    got = plots._curve_data(scores, tps, acc.n_gt)
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_an_empty_accumulator_draws_no_curve(tmp_path):
    for fn in (plots.plot_curves, plots.plot_confusion):
        fn(SegMapAccumulator(), tmp_path)
    empty = SegMapAccumulator()
    empty.add_image(np.zeros(3, np.float32), np.zeros(3, bool), np.zeros((3, 10), bool),
                    np.zeros((3, 10), bool), 2)
    plots.plot_curves(empty, tmp_path)
    assert _names(tmp_path) == set()


def _results_csv(path):
    cols = ["epoch", "time"] + list(plots.RESULTS_PANELS)
    rng = np.random.default_rng(5)
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(cols)
        for e in range(1, 4):
            w.writerow([e, 1.5 * e] + [f"{v:.5f}" for v in rng.random(len(cols) - 2)])


def _batch(seed: int, b: int = 5, s: int = 64):
    rng = np.random.default_rng(seed)
    xy = rng.random((b, 4, 2)) * s / 2
    return {"images": rng.random((b, s, s, 3)).astype(np.float32),
            "boxes": np.concatenate([xy, xy + rng.random((b, 4, 2)) * s / 2 + 1], -1),
            "valid": rng.random((b, 4)) < 0.6}


def test_each_function_writes_the_reference_file_names(tmp_path):
    ref, port = tmp_path / "ref", tmp_path / "port"
    for d in (ref, port):
        d.mkdir()
        _results_csv(d / "results.csv")
    acc = _accumulator(0, 8)
    batches = [_batch(k) for k in range(3)]
    labels = {**_batch(9, b=7), "images": np.zeros((7, 64, 80), np.uint8)}
    for mod, d in ((jplots, ref), (plots, port)):
        mod.plot_results(d / "results.csv")
        mod.plot_curves(acc, d)
        mod.plot_confusion(acc, d)
        mod.plot_train_batches(batches, d)
        mod.plot_labels(labels, d, rows=[0, 2, 2, 5])
    assert _names(port) == _names(ref) == {"results.csv", "results.png", "labels.jpg",
                                           "train_batch0.jpg", "train_batch1.jpg",
                                           "train_batch2.jpg"} | CURVES | CONFUSION
    # torch tensors are taken as the arrays are
    again = tmp_path / "tensors"
    again.mkdir()
    plots.plot_train_batches([{k: torch.from_numpy(v) for k, v in batches[0].items()}], again)
    assert _names(again) == {"train_batch0.jpg"}


@pytest.fixture(scope="module")
def tiny_model():
    """YOLO11n-seg at random weights, f32, with the class prior zeroed so
    that NMS keeps detections at conf 0.25; and a validation batch at 64."""
    model, _ = create_model(nc=1, scale="n")
    sd = model.state_dict()
    for i in range(3):
        sd[f"model.23.cv3.{i}.2.bias"] = torch.zeros_like(sd[f"model.23.cv3.{i}.2.bias"])
    batch = {k: torch.from_numpy(v) for k, v in _batch(11, b=4).items()}
    return model, sd, batch


def _kept_boxes(model, sd, images):
    """The port's decode and NMS, written out: the boxes kept at conf 0.25,
    IoU 0.7, one list an image."""
    model.load_state_dict(sd)
    with torch.no_grad():
        out = model.eval()(images)
    box_d, cls_l, _ = dec.flatten_level_outputs(out, model.cfg.reg_max)
    anchors, strides = dec.make_anchors(64, 64)
    boxes = dec.decode_boxes(box_d, anchors, strides, model.cfg.reg_max)
    nb, _, keep, _ = nms_batch(boxes, torch.sigmoid(cls_l.float())[..., 0], 0.25, 0.7, 300)
    return [nb[b][keep[b]].numpy() for b in range(images.shape[0])]


def test_val_batch_draws_the_boxes_decode_and_nms_keep(tmp_path, monkeypatch, tiny_model):
    model, sd, batch = tiny_model
    drawn = {}
    real = plots._grid

    def spy(plt, imgs, boxes_of, color, path, **kw):
        drawn[path.name] = [np.asarray(boxes_of(b)) for b in range(imgs.shape[0])]
        return real(plt, imgs, boxes_of, color, path, **kw)

    monkeypatch.setattr(plots, "_grid", spy)
    plots.plot_val_batch(model, sd, batch, tmp_path)
    assert _names(tmp_path) == {"val_batch0_labels.jpg", "val_batch0_pred.jpg"}
    want = _kept_boxes(model, sd, batch["images"])
    assert sum(len(w) for w in want) > 0
    got = drawn["val_batch0_pred.jpg"]
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.reshape(-1, 4), w)
    for b, g in enumerate(drawn["val_batch0_labels.jpg"]):
        np.testing.assert_array_equal(g, batch["boxes"][b][batch["valid"][b]].numpy())


def test_a_device_error_in_the_val_preview_propagates(tmp_path, monkeypatch, tiny_model):
    model, sd, batch = tiny_model

    def fails(*a, **kw):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    monkeypatch.setattr(plots, "detect", fails)
    with pytest.raises(RuntimeError, match="CUDA error"):
        plots.plot_val_batch(model, sd, batch, tmp_path)
    assert _names(tmp_path) == set()


def test_a_drawing_failure_warns_and_training_goes_on(tmp_path, monkeypatch, caplog):
    def fails(*a, **kw):
        raise OSError("disk full")

    monkeypatch.setattr(plots, "_grid", fails)
    with caplog.at_level(logging.WARNING, logger="plots"):
        plots.plot_train_batches([_batch(0)], tmp_path)
    assert "train_batch" in caplog.text and "disk full" in caplog.text


def _without_matplotlib(monkeypatch):
    """matplotlib made unimportable, and the run's one warning not yet said;
    returns the list the warnings go to."""
    for name in [m for m in sys.modules if m == "matplotlib" or m.startswith("matplotlib.")]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.setattr(plots, "_missing_warned", False)
    said = []
    monkeypatch.setattr(plots.logger, "warning", lambda msg, *a, **kw: said.append(msg))
    return said


def _every_function(d, model, sd, batch):
    _results_csv(d / "results.csv")
    acc = _accumulator(0, 8)
    return {
        "plot_results": lambda: plots.plot_results(d / "results.csv"),
        "plot_curves": lambda: plots.plot_curves(acc, d),
        "plot_confusion": lambda: plots.plot_confusion(acc, d),
        "plot_train_batches": lambda: plots.plot_train_batches([_batch(0)], d),
        "plot_labels": lambda: plots.plot_labels(
            {**_batch(1), "images": np.zeros((5, 64, 64), np.uint8)}, d),
        "plot_val_batch": lambda: plots.plot_val_batch(model, sd, batch, d),
    }


@pytest.mark.parametrize("name", ["plot_results", "plot_curves", "plot_confusion",
                                  "plot_train_batches", "plot_labels", "plot_val_batch"])
def test_without_matplotlib_each_function_warns_once_and_writes_nothing(
        tmp_path, monkeypatch, tiny_model, name):
    said = _without_matplotlib(monkeypatch)
    fn = _every_function(tmp_path, *tiny_model)[name]
    fn()
    fn()
    assert len(said) == 1 and "matplotlib" in said[0]
    assert _names(tmp_path) == {"results.csv"}


def test_without_matplotlib_a_run_warns_once(tmp_path, monkeypatch, tiny_model):
    said = _without_matplotlib(monkeypatch)
    for fn in _every_function(tmp_path, *tiny_model).values():
        fn()
    assert len(said) == 1
    assert _names(tmp_path) == {"results.csv"}


# --------------------------------------------------------------------------
# a fold trained with the figures on, against the same fold without them
# --------------------------------------------------------------------------

OPTS = dict(epochs=2, batch_size=4, imgsz=64, max_fg=8, close_mosaic=1, amp=False)
FOLD = dict(fold_test=1, patients=["P1", "P2", "P30"], plano="axial", modalidades=["FLAIR"],
            mejora="CLAHE", num_cortes=6, k_folds=2)


@pytest.fixture(scope="module")
def folds(tmp_path_factory):
    root = tmp_path_factory.mktemp("plots_fold")
    write_dataset(root)
    out = {}
    for on in (False, True):
        model, _ = create_model(nc=1, scale="n")
        out[on] = root / f"plots_{on}"
        tengine.train_fold(model=model, dataset_dir=root / "MSLesSeg-Dataset" / "train",
                           output_dir=out[on], cfg=TrainConfig(plots=on, **OPTS), device="cpu",
                           **FOLD)
    return out


def test_a_fold_with_plots_writes_the_reference_figures(folds):
    base = {"args.yaml", "results.csv", "weights"}
    assert _names(folds[False]) == base
    assert _names(folds[True]) == base | FIGURES


def test_the_figures_leave_every_other_artifact_bit_for_bit(folds):
    def rows(d):
        with open(d / "results.csv") as f:
            return [r[:1] + r[2:] for r in csv.reader(f)]  # all but the time column

    assert rows(folds[True]) == rows(folds[False])
    args = {on: (folds[on] / "args.yaml").read_text() for on in folds}
    assert args[True] == args[False].replace("\nplots: false\n", "\nplots: true\n")
    assert _names(folds[True] / "weights") == _names(folds[False] / "weights")
    for name in ("best.pt", "last.pt"):
        a = tckpt.load_checkpoint(folds[True] / "weights" / name)
        b = tckpt.load_checkpoint(folds[False] / "weights" / name)
        _equal(a, b, name)


def _equal(a, b, where):
    if isinstance(a, torch.Tensor):
        assert torch.equal(a, b), where
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _equal(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{where}/{i}")
    else:
        assert a == b, where
