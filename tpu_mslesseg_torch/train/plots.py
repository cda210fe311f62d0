"""Training figures beside ``results.csv``.

Port of ``tpu_mslesseg/train/plots.py``: the reference's Ultralytics run
directory ships ``results.png``, the Box/Mask P, R, F1 and PR curves, the
confusion matrices, ``labels.jpg`` and the train and validation batch
previews beside ``results.csv`` (``plots: true`` in its ``args.yaml``). The
curves come from the last validation's seg-mAP accumulator (its
score-sorted match bits), ``results.png`` from ``results.csv``, the
previews from augmented batches, the prediction preview from the model's
own forward, decode and NMS.

Every figure is best-effort, as in the reference: a failure to draw or to
write one warns and training goes on. matplotlib is imported lazily on the
Agg backend; where it is not installed, one warning a run says so and no
figure is written. The model's forward in ``plot_val_batch`` runs outside
that guard: an error on the device propagates.
"""

from __future__ import annotations

import csv
from pathlib import Path

import numpy as np
import torch

from tpu_mslesseg_torch.infer import decode as dec
from tpu_mslesseg_torch.infer.nms import nms_batch
from tpu_mslesseg_torch.pipeline.logging_setup import get_logger

logger = get_logger(__file__)

_missing_warned = False  # matplotlib's absence is said once a run


def _mpl():
    """``matplotlib.pyplot`` on the Agg backend, or None where matplotlib is
    not installed (with one warning a run)."""
    global _missing_warned
    try:
        import matplotlib
    except ImportError:
        if not _missing_warned:
            _missing_warned = True
            logger.warning("⚠️ matplotlib no está instalado: no se escriben las figuras de "
                           "entrenamiento.")
        return None
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _np(t) -> np.ndarray:
    """A tensor (on any device) or array as a host numpy array."""
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


RESULTS_PANELS = (
    "train/box_loss", "train/seg_loss", "train/cls_loss", "train/dfl_loss",
    "metrics/precision(M)", "metrics/recall(M)", "val/box_loss", "val/seg_loss",
    "metrics/mAP50(M)", "metrics/mAP50-95(M)",
)


def plot_results(results_csv, out_path=None) -> None:
    """results.png: the 2 x 5 grid of loss and metric curves against the
    epoch, in the panel order of the reference's results.png."""
    results_csv = Path(results_csv)
    out_path = Path(out_path or results_csv.parent / "results.png")
    plt = _mpl()
    if plt is None:
        return
    try:
        with results_csv.open() as f:
            rows = list(csv.DictReader(f))
        if not rows:
            return
        epochs = [float(r["epoch"]) for r in rows]
        fig, axes = plt.subplots(2, 5, figsize=(18, 6))
        for ax, col in zip(axes.ravel(), RESULTS_PANELS):
            vals = [float(r.get(col, 0) or 0) for r in rows]
            ax.plot(epochs, vals, marker=".", markersize=3, linewidth=1)
            ax.set_title(col, fontsize=9)
            ax.grid(alpha=0.3)
        fig.suptitle(results_csv.parent.name)
        fig.tight_layout()
        fig.savefig(out_path, dpi=120)
        plt.close(fig)
    except Exception as e:  # an auxiliary figure
        logger.warning(f"⚠️ No se pudo generar results.png: {e}")


def _curve_data(scores, tps, n_gt):
    """Score-sorted cumulative P, R and F1 at IoU 0.5, and the PR curve's
    precision envelope on the 101-point recall grid: the arrays behind
    Ultralytics' curve plots."""
    order = np.argsort(-scores)
    conf = scores[order]
    t = tps[order, 0]
    tp_cum = np.cumsum(t)
    fp_cum = np.cumsum(~t)
    prec = tp_cum / np.maximum(tp_cum + fp_cum, 1e-9)
    rec = tp_cum / max(n_gt, 1)
    f1 = 2 * prec * rec / np.maximum(prec + rec, 1e-9)
    mrec = np.concatenate(([0.0], rec, [1.0]))
    mpre = np.concatenate(([1.0], prec, [0.0]))
    mpre = np.flip(np.maximum.accumulate(np.flip(mpre)))
    grid = np.linspace(0, 1, 101)
    pr = np.interp(grid, mrec, mpre)
    return conf, prec, rec, f1, grid, pr


CURVES = (("P_curve", "Confidence", "Precision"), ("R_curve", "Confidence", "Recall"),
          ("F1_curve", "Confidence", "F1"), ("PR_curve", "Recall", "Precision"))


def plot_curves(acc, out_dir) -> None:
    """Box{P,R,F1,PR}_curve.png and Mask...: the IoU 0.5 operating curves of
    the last validation's accumulated matches (``evalx.seg_map``)."""
    out_dir = Path(out_dir)
    if not acc.scores or np.concatenate(acc.scores).size == 0:
        return
    plt = _mpl()
    if plt is None:
        return
    try:
        scores = np.concatenate(acc.scores)
        for name, tps in (("Box", np.concatenate(acc.tp_box)),
                          ("Mask", np.concatenate(acc.tp_mask))):
            conf, prec, rec, f1, grid, pr = _curve_data(scores, tps, acc.n_gt)
            for (suffix, xl, yl), (x, y) in zip(CURVES, ((conf, prec), (conf, rec), (conf, f1),
                                                         (grid, pr))):
                fig, ax = plt.subplots(figsize=(6, 4))
                ax.plot(x, y, linewidth=1.5)
                ax.set_xlabel(xl)
                ax.set_ylabel(yl)
                ax.set_xlim(0, 1)
                ax.set_ylim(0, 1.05)
                ax.grid(alpha=0.3)
                ax.set_title(f"{name} {suffix.replace('_', ' ')} (lesion)")
                fig.tight_layout()
                fig.savefig(out_dir / f"{name}{suffix}.png", dpi=120)
                plt.close(fig)
    except Exception as e:
        logger.warning(f"⚠️ No se pudieron generar las curvas: {e}")


def plot_confusion(acc, out_dir, conf_thres: float = 0.25) -> None:
    """confusion_matrix.png and confusion_matrix_normalized.png: the 2 x 2
    lesion/background detection matrix at conf >= 0.25 (the IoU 0.5 column
    of the match bits; Ultralytics takes 0.45, as the reference says)."""
    out_dir = Path(out_dir)
    if not acc.scores:
        return
    plt = _mpl()
    if plt is None:
        return
    try:
        scores = np.concatenate(acc.scores)
        tpb = np.concatenate(acc.tp_box)
        sel = scores >= conf_thres
        tp = int(tpb[sel, 0].sum())
        fp = int((~tpb[sel, 0]).sum())
        fn = max(acc.n_gt - tp, 0)
        m = np.array([[tp, fp], [fn, 0]], float)
        for norm in (False, True):
            mm = m / np.maximum(m.sum(axis=0, keepdims=True), 1e-9) if norm else m
            fig, ax = plt.subplots(figsize=(5, 4))
            im = ax.imshow(mm, cmap="Blues")
            for (i, j), v in np.ndenumerate(mm):
                ax.text(j, i, f"{v:.2f}" if norm else f"{int(v)}",
                        ha="center", va="center", fontsize=12)
            ax.set_xticks([0, 1], ["lesion", "background"])
            ax.set_yticks([0, 1], ["lesion", "background"])
            ax.set_xlabel("True")
            ax.set_ylabel("Predicted")
            fig.colorbar(im)
            fig.tight_layout()
            name = "confusion_matrix_normalized" if norm else "confusion_matrix"
            fig.savefig(out_dir / f"{name}.png", dpi=120)
            plt.close(fig)
    except Exception as e:
        logger.warning(f"⚠️ No se pudo generar la matriz de confusión: {e}")


def _grid(plt, imgs, boxes_of, color: str, path, side: int | None = None, dpi: int = 80):
    """One figure of `imgs` [n, S, S] in grey, each with the boxes
    `boxes_of(b)` drawn in `color`, on a side x side grid."""
    n = imgs.shape[0]
    side = side or int(np.ceil(np.sqrt(n)))
    fig, axes = plt.subplots(side, side, figsize=(3 * side, 3 * side))
    axes = np.atleast_1d(axes).ravel()
    for b, ax in enumerate(axes):
        ax.axis("off")
        if b >= n:
            continue
        ax.imshow(imgs[b], cmap="gray", vmin=0, vmax=1)
        for x1, y1, x2, y2 in boxes_of(b):
            ax.add_patch(plt.Rectangle((x1, y1), x2 - x1, y2 - y1, fill=False,
                                       edgecolor=color, linewidth=1))
    fig.tight_layout()
    fig.savefig(path, dpi=dpi)
    plt.close(fig)


def plot_train_batches(batches, out_dir, max_imgs: int = 9) -> None:
    """train_batch<k>.jpg: each augmented batch's first images with their
    boxes (the reference's train_batch0/1/2.jpg)."""
    out_dir = Path(out_dir)
    plt = _mpl()
    if plt is None:
        return
    try:
        for k, batch in enumerate(batches):
            imgs = _np(batch["images"])[:max_imgs, ..., 0]
            boxes, valid = _np(batch["boxes"]), _np(batch["valid"])
            _grid(plt, imgs, lambda b: boxes[b][valid[b]], "#00CC66",
                  out_dir / f"train_batch{k}.jpg")
    except Exception as e:
        logger.warning(f"⚠️ No se pudieron generar los train_batch: {e}")


def plot_labels(train_set, out_dir, rows=None) -> None:
    """labels.jpg: the ground truth's statistics (instances a slice, box
    centres, box sizes), the counterpart of Ultralytics' labels.jpg.
    `train_set` is a ``train.data`` dataset or its ``as_dict()``; `rows`
    restricts it to a subset (one fold's pool rows)."""
    out_dir = Path(out_dir)
    plt = _mpl()
    if plt is None:
        return
    try:
        dd = train_set if isinstance(train_set, dict) else train_set.as_dict()
        boxes = _np(dd["boxes"]).astype(float)
        valid = _np(dd["valid"]).astype(bool)
        h, w = dd["images"].shape[1:3]
        if rows is not None:
            rows = np.unique(np.asarray(rows))
            boxes, valid = boxes[rows], valid[rows]
        flat = boxes[valid]
        cx = (flat[:, 0] + flat[:, 2]) / 2 / w
        cy = (flat[:, 1] + flat[:, 3]) / 2 / h
        bw = (flat[:, 2] - flat[:, 0]) / w
        bh = (flat[:, 3] - flat[:, 1]) / h
        fig, axes = plt.subplots(2, 2, figsize=(10, 8))
        axes[0, 0].hist(valid.sum(axis=1), bins=range(0, valid.shape[1] + 2))
        axes[0, 0].set_title("instancias por corte")
        axes[0, 1].hist(np.sqrt(bw * bh), bins=40)
        axes[0, 1].set_title("tamaño relativo de lesión")
        axes[1, 0].scatter(cx, cy, s=4, alpha=0.4)
        axes[1, 0].set_title("centros (x, y)")
        axes[1, 0].set_xlim(0, 1)
        axes[1, 0].set_ylim(1, 0)
        axes[1, 1].scatter(bw, bh, s=4, alpha=0.4)
        axes[1, 1].set_title("ancho x alto")
        fig.tight_layout()
        fig.savefig(out_dir / "labels.jpg", dpi=100)
        plt.close(fig)
    except Exception as e:
        logger.warning(f"⚠️ No se pudo generar labels.jpg: {e}")


def detect(model, images, conf: float = 0.25, iou: float = 0.7, max_det: int = 300):
    """`model`'s detections on images [B, S, S, 3] (float, [0, 1]), on the
    model's device: its forward, the boxes decoded on the stride grid, NMS.
    Returns (boxes [B, max_det, 4], keep [B, max_det]) on the device."""
    with torch.no_grad():
        out = model(images)
        reg_max = model.cfg.reg_max
        box_d, cls_l, _ = dec.flatten_level_outputs(out, reg_max)
        S = images.shape[1]
        anchors, strides = dec.make_anchors(S, S, device=box_d.device)
        boxes = dec.decode_boxes(box_d, anchors, strides, reg_max)
        scores = torch.sigmoid(cls_l.to(torch.float32))[..., 0]
        nb, _, keep, _ = nms_batch(boxes, scores, conf, iou, max_det)
    return nb, keep


def plot_val_batch(model, variables, val_batch, out_dir, conf: float = 0.25, iou: float = 0.7,
                   k: int = 0) -> None:
    """val_batch<k>_labels.jpg and val_batch<k>_pred.jpg: the first nine
    validation slices with their ground-truth boxes, and with the boxes that
    `model` holding `variables` (a served state_dict) keeps after decode and
    NMS at `conf` and `iou`. The forward runs on the model's device, outside
    the figures' guard: a device error propagates."""
    out_dir = Path(out_dir)
    plt = _mpl()
    if plt is None:
        return
    dev = next(model.parameters()).device
    model.load_state_dict(variables)
    model.to(dev).eval()
    images = val_batch["images"][:9]
    nb, keep = detect(model, images.to(dev, torch.float32), conf, iou)
    nb, keep = _np(nb), _np(keep)
    imgs = _np(images)[..., 0]
    gt_boxes, gt_valid = _np(val_batch["boxes"])[:9], _np(val_batch["valid"])[:9]
    try:
        for suffix, color, boxes_of in (
                ("labels", "#00CC66", lambda b: gt_boxes[b][gt_valid[b]]),
                ("pred", "#FF4500", lambda b: nb[b][keep[b]])):
            _grid(plt, imgs, boxes_of, color, out_dir / f"val_batch{k}_{suffix}.jpg", side=3)
    except Exception as e:
        logger.warning(f"⚠️ No se pudo generar val_batch{k}: {e}")
