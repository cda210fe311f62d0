"""Training one cross-validation fold, end to end.

Port of ``tpu_mslesseg/train/engine.py``, the reference's ``entrenar_fold``
(``train.py:346-389``: copy the fold's files into subsets, write a dataset
YAML, ``YOLO(...).train(...)``). Here the fold's datasets are built on the
device (no file copies) and each epoch is a Python loop of micro-steps:
mosaic augmentation (closed for the last ``close_mosaic`` epochs), the train
step with its optimizer cadence and EMA, a validation pass for the losses
and box/mask mAP, a ``results.csv`` row, the fitness and the best/last
checkpoints. Every decision is the reference's: the batch rules, resume
from ``last.pt``, validation every ``val_every`` epochs and at the last,
``last.pt`` every 10 epochs and at the end, ``best.pt`` when the fitness is
at least the best so far, patience counted in validations.

Over several ranks (``axis``, a ``core.mesh.DataAxis`` with
``global_batch``, the counterpart of the reference's ``mesh=``) each rank
trains on its share of every batch and validates its share of every
validation batch, the step being one step over the whole batch; rank 0
writes every file (the port's checkpoints are single-process writes, the
reference's Orbax saves collective ones). With ``plots`` on, rank 0 then
writes the reference's figures beside ``results.csv`` (``train/plots.py``),
after every checkpoint: they take nothing from the training chain.
"""

from __future__ import annotations

import dataclasses
import pickle
from pathlib import Path

import torch

from tpu_mslesseg_torch.core import distributed
from tpu_mslesseg_torch.core.device import exigir, kernels_de
from tpu_mslesseg_torch.core.mesh import pad_to_multiple
from tpu_mslesseg_torch.model.yolo11 import create_model
from tpu_mslesseg_torch.pipeline import yaml_out
from tpu_mslesseg_torch.pipeline.logging_setup import get_logger
from tpu_mslesseg_torch.train import augment, autobatch, checkpoint, plots, trainer, validate
from tpu_mslesseg_torch.train import data as tdata
from tpu_mslesseg_torch.train.losses import LossConfig
from tpu_mslesseg_torch.train.trainer import TrainConfig, fitness

logger = get_logger(__file__)

LAST_EVERY = 10  # epochs between last.pt saves (and the final epoch)


def _write_args_yaml(path, cfg: TrainConfig, **extra) -> None:
    """The run's options beside its weights (rank 0 writes it)."""
    if not distributed.is_main_process():
        return
    payload = {**dataclasses.asdict(cfg), **extra}
    payload = {k: (list(v) if isinstance(v, (tuple, set)) else v) for k, v in payload.items()}
    yaml_out.write(path, payload, sort_keys=True)


def _save(path, state_dict) -> None:
    """A checkpoint every rank holds, written by rank 0."""
    if distributed.is_main_process():
        checkpoint.save_checkpoint(path, state_dict)


def _write_figures(out: Path, cfg: TrainConfig, train_set, acfg, val_acc, val_set, val_model,
                   state) -> None:
    """The reference's figures beside ``results.csv`` (rank 0):
    ``results.png``, the last validation's curves and confusion matrices,
    three augmented preview batches drawn from a generator of their own
    (outside the training chain), ``labels.jpg`` and the validation preview
    pair from the EMA weights."""
    if plots._mpl() is None:
        return
    plots.plot_results(out / "results.csv")
    if val_acc is not None:
        plots.plot_curves(val_acc, out)
        plots.plot_confusion(val_acc, out)
    gen = torch.Generator().manual_seed(cfg.seed + 7919)
    n, dd = min(cfg.batch_size, 9), train_set.as_dict()
    previews = []
    for _ in range(3):
        idx = torch.randint(0, len(train_set), (n, 4), generator=gen)
        previews.append(augment.make_batch(augment.draw_params(gen, acfg, n), dd, idx, acfg))
    plots.plot_train_batches(previews, out)
    plots.plot_labels(train_set, out)
    if val_set is not None and len(val_set) > 0:
        acfg_v = validate.val_aug_config(val_set.max_inst, cfg.imgsz)
        nv = min(9, len(val_set))
        params = augment.draw_params(torch.Generator().manual_seed(0), acfg_v, nv)
        vb = augment.make_batch(params, val_set.as_dict(), torch.arange(nv)[:, None].repeat(1, 4),
                                acfg_v)
        plots.plot_val_batch(val_model, state.served_state_dict(), vb, out)


def run_epoch(state, dd: dict, n_slices: int, acfg: augment.AugConfig, axis=None) -> dict:
    """One epoch of micro-steps over a dataset's `dd` (``as_dict()``) of
    `n_slices` slices: the epoch's source indices and each micro-step's
    augmentation drawn from ``state.gen``, the mosaic as `acfg` says, then
    `trainer.train_step` at ``state.cfg.batch_size`` (this rank's part of
    it over `axis`). Returns the epoch's mean loss parts, fetched from the
    device once."""
    bs = state.cfg.batch_size
    idx = tdata.epoch_indices(state.gen, n_slices, bs, acfg.mosaic)
    part = axis.local_slice(bs) if axis is not None else slice(None)
    parts = []
    for i in range(idx.shape[0]):
        params = augment.draw_params(state.gen, acfg, bs).rows(part)
        m = trainer.train_step(state, augment.make_batch(params, dd, idx[i][part], acfg), axis)
        parts.append(torch.stack([m[k] for k in validate.LOSS_PARTS]))
    return dict(zip(validate.LOSS_PARTS, torch.stack(parts).mean(0).tolist()))


def train_fold(
    model,
    fold_test: int,
    patients: list,
    plano: str,
    modalidades: list,
    mejora: str | None,
    num_cortes: int | None,
    dataset_dir,
    output_dir,
    cfg: TrainConfig = TrainConfig(),
    k_folds: int = 5,
    val_every: int = 1,
    resume: bool = True,
    device="cuda",
    axis=None,
) -> dict:
    """Train one fold of `patients` on `device` (raises when it cannot be
    used), data-parallel over `axis` when one is given. Returns a summary
    dict."""
    dev = exigir(device, kernels_de(mejora))
    out = Path(output_dir)
    weights = out / "weights"
    if distributed.is_main_process():
        weights.mkdir(parents=True, exist_ok=True)
    n_data = axis.size if axis is not None else 1

    train_ids, test_ids = tdata.fold_patient_split(patients, fold_test, k_folds)
    logger.info(f"🧠 Fold {fold_test}: train={len(train_ids)} test={len(test_ids)} pacientes")
    _write_args_yaml(out / "args.yaml", cfg, plano=plano, modalidades=modalidades, mejora=mejora,
                     num_cortes=num_cortes, fold_test=fold_test, k_folds=k_folds)

    train_set = tdata.build_dataset(train_ids, plano, modalidades, mejora, num_cortes,
                                    dataset_dir, train_size=cfg.imgsz, device=dev)
    try:
        val_set = tdata.build_dataset(test_ids, plano, modalidades, mejora, num_cortes,
                                      dataset_dir, train_size=cfg.imgsz,
                                      max_inst=train_set.max_inst, device=dev)
    except (ValueError, FileNotFoundError) as e:
        logger.warning(f"⚠️ Fold {fold_test} sin cortes de validación: {e}")
        val_set = None
    logger.info(f"📦 Dataset en dispositivo: {len(train_set)} cortes train, "
                f"{len(val_set) if val_set else 0} val, max_inst={train_set.max_inst}")

    acfg = {m: augment.AugConfig(imgsz=cfg.imgsz, max_inst=train_set.max_inst, mosaic=m)
            for m in (True, False)}
    # batch=-1 (the reference's default): the largest batch the card holds
    if cfg.batch_size == -1:
        cfg = dataclasses.replace(cfg, batch_size=autobatch.auto_batch_size(
            model, cfg, train_set, acfg[True], n_data=n_data, device=dev))
    # never larger than the dataset: a power of two around n/2, so a tiny
    # dataset still gives several steps an epoch
    if cfg.batch_size > len(train_set):
        eff = max(1 << max((len(train_set) // 2).bit_length() - 1, 2), 4)
        logger.info(f"📉 Batch ajustado a {eff} (dataset de {len(train_set)} cortes).")
        cfg = dataclasses.replace(cfg, batch_size=eff)
    # over a data axis the batch is a multiple of its size
    bs = max(pad_to_multiple(cfg.batch_size, n_data), n_data)
    if bs != cfg.batch_size:
        logger.info(f"📐 Batch {cfg.batch_size} -> {bs} (eje data={n_data}).")
        cfg = dataclasses.replace(cfg, batch_size=bs)

    steps_per_epoch = max(len(train_set) // cfg.batch_size, 1)
    state = trainer.init_train_state(model, cfg, steps_per_epoch, device=dev)
    if axis is not None:
        axis.broadcast_module(state.model)
    start_epoch = 1
    last_ckpt = weights / "last.pt"
    if resume and checkpoint.checkpoint_exists(last_ckpt):
        try:
            state.load_state_dict(checkpoint.load_checkpoint(last_ckpt))
            start_epoch = state.step // steps_per_epoch + 1
            logger.info(f"🔁 Reanudando desde la época {start_epoch} (last.pt).")
        except (OSError, RuntimeError, KeyError, ValueError, pickle.UnpicklingError) as e:
            logger.warning(f"⚠️ No se pudo reanudar desde last.pt: {e}")
            state = trainer.init_train_state(model, cfg, steps_per_epoch, device=dev)
    loss_cfg = LossConfig(imgsz=cfg.imgsz, max_fg=cfg.max_fg)
    # validation runs on a second module holding the EMA parameters and the
    # live BatchNorm statistics: the training model is never overwritten
    val_model = create_model(nc=model.cfg.nc, scale=model.cfg.scale, dtype=model.dtype)[0] \
        if val_set is not None else None
    results = trainer.ResultsWriter(out / "results.csv", append=start_epoch > 1,
                                    from_epoch=start_epoch)
    sched = trainer.lr_schedule(cfg, steps_per_epoch)
    sched_bias = trainer.lr_schedule(cfg, steps_per_epoch, start=cfg.warmup_bias_lr)
    dd = train_set.as_dict()
    val_acc = None  # the last validation's accumulator, for the curves

    # the best fitness lives beside the weights, so a resumed run never
    # demotes an earlier, better best.pt; validations since the last
    # improvement are rebuilt from its epoch and the validation cadence
    best_fit, best_epoch = checkpoint.load_stopper_state(weights, start_epoch)
    # fitness.json is rank 0's: every rank takes its view, so no rank's
    # best-save or stop can part from the others'
    best_fit, be = distributed.broadcast_from_main([best_fit, float(best_epoch)])
    best_epoch = int(be)
    vals_since_best = max(0, (start_epoch - 1 - best_epoch) // max(val_every, 1))
    epochs_run = start_epoch - 1
    for epoch in range(start_epoch, cfg.epochs + 1):
        use_mosaic = epoch <= cfg.epochs - cfg.close_mosaic
        train_losses = run_epoch(state, dd, len(train_set), acfg[use_mosaic], axis)

        if val_set is not None and (epoch % val_every == 0 or epoch == cfg.epochs):
            val_metrics, val_losses, val_acc = validate.run_validation(
                val_model, state.served_state_dict(), val_set, loss_cfg,
                batch_size=pad_to_multiple(min(cfg.batch_size, 16), n_data), imgsz=cfg.imgsz,
                return_acc=True, device=dev, axis=axis)
        else:
            val_metrics, val_losses = {}, {}

        # the learning rate the last micro-step's schedule gives, as logged
        last = state.step - 1
        results.write_epoch(epoch, train_losses, val_metrics, val_losses,
                            (float(sched_bias(last)), float(sched(last))))
        fit = fitness(val_metrics)
        logger.info(
            f"🏋️ Epoch {epoch}/{cfg.epochs} loss(box/seg/cls/dfl)="
            f"{train_losses['box']:.3f}/{train_losses['seg']:.3f}/"
            f"{train_losses['cls']:.3f}/{train_losses['dfl']:.3f} "
            f"mAP50(M)={val_metrics.get('map50_m', 0):.3f} fitness={fit:.3f}"
        )

        saved_last = epoch % LAST_EVERY == 0 or epoch == cfg.epochs
        if saved_last:
            _save(last_ckpt, state.state_dict())
        if cfg.save_period > 0 and epoch % cfg.save_period == 0:
            _save(weights / f"epoch{epoch}.pt", state.served_state_dict())
        if val_metrics and fit >= best_fit:
            best_fit, best_epoch, vals_since_best = fit, epoch, 0
            _save(weights / "best.pt", state.served_state_dict())
            if distributed.is_main_process():
                checkpoint.write_fitness(weights, best_fit, best_epoch)
        elif val_metrics:
            vals_since_best += 1
        epochs_run = epoch
        if val_metrics and cfg.patience > 0 and vals_since_best >= cfg.patience:
            # upstream EarlyStopping, counted in validations; a resumable
            # last.pt is kept at the break
            logger.info(f"🛑 Detención temprana en la época {epoch}: sin mejora de fitness "
                        f"desde la época {best_epoch} (patience={cfg.patience}).")
            if not saved_last:
                _save(last_ckpt, state.state_dict())
            break

    if best_fit < 0 and not checkpoint.checkpoint_exists(weights / "best.pt"):
        # no validation ever ran and no earlier best exists: the final
        # weights are the best
        _save(weights / "best.pt", state.served_state_dict())
    if cfg.plots and distributed.is_main_process():
        _write_figures(out, cfg, train_set, acfg[True], val_acc, val_set, val_model, state)

    return {
        "best_fitness": best_fit,
        "epochs": epochs_run,  # epochs trained (fewer than cfg.epochs when patience fired)
        "train_slices": len(train_set),
        "val_slices": len(val_set) if val_set else 0,
        "weights_dir": str(weights),
        "batch_size": cfg.batch_size,
        "steps_per_epoch": steps_per_epoch,
    }


def entrenamiento_exitoso(output_dir) -> bool:
    """The training-success check (reference ``train.py:105-116``): best
    and last checkpoints and ``results.csv`` present."""
    out = Path(output_dir)
    return (checkpoint.checkpoint_exists(out / "weights" / "best.pt")
            and checkpoint.checkpoint_exists(out / "weights" / "last.pt")
            and (out / "results.csv").exists())
