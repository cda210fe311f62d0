"""Training every fold at once, end to end.

Port of ``tpu_mslesseg/train/engine_parallel.py``, the stage-2 default of a
full experiment. One slice pool of all patients is built once on the card
(CLAHE's kernels run there under ``--mejora CLAHE``), each fold trains on
its own patients' rows of it (``train/fold_parallel.py``) and validates on
its own held-out patients, and every micro-step advances every fold. On one
card the folds take turns, as the reference's single-chip program
time-multiplexes them; over several ranks (``core.mesh.RankGrid``) each
fold slot trains its block of folds and splits each fold's batch over its
data ranks. Padding folds of the grid are not trained: the reference trains
and then discards them.

Every decision is the reference's: ``batch -1`` probes one fold's
micro-step, the batch shrinks to the smallest pool (``n_min``) and
``steps_per_epoch = n_min // batch``; validation every ``val_every`` epochs
and at the last; per fold ``args.yaml``, ``results.csv``, ``best.pt`` when
its fitness is at least its best, ``fitness.json``, ``epoch<N>.pt`` every
``save_period``; ``last.pt`` of each fold and the stacked resume point
``_parallel/last.pt`` every 10 epochs and at the end. Resume is atomic
across folds, from the stacked point. Early stopping is collective: the run
stops once every validated fold has gone ``patience`` validations without
a gain. A fold that never validated keeps its final weights as ``best.pt``.
The per-fold files are the sequential engine's (``train/engine.py``), so
``entrenamiento_exitoso`` and the serve read them unchanged.

Over several ranks each fold slot's first rank validates its folds and
sends rank 0 what it writes (``core.distributed.gather_to_main``): rank 0
writes every file. The per-epoch records reach every rank, so every rank
takes the same best and stopping decisions. With ``plots`` on, rank 0 then
writes each fold's figures (``train/plots.py``): ``results.png``,
``labels.jpg`` of the fold's pool rows, and the curves and confusion
matrices of its last validation, whose accumulator the fold's lead rank
sends.
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
from tpu_mslesseg_torch.pipeline.logging_setup import get_logger
from tpu_mslesseg_torch.pipeline.paciente import calcular_fold
from tpu_mslesseg_torch.train import augment, autobatch, checkpoint, engine, fold_parallel
from tpu_mslesseg_torch.train import data as tdata
from tpu_mslesseg_torch.train import plots, trainer, validate
from tpu_mslesseg_torch.train.losses import LOSS_PARTS, LossConfig
from tpu_mslesseg_torch.train.trainer import TrainConfig, fitness

logger = get_logger(__file__)

STACKED = Path("_parallel") / "last.pt"  # under the output root


def _to_main(states: dict, folds, fn, lead: bool):
    """{fold: fn(its state)} for `folds`, from the ranks that lead them, on
    rank 0 (None elsewhere)."""
    mine = {f: checkpoint._to_cpu(fn(states[f])) for f in folds if lead and f in states}
    got = distributed.gather_to_main(mine)
    return None if got is None else {f: v for part in got for f, v in part.items()}


def train_folds_parallel(
    model,
    patients: list,
    plano: str,
    modalidades: list,
    mejora: str | None,
    num_cortes: int | None,
    dataset_dir,
    output_root,
    cfg: TrainConfig = TrainConfig(),
    k_folds: int = 5,
    grid=None,
    val_every: int = 1,
    resume: bool = True,
    device="cuda",
) -> dict:
    """Train every fold of `patients` on `device` (raises when it cannot be
    used); ``output_root/fold<k>/`` receives each fold's files. `grid` is
    the ranks' ``core.mesh.RankGrid``, or None for one process. Returns
    ``{"fold<k>": {"fitness": ...}}``."""
    dev = exigir(device, kernels_de(mejora))
    output_root = Path(output_root)
    n_data, k_pad, lead = 1, k_folds, True
    local = range(k_folds)
    axis = None
    if grid is not None:
        n_data, k_pad = grid.data, pad_to_multiple(k_folds, grid.fold)
        local, lead = grid.folds_of(k_pad), grid.is_data_lead
        axis = grid.data_axis(global_batch=False)
    local = [f for f in local if f < k_folds]  # padding folds are not trained

    pool = tdata.build_dataset(patients, plano, modalidades, mejora, num_cortes, dataset_dir,
                               train_size=cfg.imgsz, device=dev)
    pools, counts = fold_parallel.build_fold_index_pools(pool.meta, k_folds, calcular_fold,
                                                         k_pad=k_pad)
    acfg = {m: augment.AugConfig(imgsz=cfg.imgsz, max_inst=pool.max_inst, mosaic=m)
            for m in (True, False)}
    # batch=-1: one fold's micro-step is the peak (the folds take turns and
    # the other folds' states are small beside its activations)
    if cfg.batch_size == -1:
        cfg = dataclasses.replace(cfg, batch_size=autobatch.auto_batch_size(
            model, cfg, pool, acfg[True], n_data=n_data, device=dev))
    if n_data > 1:
        bs = max(pad_to_multiple(cfg.batch_size, n_data), n_data)
        if bs != cfg.batch_size:
            logger.info(f"📐 Batch {cfg.batch_size} -> {bs} (eje data={n_data}).")
            cfg = dataclasses.replace(cfg, batch_size=bs)
    n_min = int(counts[:k_folds].min())
    if cfg.batch_size > n_min:
        eff = max(1 << max((n_min // 2).bit_length() - 1, 2), 4)
        eff = max(pad_to_multiple(eff, n_data), n_data)
        logger.info(f"📉 Batch ajustado a {eff} (pool mínimo de {n_min} cortes).")
        cfg = dataclasses.replace(cfg, batch_size=eff)
    steps_per_epoch = max(n_min // cfg.batch_size, 1)
    logger.info(f"🧠 Entrenamiento fold-parallel: {k_folds} folds"
                + (f" (+{k_pad - k_folds} relleno)" if k_pad > k_folds else "")
                + f", pool de {len(pool)} cortes, {steps_per_epoch} pasos/época.")

    states = fold_parallel.init_multi_fold_state(model, cfg, steps_per_epoch, local, device=dev)
    if axis is not None:
        for st in states.values():
            axis.broadcast_module(st.model)

    # resume from the stacked point: every fold restarts at the same epoch
    start_epoch = 1
    stacked_ckpt = output_root / STACKED
    if resume and checkpoint.checkpoint_exists(stacked_ckpt):
        try:
            stacked = checkpoint.load_checkpoint(stacked_ckpt)
            for f, st in states.items():
                st.load_state_dict(fold_parallel.extract_fold_state(stacked, f))
            step = max(int(sd["step"]) for sd in stacked["folds"].values())
            start_epoch = step // steps_per_epoch + 1
            logger.info(f"🔁 Reanudando todos los folds desde la época {start_epoch}.")
        except (OSError, RuntimeError, KeyError, ValueError, pickle.UnpicklingError) as e:
            logger.warning(f"⚠️ No se pudo reanudar desde el checkpoint apilado: {e}")
            states = fold_parallel.init_multi_fold_state(model, cfg, steps_per_epoch, local,
                                                         device=dev)

    # per fold: args.yaml, results.csv, the validation set, the stopper state
    loss_cfg = LossConfig(imgsz=cfg.imgsz, max_fg=cfg.max_fg)
    fold_dirs = [output_root / f"fold{f + 1}" for f in range(k_folds)]
    writers, best_fits, best_epochs, val_sets = [], [], [], {}
    for f, out in enumerate(fold_dirs):
        if distributed.is_main_process():
            (out / "weights").mkdir(parents=True, exist_ok=True)
        engine._write_args_yaml(out / "args.yaml", cfg, plano=plano, modalidades=modalidades,
                                mejora=mejora, num_cortes=num_cortes, fold_test=f + 1,
                                k_folds=k_folds)
        writers.append(trainer.ResultsWriter(out / "results.csv", append=start_epoch > 1,
                                             from_epoch=start_epoch))
        if f in states and lead:
            _, test_ids = tdata.fold_patient_split(patients, f + 1, k_folds)
            try:
                val_sets[f] = tdata.build_dataset(
                    test_ids, plano, modalidades, mejora, num_cortes, dataset_dir,
                    train_size=cfg.imgsz, max_inst=pool.max_inst, device=dev)
            except (ValueError, FileNotFoundError) as e:
                logger.warning(f"⚠️ Fold {f + 1} sin cortes de validación: {e}")
                val_sets[f] = None
        bf, be = checkpoint.load_stopper_state(out / "weights", start_epoch)
        best_fits.append(bf)
        best_epochs.append(be)
    # fitness.json is rank 0's: every rank takes its view of the resumed
    # stopper state, so no rank's best-save or stop can part from the others'
    flat = distributed.broadcast_from_main(best_fits + [float(e) for e in best_epochs])
    best_fits, best_epochs = flat[:k_folds], [int(x) for x in flat[k_folds:]]
    vals_since_best = [max(0, (start_epoch - 1 - be) // max(val_every, 1)) for be in best_epochs]
    val_model = create_model(nc=model.cfg.nc, scale=model.cfg.scale, dtype=model.dtype)[0] \
        if any(v is not None for v in val_sets.values()) else None
    sched = trainer.lr_schedule(cfg, steps_per_epoch)
    sched_bias = trainer.lr_schedule(cfg, steps_per_epoch, start=cfg.warmup_bias_lr)
    dd = pool.as_dict()
    val_accs = {}  # fold -> its last validation's accumulator, for the curves

    def save(kind: str, folds, fn) -> None:
        """Rank 0 writes ``weights/<kind>.pt`` of `folds` from `fn(state)`."""
        got = _to_main(states, folds, fn, lead)
        if got is not None:
            for f, sd in sorted(got.items()):
                checkpoint.save_checkpoint(fold_dirs[f] / "weights" / f"{kind}.pt", sd)

    def save_last() -> None:
        """The stacked resume point and every fold's ``last.pt``."""
        got = _to_main(states, range(k_folds), lambda st: st.state_dict(), lead)
        if got is not None:
            checkpoint.save_checkpoint(stacked_ckpt, fold_parallel.stack_states(got))
            for f, sd in sorted(got.items()):
                checkpoint.save_checkpoint(fold_dirs[f] / "weights" / "last.pt", sd)

    for epoch in range(start_epoch, cfg.epochs + 1):
        a = acfg[epoch <= cfg.epochs - cfg.close_mosaic]
        parts = {f: [] for f in states}
        for _ in range(steps_per_epoch):
            for f, st in states.items():
                m = fold_parallel.fold_step(st, pools[f], counts[f], dd, a, axis)
                parts[f].append(torch.stack([m[k] for k in LOSS_PARTS]))

        do_val = epoch % val_every == 0 or epoch == cfg.epochs
        records = {}
        for f, st in (states.items() if lead else ()):
            # the epoch's mean train losses: one fetch from the device a fold
            train_losses = dict(zip(LOSS_PARTS,
                                    torch.stack(parts[f]).mean(0).tolist()))
            val_metrics, val_losses = {}, {}
            if do_val and val_sets[f] is not None:
                val_metrics, val_losses, val_accs[f] = validate.run_validation(
                    val_model, st.served_state_dict(), val_sets[f], loss_cfg,
                    batch_size=min(cfg.batch_size, 16), imgsz=cfg.imgsz, return_acc=True,
                    device=dev)
            last = st.step - 1
            records[f] = (train_losses, val_metrics, val_losses,
                          (float(sched_bias(last)), float(sched(last))), val_sets[f] is not None)
        records = {f: r for part in distributed.all_gather_objects(records)
                   for f, r in part.items()}

        improved = []
        for f in range(k_folds):
            train_losses, val_metrics, val_losses, lr, _ = records[f]
            writers[f].write_epoch(epoch, train_losses, val_metrics, val_losses, lr)
            fit = fitness(val_metrics)
            if val_metrics and fit >= best_fits[f]:
                best_fits[f], best_epochs[f], vals_since_best[f] = fit, epoch, 0
                improved.append(f)
            elif val_metrics:
                vals_since_best[f] += 1
        mean = {k: sum(records[f][0][k] for f in range(k_folds)) / k_folds
                for k in LOSS_PARTS}
        map50 = [round(records[f][1].get("map50_m", 0.0), 3) for f in range(k_folds)]
        logger.info(f"🏋️ Época {epoch}/{cfg.epochs}: pérdida media "
                    + "/".join(f"{mean[k]:.3f}" for k in LOSS_PARTS)
                    + (f" mAP50(M) por fold {map50}" if do_val else ""))

        if improved:
            save("best", improved, lambda st: st.served_state_dict())
            if distributed.is_main_process():
                for f in improved:
                    checkpoint.write_fitness(fold_dirs[f] / "weights", best_fits[f],
                                             best_epochs[f])
        saved_last = epoch % engine.LAST_EVERY == 0 or epoch == cfg.epochs
        if saved_last:
            save_last()
        if cfg.save_period > 0 and epoch % cfg.save_period == 0:
            save(f"epoch{epoch}", range(k_folds), lambda st: st.served_state_dict())
        if do_val and cfg.patience > 0:
            # the folds advance together, so the stop is collective: every
            # validated fold has gone `patience` validations without a gain
            stalled = [vals_since_best[f] >= cfg.patience
                       for f in range(k_folds) if records[f][4]]
            if stalled and all(stalled):
                logger.info(f"🛑 Detención temprana en la época {epoch}: ningún fold mejora "
                            f"desde hace {cfg.patience} validaciones (mejores épocas "
                            f"{best_epochs}).")
                if not saved_last:
                    save_last()
                break

    # a fold that never validated, with no earlier best: its final weights
    # (rank 0's filesystem decides, every rank joins the save)
    never = distributed.broadcast_from_main([
        float(best_fits[f] < 0 and not checkpoint.checkpoint_exists(
            fold_dirs[f] / "weights" / "best.pt")) for f in range(k_folds)])
    if any(never):
        save("best", [f for f in range(k_folds) if never[f]], lambda st: st.served_state_dict())
    if cfg.plots:
        got = distributed.gather_to_main(val_accs if lead else {})
        if got is not None:
            accs = {f: acc for part in got for f, acc in part.items()}
            for f in range(k_folds):
                plots.plot_results(fold_dirs[f] / "results.csv")
                plots.plot_labels(pool, fold_dirs[f], rows=pools[f][: int(counts[f])])
                if f in accs:
                    plots.plot_curves(accs[f], fold_dirs[f])
                    plots.plot_confusion(accs[f], fold_dirs[f])
    summary = {}
    for f in range(k_folds):
        summary[f"fold{f + 1}"] = {"fitness": max(best_fits[f], 0.0)}
        logger.info(f"✅ Fold {f + 1}: fitness={max(best_fits[f], 0.0):.3f}")
    return summary
