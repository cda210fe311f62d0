"""Fast serving path: the fused consensus predictor as a product feature.

Port of ``tpu_mslesseg/pipeline/rapido.py``. It runs the computation of the
stage chain (``generar_predicciones`` -> ``reconstruir_volumen`` ->
``generar_consenso`` -> ``eval``) — enhancement, letterbox, per-plane
forward with that plane's trained fold weights, NMS, proto-mask union,
per-modality mask union, inverse-letterbox sampling, volume scatter,
consensus vote, confusion counts — through
``infer.consensus3.ConsensusPredictor`` on the device, then writes the
standard artifacts:

* ``pred_vols/<base>_<E>epochs/fold<k>/<pid>/<pid>_<plano>.nii.gz``
* ``..._consenso.nii.gz``           (when all three planes have weights)
* ``results/.../<pid>_<plano>_results.json``  (+ consenso), the eval
  stage's schema and values.

Two entries:

* ``ejecutar_paciente_rapido`` — patient mode, one patient per call.
* ``ejecutar_fold_rapido`` — full mode, the whole test fold with
  ``LOTE_PACIENTES`` patients per dispatch. Patients group by (planes,
  volume shape); within a group, slice counts pad to the group max with
  out-of-range scatter indices, which write nothing.

Weights are each plane's fold checkpoint ``weights/best.pt`` (a state_dict,
``train/checkpoint.py``). Slice indices come from the stage-1 extracted
images, so the served slices are exactly the stage chain's. The device is
the caller's, CUDA by default: without a card the predictor fails rather
than serve on the CPU unasked. A single process that sees several cards
splits each patient's slice axis over all of them
(`_dispositivos_para_servicio`, ``ConsensusPredictor(devices=...)``); under
several ranks each rank serves unsplit, as the reference does.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from tpu_mslesseg_torch.core import distributed
from tpu_mslesseg_torch.evalx import metrics as mx
from tpu_mslesseg_torch.infer.consensus3 import ConsensusPredictor
from tpu_mslesseg_torch.io import nifti
from tpu_mslesseg_torch.model.yolo11 import create_model_from_env
from tpu_mslesseg_torch.pipeline.logging_setup import get_logger
from tpu_mslesseg_torch.pipeline.modelo import Modelo
from tpu_mslesseg_torch.pipeline.paciente import Paciente, calcular_fold, listar_pacientes
from tpu_mslesseg_torch.pipeline.paths import (
    ConfigConsenso,
    ConfigEval,
    ConfigPred,
    existe_modelo_entrenado,
)
from tpu_mslesseg_torch.pipeline.stages.eval import escribir_json
from tpu_mslesseg_torch.pipeline.stages.generar_predicciones import indices_de_imagenes
from tpu_mslesseg_torch.train import checkpoint

logger = get_logger(__file__)

PLANOS = ("axial", "coronal", "sagital")

# patients per dispatch in fold mode, the JAX package's default
LOTE_PACIENTES = 4


def _cargar_variables(config_pred):
    return checkpoint.load_checkpoint(config_pred.model_path)


def _recolectar_paciente(modelo, paciente, epochs, k_folds, umbral, cache_vars):
    """Collect one patient's serving payload: planes with trained fold
    weights + extracted slices, the artifact pairs this path owns, GT.

    Returns None when the fast path can't serve this patient (missing
    model for ``modelo.plano``, no extracted images, no GT). State_dicts
    are cached per (plano, fold) in ``cache_vars`` so a whole fold loads
    each plane's checkpoint once."""
    pid = paciente.id
    fold = calcular_fold(pid, k_folds)

    planes, variables, slices, idx = [], {}, {}, {}
    eval_cfgs = {}
    for plano in PLANOS:
        m = Modelo(
            plano=plano, num_cortes=modelo.num_cortes,
            modalidad=modelo.modalidad, k_folds=k_folds, mejora=modelo.mejora,
        )
        if not existe_modelo_entrenado(m, epochs, fold):
            continue
        pac = Paciente(
            id=pid, plano=plano, modalidad=m.modalidad, mejora=m.mejora,
            dataset_dir=paciente.base_dir.parent,  # Paciente stores <ds>/<pid>
        )
        cfgp = ConfigPred(modelo=m, epochs=epochs, k_folds=k_folds, paciente=pac)
        dirs = cfgp.paciente_dirs(pid)
        indices = indices_de_imagenes(dirs["images"]) if dirs["images"].is_dir() else []
        if not indices:
            logger.warning(f"⚠️ Sin imágenes extraídas ({plano}) para {pid}.")
            continue
        planes.append(plano)
        if (plano, fold) not in cache_vars:
            cache_vars[(plano, fold)] = _cargar_variables(cfgp)
        variables[plano] = cache_vars[(plano, fold)]
        idx[plano] = np.asarray(indices, np.int32)
        slices[plano] = {mod: pac.cortes_imagen_batch(indices, mod) for mod in m.modalidad}
        eval_cfgs[plano] = ConfigEval(
            modelo=m, epochs=epochs, k_folds=k_folds, paciente=pac,
        )

    if modelo.plano not in planes:
        logger.warning(
            f"⚠️ Vía rápida no disponible para {pid}: falta el modelo "
            f"{modelo.plano} del fold {fold}."
        )
        return None

    # artifact pairs this path owns: (volume, metrics json) per plane,
    # plus the consenso pair when all three planes serve
    pares = []
    for plano in planes:
        paths = eval_cfgs[plano].paths_paciente(pid)
        pares.append((plano, Path(paths["pred_vol"]), Path(paths["results_json"])))
    if len(planes) == 3:
        cc = ConfigConsenso(
            modelo=modelo, epochs=epochs, k_folds=k_folds,
            paciente=paciente, umbral=umbral,
        )
        me = ConfigEval(
            modelo=modelo, epochs=epochs, k_folds=k_folds,
            paciente=paciente, plano_forzado="consenso",
        )
        pares.append((
            "consenso", Path(cc.consenso_path(pid)),
            Path(me.paths_paciente(pid)["results_json"]),
        ))

    gt_path = eval_cfgs[modelo.plano].paths_paciente(pid)["gt_vol"]
    if not gt_path.exists():
        logger.warning(f"⚠️ Sin GT para {pid}: {gt_path}.")
        return None
    gt_img = nifti.load(gt_path)
    return {
        "pid": pid,
        "fold": fold,
        "planes": tuple(planes),
        "variables": variables,
        "slices": slices,
        "idx": idx,
        "pares": pares,
        "gt": gt_img.get_fdata().astype(np.float32),
        "affine": gt_img.affine,
    }


def _limpiar_o_saltar(payload, limpiar) -> bool:
    """Apply the idempotence contract to one patient's pairs. Returns
    True when the patient can be SKIPPED (complete artifacts, no
    limpiar); after ``limpiar`` everything this path owns is removed."""
    if limpiar:
        for _, vol_path, rj in payload["pares"]:
            for p in (vol_path, rj):
                if p.exists():
                    p.unlink()
                    logger.info(f"🧹 Eliminado {p}.")
        return False
    return all(v.exists() and r.exists() for _, v, r in payload["pares"])


def _escribir_artefactos(payload, counts, cons, vols):
    """Write one patient's fetched results (host arrays) as the standard
    artifacts. A complete (volume, json) pair skips; an incomplete pair is
    rewritten WHOLE so the metrics on disk always describe the volume next
    to them."""
    for plano, vol_path, rj in payload["pares"]:
        if vol_path.exists() and rj.exists():
            logger.skip(f"⏩ Par de artefactos existente ({plano}).")
            continue
        vol_arr = cons if plano == "consenso" else vols[plano]
        vol_path.parent.mkdir(parents=True, exist_ok=True)
        nifti.save(np.asarray(vol_arr, np.float32), payload["affine"], vol_path)
        met = mx.metrics_from_counts(counts[plano])
        escribir_json(met, rj)
        logger.info(f"✅ Métricas ({plano}): {met}")


def _a_host(resultado):
    """Fetch one dispatch's (counts, consensus, volumes) to numpy."""
    counts, cons, vols = resultado
    return (
        {k: v.cpu().numpy() for k, v in counts.items()},
        None if cons is None else cons.cpu().numpy(),
        {p: v.cpu().numpy() for p, v in vols.items()},
    )


def ejecutar_paciente_rapido(
    modelo, paciente, epochs: int = 50, k_folds: int = 5, umbral: int = 2,
    limpiar: bool = False, device="cuda",
) -> bool:
    """Serve one patient through the consensus predictor on `device` and
    write the standard volume + metrics artifacts. Returns True on success,
    False when the preconditions fail (the caller falls back to the stage
    chain).

    Idempotence matches the stage chain: complete (volume, metrics) PAIRS
    skip; an incomplete pair is rewritten WHOLE from a fresh prediction so
    the metrics on disk always describe the volume next to them; and
    ``limpiar`` invalidates everything this path owns first."""
    payload = _recolectar_paciente(
        modelo, paciente, epochs, k_folds, umbral, cache_vars={}
    )
    if payload is None:
        return False
    if _limpiar_o_saltar(payload, limpiar):
        logger.skip(f"⏩ Vía rápida: artefactos completos para {payload['pid']}.")
        return True

    # per-plane weights; consensus iff 3 planes. Model resolution shared
    # with the prediction stage
    model, _, imgsz = create_model_from_env()
    cp = ConsensusPredictor(
        model, payload["variables"], payload["gt"].shape, mejora=modelo.mejora,
        imgsz=imgsz, umbral=umbral, planes=payload["planes"],
        per_plane_counts=True, device=device,
    )
    counts, cons, vols = _a_host(cp(payload["slices"], payload["idx"], payload["gt"]))
    _escribir_artefactos(payload, counts, cons, vols)

    logger.info(
        f"⚡ Vía rápida completada para {payload['pid']} "
        f"({len(payload['planes'])} plano(s), fold {payload['fold']})."
    )
    return True


def _lote_arrays(grupo, planes, vol_shape):
    """Stack a group's payloads into the lote() batch: per plane, per
    modality [P, N_max, h, w] slices + [P, N_max] indices. Shorter
    patients pad with zero slices and out-of-range scatter indices, which
    write nothing."""
    oob = max(vol_shape)
    slices, idx = {}, {}
    for plano in planes:
        n_max = max(p["idx"][plano].size for p in grupo)
        mods = list(grupo[0]["slices"][plano])
        slices[plano] = {
            mod: np.stack([
                np.pad(
                    p["slices"][plano][mod],
                    ((0, n_max - p["idx"][plano].size), (0, 0), (0, 0)),
                )
                for p in grupo
            ])
            for mod in mods
        }
        idx[plano] = np.stack([
            np.pad(
                p["idx"][plano], (0, n_max - p["idx"][plano].size),
                constant_values=oob,
            )
            for p in grupo
        ])
    gts = np.stack([p["gt"] for p in grupo])
    return slices, idx, gts


def _dispositivos_para_servicio(device) -> list | None:
    """The cards `lote` splits the slice axis over, or None (unsplit). Only
    a single process on a CUDA `device` that sees more than one card splits:
    under several ranks every rank serves its own patients on its own card
    (the reference's ``_mesh_para_servicio``: a mesh there would span
    devices the process cannot address)."""
    dev = torch.device(device)
    if dev.type != "cuda" or distributed.process_count() > 1 or torch.cuda.device_count() < 2:
        return None
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def ejecutar_fold_rapido(
    modelo, epochs: int = 50, k_folds: int = 5, fold_test: int = 1,
    umbral: int = 2, limpiar: bool = False, lote_size: int = LOTE_PACIENTES,
    device="cuda",
) -> bool:
    """Serve the WHOLE test fold through the consensus predictor on
    `device`, ``lote_size`` patients per dispatch, writing each patient's
    standard artifacts. Returns True when every fold patient was served
    (or skipped as complete); False on a precondition failure — the
    orchestrator then falls back to the per-stage chain for the fold.

    One predictor per (planes, volume-shape) group: within a group, slice
    counts pad to the group max with out-of-range indices and the final
    partial batch pads by repeating its last patient (the repeats' results
    are not written). Results drain one dispatch deep: ``lote`` returns
    device tensors, and batch i is fetched and written after batch i+1 is
    enqueued."""
    cfgp = ConfigPred(
        modelo=modelo, epochs=epochs, k_folds=k_folds, fold_test=fold_test
    )
    try:
        pacientes = (
            listar_pacientes(cfgp.dataset_fold_dir)
            if cfgp.dataset_fold_dir.is_dir()
            else []
        )
    except FileNotFoundError:
        pacientes = []
    if not pacientes:
        logger.warning(f"⚠️ Vía rápida: fold {fold_test} sin pacientes extraídos.")
        return False

    # collect every patient's payload (weights cached per plane)
    cache_vars = {}
    payloads, incompletos = [], False
    for pid in pacientes:
        pac = Paciente(
            id=pid, plano=modelo.plano, modalidad=modelo.modalidad,
            mejora=modelo.mejora, dataset_dir=cfgp.dataset_entrada,
        )
        payload = _recolectar_paciente(
            modelo, pac, epochs, k_folds, umbral, cache_vars
        )
        if payload is None:
            incompletos = True
            continue
        if _limpiar_o_saltar(payload, limpiar):
            logger.skip(f"⏩ Vía rápida: artefactos completos para {pid}.")
            continue
        payloads.append(payload)

    if incompletos:
        return False  # stage chain handles the fold (warn-and-continue)
    if not payloads:
        logger.skip(f"⏩ Vía rápida: fold {fold_test} completo.")
        return True

    # group by (planes, volume shape): one predictor per group
    grupos = {}
    for p in payloads:
        grupos.setdefault((p["planes"], p["gt"].shape), []).append(p)

    model, _, imgsz = create_model_from_env()
    devices = _dispositivos_para_servicio(device)
    if devices is not None:
        logger.info(f"🕸️ Vía rápida sobre {len(devices)} GPUs: cortes de cada paciente repartidos.")
    for (planes, vol_shape), grupo in grupos.items():
        cp = ConsensusPredictor(
            model, grupo[0]["variables"], vol_shape, mejora=modelo.mejora,
            imgsz=imgsz, umbral=umbral, planes=planes, per_plane_counts=True,
            device=device, devices=devices,
        )
        pendientes = []  # (patients, device results): depth-1 pipeline
        for i in range(0, len(grupo), lote_size):
            chunk = grupo[i : i + lote_size]
            real = len(chunk)
            # pad the partial final batch by repeating the last patient so
            # every dispatch of the group has one shape
            chunk = chunk + [chunk[-1]] * (lote_size - real)
            slices, idx, gts = _lote_arrays(chunk, planes, vol_shape)
            pendientes.append((chunk[:real], cp.lote(slices, idx, gts)))
            if len(pendientes) > 1:
                _drenar_lote(*pendientes.pop(0))
        for pend in pendientes:
            _drenar_lote(*pend)

    logger.info(
        f"⚡ Vía rápida completada para el fold {fold_test} "
        f"({len(payloads)} paciente(s), lotes de {lote_size})."
    )
    return True


def _drenar_lote(chunk, resultado):
    """Fetch one dispatched batch and write its patients' artifacts."""
    counts, cons, vols = _a_host(resultado)
    for i, payload in enumerate(chunk):
        _escribir_artefactos(
            payload,
            {k: counts[k][i] for k in counts},
            None if cons is None else cons[i],
            {p: vols[p][i] for p in vols},
        )
