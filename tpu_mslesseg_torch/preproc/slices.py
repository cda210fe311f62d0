"""Slice-count resolution: fixed int or dataset-percentile.

Port of ``tpu_mslesseg/preproc/slices.py`` (host only).
Reference: ``extraer_dataset.py:110-156`` — for ``num_cortes="P<n>"`` the
slice budget is the n-th percentile of per-patient lesion-slice counts
across the whole train set.
"""

from __future__ import annotations

import numpy as np

from tpu_mslesseg_torch.pipeline.paciente import Paciente, listar_pacientes


def calcular_num_cortes_percentil(input_dir, plano, modalidad, percentil=50):
    pacientes = listar_pacientes(input_dir)
    counts = []
    for pid in pacientes:
        p = Paciente(id=pid, plano=plano, modalidad=modalidad, dataset_dir=input_dir)
        counts.append(len(p.indices_a_usar()))
    if not counts:
        raise ValueError(
            f"No se encontraron cortes con lesión válidos para calcular el percentil en {input_dir}."
        )
    return int(np.percentile(counts, percentil))


def resolver_num_cortes(num_cortes, input_dir, plano, modalidad):
    """Returns (resolved_num_cortes, percentil_or_None)."""
    if isinstance(num_cortes, int) or num_cortes is None:
        return num_cortes, None
    if isinstance(num_cortes, str) and num_cortes.startswith("P"):
        percentil = int(num_cortes[1:])
        n = calcular_num_cortes_percentil(
            input_dir=input_dir, plano=plano, modalidad=modalidad, percentil=percentil
        )
        return n, percentil
    raise ValueError(f"Formato de num_cortes no válido: {num_cortes}.")


def int_o_percentil(valor):
    """argparse type: int or 'P<n>' percentile string
    (reference ``utils/utils.py:343-356``)."""
    import argparse

    try:
        return int(valor)
    except ValueError:
        if isinstance(valor, str) and valor.upper().startswith("P") and valor[1:].isdigit():
            return valor.upper()
        raise argparse.ArgumentTypeError(
            "El valor debe ser un entero o un string de formato 'PX' (ejemplo: P10)."
        )
