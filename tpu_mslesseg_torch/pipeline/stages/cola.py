"""The dispatch/fetch queue that stages 3 and 4 share.

A stage handles a patient in two steps: `despachar` computes on the device
and returns a pending result (or None for a skip, False for nothing to do),
`finalizar` fetches it and writes the artifacts. At most `depth` patients
stay pending, so the memory held on the device does not grow with the fold.
"""

from __future__ import annotations

from tpu_mslesseg_torch.core.device import es_fallo_de_dispositivo


def procesar_en_cola(pacientes, despachar, finalizar, depth: int, avisar) -> list:
    """Every patient of `pacientes` through `despachar(pid)` and, `depth`
    patients later, `finalizar(pendiente)`; returns the results (None, False
    or `finalizar`'s) in order. A patient whose step raises is reported
    through `avisar(pid, error)` and left out, unless the error is the
    device's or a kernel's: that one is raised."""
    resultados, pendientes = [], []

    def intentar(pid, paso, *args):
        try:
            return True, paso(*args)
        except Exception as e:
            if es_fallo_de_dispositivo(e):
                raise
            avisar(pid, e)
            return False, None

    def drenar(pid, pendiente):
        if pendiente is None or pendiente is False:
            resultados.append(pendiente)
            return
        ok, res = intentar(pid, finalizar, pendiente)
        if ok:
            resultados.append(res)

    for pid in pacientes:
        ok, pendiente = intentar(pid, despachar, pid)
        if ok:
            pendientes.append((pid, pendiente))
        if len(pendientes) >= depth:
            drenar(*pendientes.pop(0))
    for pid, pendiente in pendientes:
        drenar(pid, pendiente)
    return resultados
