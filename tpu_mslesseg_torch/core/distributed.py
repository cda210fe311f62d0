"""Several processes: ``torch.distributed``, and host writes gated to rank 0.

Port of ``tpu_mslesseg/core/distributed.py``. The JAX package runs one
process a host over all of that host's chips; here one process (a rank)
drives one card, and `maybe_initialize` joins the ranks into one process
group: ``nccl`` between cards, ``gloo`` between CPU processes. The ranks
come from ``torchrun --nproc_per_node N`` (``RANK``, ``WORLD_SIZE``,
``MASTER_ADDR``, ``MASTER_PORT``, ``LOCAL_RANK``) or from the JAX package's
own variables:

* ``TPU_MSLESSEG_COORDINATOR``  "host:port" of rank 0
* ``TPU_MSLESSEG_NUM_PROCS``    number of ranks
* ``TPU_MSLESSEG_PROC_ID``      this rank (0-based)
* ``TPU_MSLESSEG_MULTIHOST``    opt in with torchrun's variables alone

Nothing tells a program of a cluster, so a rank's count and index are
always given. A process that sees several cards and was started without a
launcher trains on its first card and says so once (`advertir_una_gpu`).

Every rank runs the same stage code, so every host-side artifact
(``results.csv``, ``args.yaml``, the dataset YAML, ``fitness.json``, JSON
metrics, NIfTI and PNG outputs, the log file) is written by rank 0 only:
`is_main_process` and `main_process_only` gate them. Checkpoints too: the
JAX package's Orbax saves are collective (every process calls them and
Orbax writes), while ``torch.save`` writes one file from one process, so
the port's checkpoints are rank-0 writes of states every rank holds or has
sent to rank 0 (`gather_to_main`). A resumed rank reads them back from the
same path, so several hosts need a shared filesystem, as Orbax's restore
does.
"""

from __future__ import annotations

import functools
import logging
import os

import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)

ENV_COORD = "TPU_MSLESSEG_COORDINATOR"
ENV_NPROC = "TPU_MSLESSEG_NUM_PROCS"
ENV_PID = "TPU_MSLESSEG_PROC_ID"
ENV_OPTIN = "TPU_MSLESSEG_MULTIHOST"
TORCHRUN = ("RANK", "WORLD_SIZE", "MASTER_ADDR")

_warned_one_card = False


def env_rank() -> int:
    """This process's rank as its launcher's variables give it (0 when
    none does), readable before any initialisation."""
    for var in (ENV_PID, "RANK"):
        v = os.environ.get(var, "")
        if v != "":
            return int(v)
    return 0


def maybe_initialize(coordinator_address: str | None = None, num_processes: int | None = None,
                     process_id: int | None = None, device="cuda") -> bool:
    """Join this process to the process group from explicit arguments or the
    environment. Returns True when the group is (or already was) up, False
    for a single process (nothing set: a no-op). The backend is ``nccl`` for
    a CUDA `device` (each rank then takes card ``LOCAL_RANK``, or its rank
    modulo the cards it sees) and ``gloo`` for the CPU. Call it before the
    first use of a card."""
    if dist.is_initialized():
        return True
    coord = coordinator_address or os.environ.get(ENV_COORD)
    opt_in = os.environ.get(ENV_OPTIN, "") not in ("", "0", "false")
    torchrun = all(v in os.environ for v in TORCHRUN)
    if coord is None and not opt_in and not torchrun:
        return False
    world = num_processes if num_processes is not None else \
        os.environ.get(ENV_NPROC, os.environ.get("WORLD_SIZE"))
    rank = process_id if process_id is not None else \
        os.environ.get(ENV_PID, os.environ.get("RANK"))
    if world is None or rank is None:
        raise ValueError(
            f"proceso distribuido sin tamaño o rango: defina {ENV_NPROC} y {ENV_PID}, "
            "o lance con torchrun")
    world, rank = int(world), int(rank)
    init = f"tcp://{coord}" if coord else "env://"
    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK", rank % max(torch.cuda.device_count(), 1)))
        torch.cuda.set_device(local)
    dist.init_process_group(backend, init_method=init, world_size=world, rank=rank)
    logger.info("torch.distributed: rango %d/%d, backend %s", rank, world, backend)
    return True


def shutdown() -> None:
    """Leave the process group (tests, a clean exit)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_main_process() -> bool:
    """True on rank 0 (always for a single process): it gates every
    host-side write, checkpoints included."""
    return process_index() == 0


def main_process_only(fn):
    """Decorator: `fn` runs on rank 0 only; other ranks get None."""
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        return fn(*args, **kwargs) if is_main_process() else None

    return wrapper


def comm_device(group=None) -> torch.device:
    """Where a collective's tensors live: the current card under ``nccl``,
    the CPU under ``gloo``."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def barrier() -> None:
    """Block until every rank reaches this point."""
    if process_count() > 1:
        dist.barrier()


def broadcast_from_main(values) -> list:
    """Rank 0's list of floats on every rank, exactly (a float64 tensor
    broadcast: the resumed best fitness feeds a ``>=`` test, so a float32
    round trip could accept a worse model). Identity for a single process."""
    if process_count() == 1:
        return [float(v) for v in values]
    t = torch.tensor([float(v) for v in values], dtype=torch.float64, device=comm_device())
    dist.broadcast(t, src=0)
    return t.cpu().tolist()


def all_gather_objects(obj) -> list:
    """Every rank's picklable `obj`, in rank order, on every rank."""
    if process_count() == 1:
        return [obj]
    out = [None] * process_count()
    dist.all_gather_object(out, obj)
    return out


def gather_to_main(obj) -> list | None:
    """Every rank's picklable `obj`, in rank order, on rank 0; None on the
    others."""
    if process_count() == 1:
        return [obj]
    out = [None] * process_count() if is_main_process() else None
    dist.gather_object(obj, out, dst=0)
    return out


def advertir_una_gpu(dev: torch.device) -> None:
    """Says once that a single process seeing several cards trains on its
    first one, and how to use them all."""
    global _warned_one_card
    if _warned_one_card or dev.type != "cuda" or process_count() > 1:
        return
    n = torch.cuda.device_count()
    if n > 1:
        _warned_one_card = True
        logger.warning(
            f"⚠️ {n} GPUs visibles y un solo proceso: se entrena en la primera. Para usarlas "
            f"todas, lance un rango por GPU: torchrun --nproc_per_node {n} -m "
            "tpu_mslesseg_torch.pipeline.ejecutar_pipeline ...")
