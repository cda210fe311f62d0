"""The ranks as a (fold, data) grid, and the data axis's collectives.

Port of ``tpu_mslesseg/core/mesh.py``. The JAX package lays its devices out
as a (fold, data) ``Mesh``: the ``fold`` axis trains cross-validation folds
side by side, the ``data`` axis splits each fold's batch. Here the grid is
of ranks (one card each, `core.distributed`): rank ``r`` sits in fold slot
``r // data`` at data index ``r % data``, and each slot's data ranks form a
process group of their own (``dist.new_group``), the ``data`` axis's
collectives. ``NamedSharding``, ``shard_batch`` and ``maybe_mesh`` are JAX
forms with no counterpart: a rank holds its part of a batch itself.

A `DataAxis` says how a step uses that group, in one of the JAX package's
two semantics:

* ``global_batch=True`` (the sequential engine's program, sharded over
  ``data`` by XLA): the ranks' batches are one batch. BatchNorm normalises
  with the whole batch's statistics, the loss divides by the whole batch's
  normalisers, and the gradients are summed: the step equals one process's
  on the concatenated batch, but for float32 rounding.
* ``global_batch=False`` (the fold-parallel engine's ``shard_map`` with
  ``pmean``): each rank normalises and divides by its own batch, then the
  gradients, the BatchNorm running statistics and the reported losses are
  averaged over the group.

``DistributedDataParallel`` gives neither (it averages gradients of
per-rank losses and broadcasts rank 0's buffers), so the steps call the
collectives themselves.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist

from tpu_mslesseg_torch.core import distributed


def pad_to_multiple(n: int, m: int) -> int:
    """Smallest multiple of m that is >= n."""
    return ((n + m - 1) // m) * m


class _AllReduceSum(torch.autograd.Function):
    """A sum over a process group whose backward is the same sum."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        out = t.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


@dataclass(frozen=True)
class DataAxis:
    """One fold slot's data ranks and how a step reduces over them."""

    group: object  # the process group of `ranks`
    ranks: tuple  # global ranks, in data-index order
    index: int  # this rank's data index
    global_batch: bool

    @property
    def size(self) -> int:
        return len(self.ranks)

    def local_slice(self, n: int) -> slice:
        """This rank's contiguous share of `n` rows (`n` a multiple of the
        axis size)."""
        per = n // self.size
        return slice(self.index * per, (self.index + 1) * per)

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of `t` over the axis, in place (no gradient)."""
        dist.all_reduce(t, group=self.group)
        return t

    def all_reduce_grad(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of `t` over the axis, with a gradient (the backward sums
        the gradients over the axis in turn)."""
        return _AllReduceSum.apply(t, self.group)

    def all_gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's `t` concatenated along dim 0, in data-index order."""
        src = t.to(torch.uint8) if t.dtype == torch.bool else t.contiguous()
        parts = [torch.empty_like(src) for _ in self.ranks]
        dist.all_gather(parts, src, group=self.group)
        out = torch.cat(parts, 0)
        return out.to(torch.bool) if t.dtype == torch.bool else out

    def broadcast_module(self, module: torch.nn.Module) -> None:
        """The axis's first rank's parameters and buffers on every rank of
        it (the seeded initialisations already agree: this makes it so)."""
        with torch.no_grad():
            for t in list(module.parameters()) + list(module.buffers()):
                dist.broadcast(t.data, src=self.ranks[0], group=self.group)


@dataclass(frozen=True)
class RankGrid:
    """The (fold, data) grid of the process group's ranks."""

    fold: int  # fold-axis size: slots training folds side by side
    data: int  # data-axis size: ranks splitting one fold's batch
    rank: int
    groups: tuple  # per fold slot, the process group of its data ranks

    @property
    def fold_index(self) -> int:
        return self.rank // self.data

    @property
    def data_index(self) -> int:
        return self.rank % self.data

    @property
    def is_data_lead(self) -> bool:
        """The first rank of its slot: it speaks for the slot's folds."""
        return self.data_index == 0

    def folds_of(self, k_pad: int) -> range:
        """This slot's folds of `k_pad` (a multiple of ``fold``): a
        contiguous block, as ``shard_map`` splits a fold-stacked axis."""
        per = k_pad // self.fold
        return range(self.fold_index * per, (self.fold_index + 1) * per)

    def data_axis(self, global_batch: bool) -> DataAxis | None:
        """This slot's data axis, or None when it has one rank."""
        if self.data == 1:
            return None
        s = self.fold_index
        return DataAxis(self.groups[s], tuple(range(s * self.data, (s + 1) * self.data)),
                        self.data_index, global_batch)


def make_grid(fold_parallel: int = 1) -> RankGrid:
    """The process group's ranks as a (fold_parallel, world / fold_parallel)
    grid; ``fold_parallel == 1`` is pure data parallelism. Every rank must
    call it (each slot's group is made by all of them, in the same order)."""
    world, rank = distributed.process_count(), distributed.process_index()
    if world % fold_parallel:
        raise ValueError(f"{world} rangos no divisibles por fold_parallel={fold_parallel}")
    data = world // fold_parallel
    groups = tuple(
        dist.new_group(list(range(s * data, (s + 1) * data))) if data > 1 else None
        for s in range(fold_parallel)
    )
    return RankGrid(fold=fold_parallel, data=data, rank=rank, groups=groups)
