"""The collectives of the port's sharded train step, over the process
groups of a live :class:`torch.distributed.device_mesh.DeviceMesh`.

Every launch appends one :class:`Collective` (kind, dtype, elements, mesh
axis) to :data:`RECORD`, the port's counterpart of the reference's scan of
a compiled step's HLO for its collectives (``test_grad_allreduce_dtype_in_hlo``,
``launch/dryrun.py``'s ``collective_stats``); :func:`reset` clears it, as
``kernels.ops.reset_launches`` clears the kernel counts.

A tensor split over mesh axes (:class:`repro_torch.sharding.Placements`)
holds, on each rank, the block at its row-major coordinate over those axes
in mesh order: :func:`shard` cuts that block out of the full tensor and
:func:`gather` puts the full tensor back together from every rank's block.
"""
from __future__ import annotations

from typing import Iterable, List, NamedTuple, Tuple

import torch
import torch.distributed as dist

from repro_torch.sharding.rules import Placements, mesh_shape


class Collective(NamedTuple):
    kind: str              # "all_gather" | "all_reduce"
    dtype: torch.dtype     # what crosses the wire
    elements: int          # each rank's input tensor
    group: str             # the mesh axis whose process group ran it

    @property
    def nbytes(self) -> int:
        """Bytes of each rank's input."""
        return self.elements * self.dtype.itemsize


#: every collective launched since the last :func:`reset`, in order
RECORD: List[Collective] = []


def reset() -> None:
    RECORD.clear()


def all_gather(t: torch.Tensor, dim: int, mesh, axis: str) -> torch.Tensor:
    """``t`` of every rank of ``axis``'s group concatenated along ``dim``,
    in coordinate order."""
    n = mesh_shape(mesh)[axis]
    inp = t.contiguous()
    flat = inp.reshape(-1)
    out = flat.new_empty((n * flat.numel(),))
    RECORD.append(Collective("all_gather", inp.dtype, inp.numel(), axis))
    # all_gather_single is the newer name of all_gather_into_tensor
    gather_single = getattr(dist, "all_gather_single", None) or \
        dist.all_gather_into_tensor
    gather_single(out, flat, group=mesh.get_group(axis))
    shape = list(inp.shape)
    shape[dim] *= n
    return out.reshape((n,) + tuple(inp.shape)).movedim(0, dim).reshape(
        shape)


def all_reduce(t: torch.Tensor, mesh, axes: Iterable[str],
               op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``t`` reduced in place over the groups of ``axes``, one after the
    other (a sum over several axes is the sum over their product)."""
    for axis in axes:
        RECORD.append(Collective("all_reduce", t.dtype, t.numel(), axis))
        dist.all_reduce(t, op=op, group=mesh.get_group(axis))
    return t


def coordinate(mesh, axes: Tuple[Tuple[str, int], ...]) -> Tuple[int, int]:
    """(this rank's row-major index over ``axes`` ((name, size) pairs in
    mesh order), their product)."""
    k, n = 0, 1
    for name, size in axes:
        k = k * size + mesh.get_local_rank(name)
        n *= size
    return k, n


def shard(full: torch.Tensor, pl: Placements, mesh) -> torch.Tensor:
    """This rank's block of ``full`` (its own storage where anything is
    split, ``full`` itself where every split axis has one rank)."""
    out = full
    for d, axes in pl.dim_axes(full.ndim).items():
        k, n = coordinate(mesh, axes)
        if n > 1:
            chunk = out.shape[d] // n
            out = out.narrow(d, k * chunk, chunk)
    return full if out is full else out.clone()


def gather(local: torch.Tensor, pl: Placements, mesh) -> torch.Tensor:
    """The full tensor from every rank's block: one all-gather per mesh
    axis that splits a dim, the innermost axis first.  ``local`` may be a
    layer's slice of a stacked tensor (``pl`` is the stack's)."""
    for d, axes in pl.dim_axes(local.ndim).items():
        for name, _ in reversed(axes):
            local = all_gather(local, d, mesh, name)
    return local


class _SumOverBatch(torch.autograd.Function):
    """A sum over ranks whose backward sums again: the sum of every rank's
    gradient for its input is then the gradient of one copy of a value
    every rank computes from the sum."""

    @staticmethod
    def forward(ctx, t, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return all_reduce(t.clone(), mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.clone(), ctx.mesh, ctx.axes), None, None


def sum_over(t: torch.Tensor, mesh, axes: Tuple[str, ...]) -> torch.Tensor:
    """Differentiable sum of ``t`` over the ranks of ``axes``, for a term
    that every rank adds to its loss with weight 1 / (the ranks): summed
    over ranks, the gradients are the term's."""
    return _SumOverBatch.apply(t, mesh, tuple(axes))
