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

The compute split over one mesh axis (:mod:`.tensor_parallel`) runs through
three differentiable operators: :func:`copy_to` (identity forward, the
gradient all-reduced in the backward), :func:`reduce_from` (all-reduce
forward, identity backward) and :func:`gather_from` (all-gather forward,
the rank's own slice of the gradient backward).

A gloo group handed CUDA tensors (several ranks sharing one card, where
NCCL refuses a second rank) stages them through host memory: the tensor
is copied to the host, reduced or gathered there, and copied back; such a
collective is recorded with ``staged=True``; on a group of one rank,
where the result is the input, it skips the round trip (and the call).
An NCCL group takes device tensors as they are.
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
    staged: bool = False   # a CUDA tensor staged through host memory
    tag: str = ""          # the operator that launched it, where one did

    @property
    def nbytes(self) -> int:
        """Bytes of each rank's input."""
        return self.elements * self.dtype.itemsize


#: every collective launched since the last :func:`reset`, in order
RECORD: List[Collective] = []


def reset() -> None:
    RECORD.clear()


def _staged(t: torch.Tensor, group) -> bool:
    """Whether ``t`` must cross ``group`` through host memory: a CUDA
    tensor on a gloo group."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _alone(staged: bool, n: int) -> bool:
    """A staged collective over one rank: its result is its input, so the
    host round trip is skipped."""
    return staged and n == 1


def all_gather(t: torch.Tensor, dim: int, mesh, axis: str,
               tag: str = "") -> torch.Tensor:
    """``t`` of every rank of ``axis``'s group concatenated along ``dim``,
    in coordinate order."""
    n = mesh_shape(mesh)[axis]
    group = mesh.get_group(axis)
    inp = t.contiguous()
    dim %= inp.ndim
    staged = _staged(inp, group)
    if _alone(staged, n):
        RECORD.append(Collective("all_gather", inp.dtype, inp.numel(), axis,
                                 False, tag))
        return inp
    flat = (inp.cpu() if staged else inp).reshape(-1)
    out = flat.new_empty((n * flat.numel(),))
    RECORD.append(Collective("all_gather", inp.dtype, inp.numel(), axis,
                             staged, tag))
    # all_gather_single is the newer name of all_gather_into_tensor
    gather_single = getattr(dist, "all_gather_single", None) or \
        dist.all_gather_into_tensor
    gather_single(out, flat, group=group)
    if staged:
        out = out.to(inp.device)
    shape = list(inp.shape)
    shape[dim] *= n
    return out.reshape((n,) + tuple(inp.shape)).movedim(0, dim).reshape(
        shape)


def all_reduce(t: torch.Tensor, mesh, axes: Iterable[str],
               op=dist.ReduceOp.SUM, tag: str = "") -> torch.Tensor:
    """``t`` reduced in place over the groups of ``axes``, one after the
    other (a sum over several axes is the sum over their product)."""
    for axis in axes:
        group = mesh.get_group(axis)
        staged = _staged(t, group)
        alone = _alone(staged, mesh_shape(mesh)[axis])
        RECORD.append(Collective("all_reduce", t.dtype, t.numel(), axis,
                                 staged and not alone, tag))
        if alone:
            continue
        if staged:
            host = t.cpu()
            dist.all_reduce(host, op=op, group=group)
            t.copy_(host)
        else:
            dist.all_reduce(t, op=op, group=group)
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


def gather(local: torch.Tensor, pl: Placements, mesh,
           keep: Tuple[str, ...] = (), tag: str = "") -> torch.Tensor:
    """The full tensor from every rank's block: one all-gather per mesh
    axis that splits a dim, the innermost axis first, each recorded with
    ``tag``.  ``local`` may be a layer's slice of a stacked tensor (``pl``
    is the stack's).  The axes in ``keep`` stay split (a vocab-parallel
    embedding keeps its rows, an expert-parallel stack its experts)."""
    for d, axes in pl.dim_axes(local.ndim).items():
        for name, _ in reversed(axes):
            if name not in keep:
                local = all_gather(local, d, mesh, name, tag=tag)
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


# ---------------------------------------------------------------------------
# the compute split's operators over one mesh axis
# ---------------------------------------------------------------------------

def _contiguous_copy(t: torch.Tensor) -> torch.Tensor:
    return t.clone(memory_format=torch.contiguous_format)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(_contiguous_copy(g), ctx.mesh, (ctx.axis,),
                          tag="copy_to"), None, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, mesh, axis):
        return all_reduce(_contiguous_copy(y), mesh, (axis,),
                          tag="reduce_from")

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        ctx.chunk = x.shape[dim]
        return all_gather(x, dim, mesh, axis, tag="gather_from")

    @staticmethod
    def backward(ctx, g):
        k = ctx.mesh.get_local_rank(ctx.axis)
        return g.narrow(ctx.dim, k * ctx.chunk, ctx.chunk).contiguous(), \
            None, None, None


def copy_to(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """``x`` as it is, in front of the split consumers of a replicated
    activation: each rank's gradient for ``x`` is partial (its own heads,
    columns or vocabulary rows), so the backward sums it over ``axis``."""
    return _CopyTo.apply(x, mesh, axis)


def reduce_from(y: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The sum over ``axis`` of every rank's partial ``y`` (after a
    row-split linear or a vocab-parallel lookup); the gradient of the
    replicated sum passes through unchanged."""
    return _ReduceFrom.apply(y, mesh, axis)


def gather_from(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in coordinate order;
    the backward keeps this rank's slice of the (replicated) gradient."""
    return _GatherFrom.apply(x, mesh, axis, dim % x.ndim)
