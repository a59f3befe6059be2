"""GPipe-style pipeline parallelism over a mesh axis, on
``torch.distributed`` point-to-point ops.

Layers are grouped into S stages; the rank at coordinate ``i`` of the
``stage`` axis holds stage ``i``'s parameters.  Microbatches stream through
the classic (n_micro + S - 1)-tick schedule, the reference's: at every
tick each stage applies its layers to what entered it (stage 0 to a fresh
microbatch), the last stage commits the microbatch that finished, and every
activation hops one stage along the ring ``i -> i + 1 (mod S)`` (the
reference's ``ppermute``; stage 0 ignores what wraps round).  A hop is an
autograd function whose backward sends the gradient the other way round
the ring, so a backward over the pipeline's output runs the schedule in
reverse, every rank in lockstep.

This is the optional ``pod_role="pp"`` path.  PSOFT fine-tuning stays data
parallel across pods by default: its cross-pod gradient traffic is KB-sized.
"""
from __future__ import annotations

from typing import Any, Callable

import torch
import torch.distributed as dist

from repro_torch.distributed import collectives
from repro_torch.sharding import mesh_shape
from repro_torch.tree import tree_map

PyTree = Any


class _Hop(torch.autograd.Function):
    """Send ``x`` to the next stage and receive the previous stage's."""

    @staticmethod
    def forward(ctx, x, group, nxt, prev):
        ctx.route = group, nxt, prev
        return _exchange(x, group, send_to=nxt, recv_from=prev)

    @staticmethod
    def backward(ctx, g):
        group, nxt, prev = ctx.route
        return _exchange(g, group, send_to=prev, recv_from=nxt), None, \
            None, None


def _exchange(x, group, send_to: int, recv_from: int) -> torch.Tensor:
    out = torch.empty_like(x)
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, x.contiguous(), send_to, group),
        dist.P2POp(dist.irecv, out, recv_from, group)])
    for r in reqs:
        r.wait()
    return out


class _LastStage(torch.autograd.Function):
    """Every rank gets the last stage's outputs (a sum over the stage group
    of the last stage's outputs and everyone else's zeros, the reference's
    ``psum``).  Every rank computes one copy of the same downstream loss,
    so the gradient comes back unreduced."""

    @staticmethod
    def forward(ctx, y, mesh, axis):
        return collectives.all_reduce(y.clone(), mesh, (axis,))

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def gpipe_spmd_pipeline(body_fn: Callable, mesh, axis: str = "stage"):
    """Build ``fn(stage_params, x_micro)`` for this rank's stage.

    ``body_fn(params_for_stage, x) -> y`` applies ONE stage to one
    microbatch.  ``stage_params``: this rank's block of a tree stacked on a
    leading stage axis of size S (each leaf ``(1, ...)``, as
    :func:`repro_torch.distributed.collectives.shard` cuts it).
    ``x_micro``: ``(n_micro, mb, ...)``, the same on every rank.

    Returns the pipeline output ``(n_micro, mb, ...)`` on every rank, equal
    to applying the S stages in turn to each microbatch.
    """
    s = mesh_shape(mesh)[axis]
    idx = mesh.get_local_rank(axis)
    group = mesh.get_group(axis)
    # the ring's neighbours, as global ranks (P2POp takes global ranks)
    ranks = dist.get_process_group_ranks(group)
    nxt, prev = ranks[(idx + 1) % s], ranks[(idx - 1) % s]

    def hop(out):
        if s == 1:          # a ring of one stage: the permutation is I
            return out
        return _Hop.apply(out, group, nxt, prev)

    def fn(stage_params: PyTree, x_micro: torch.Tensor) -> torch.Tensor:
        params = tree_map(lambda p: p[0], stage_params)
        n_micro = x_micro.shape[0]
        first = torch.tensor(idx == 0, device=x_micro.device)
        last = torch.tensor(idx == s - 1, device=x_micro.device)
        buf = torch.zeros_like(x_micro[0])
        committed = []
        for t in range(n_micro + s - 1):
            fresh = x_micro[min(t, n_micro - 1)]
            # wheres, not branches, as in the reference: every rank's graph
            # holds every hop and every commit, so every rank's backward
            # takes part in every exchange
            out = body_fn(params, torch.where(first, fresh, buf))
            if t >= s - 1:
                committed.append(out)
            if t < n_micro + s - 2:
                buf = hop(out)
        y = torch.stack(committed)
        y = torch.where(last, y, torch.zeros_like(y))
        return _LastStage.apply(y, mesh, axis)

    return fn
