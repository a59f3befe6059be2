"""Mixture-of-Experts layer of the port: top-k routing with the reference's
two dispatch implementations.

* ``capacity`` (training): GShard's grouped dispatch.  The tokens split
  into G groups, as many as the batch is sharded over (one under no
  sharding rules); within each group a sort-based token -> expert
  dispatch fills a (E, cap_g, D) buffer per group, overflow tokens are
  dropped as GShard/Switch drop them, the expert FFN runs on the (G, E,
  cap_g, D) buffers, and a masked, gate-weighted combine brings the rows
  back.  Under a sharded train step (a live mesh) each rank holds one
  group, its batch rows, and the load-balance statistics are averaged
  over the batch ranks, so the aux loss is the global batch's.
* ``dense`` (serving, logits): every expert on every token and a
  gate-weighted combine; exact, and every row's output independent of its
  batch mates (capacity dispatch couples the rows of a batch through the
  shared buffer, so the engine never serves through it).

Under a compute split over ``model`` whose experts split (expert
parallelism, :mod:`repro_torch.distributed.tensor_parallel`), each rank
runs both dispatches over every token but only its E / n experts' rows,
and sums the partial outputs over ``model``.

Expert linears are stacked ``(E, d_in, d_out)`` per layer (``(L, E, ...)``
in the model's tree) and apply through the PEFT dispatcher with the expert
axis written out as a batch dimension, where the reference vmaps one linear
over it: a PSOFT expert stack is one grouped ``psoft_matmul`` launch set,
a plain one a batched product.  The router is a plain fp32 ``{"w"}`` that
is never PEFT-wrapped and never banked.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.configs.base import ModelConfig
from repro_torch.core import peft as peft_lib
from repro_torch.distributed import collectives
from repro_torch.models import layers
from repro_torch.sharding import (batch_axes, current_rules, mesh_shape,
                                  shard_act)
from repro_torch.tree import stack_filled

Params = Dict[str, torch.Tensor]

#: the expert FFN's linears (an expert stack each)
EXPERT_LINEARS = ("up", "down", "gate")


def apply_linear_stacked(params: Params, x: torch.Tensor, cfg, compute_dtype,
                         module: Optional[str] = None) -> torch.Tensor:
    """One PEFT linear per expert on x (E, C, d_in): expert e's rows through
    linear e (the reference's vmap over the expert axis of params AND x)."""
    return peft_lib.apply_linear(params, x, cfg, compute_dtype, module=module)


def moe_init(generator: Optional[torch.Generator], cfg: ModelConfig,
             param_dtype, peft_dtype, targets, device,
             num_layers: int) -> Dict:
    """The MoE params of ``num_layers`` stacked layers (``(L, E, ...)``
    expert stacks): the fp32 router, the expert stacks (PEFT-wrapped per
    ``targets``) and, with shared experts, a dense MLP of width
    ``num_shared_experts * d_ff``.  Each expert stack is drawn and split one
    layer at a time, so no fp32 copy of a whole stack ever exists."""
    from repro_torch.models.model import _linear_init, mlp_init  # (cycle)
    d, f, e = cfg.d_model, cfg.d_ff, cfg.moe.num_experts

    def expert_stack(d_in, d_out, name):
        return stack_filled(num_layers, lambda _layer: _linear_init(
            generator, cfg, (e, d_in, d_out), name, param_dtype, peft_dtype,
            targets, device))

    p: Dict = {
        "router": {"w": layers.truncated_normal_init(
            generator, (num_layers, d, e), torch.float32, device)},
        "up": expert_stack(d, f, "up"),
        "down": expert_stack(f, d, "down"),
    }
    if cfg.mlp_type == "swiglu":
        p["gate"] = expert_stack(d, f, "gate")
    if cfg.moe.num_shared_experts > 0:
        p["shared"] = mlp_init(generator, cfg, cfg.moe.num_shared_experts * f,
                               param_dtype, peft_dtype, targets, device,
                               (num_layers,))
    return p


def _expert_ffn(p: Dict, x: torch.Tensor, cfg: ModelConfig,
                compute_dtype) -> torch.Tensor:
    """x (E, C, D) -> (E, C, D) through the per-expert (PEFT-wrapped) FFN."""
    act = layers.mlp_activation(cfg.mlp_type)
    up = apply_linear_stacked(p["up"], x, cfg.peft, compute_dtype,
                              module="up")
    if "gate" in p:
        gate = apply_linear_stacked(p["gate"], x, cfg.peft, compute_dtype,
                                    module="gate")
        hidden = act(gate.float()).to(compute_dtype) * up
    else:
        hidden = act(up.float()).to(compute_dtype)
    return apply_linear_stacked(p["down"], hidden, cfg.peft, compute_dtype,
                                module="down")


def top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` over the last axis: values descending, ties broken
    toward the lower index (``torch.topk`` promises no order on ties, and a
    zero router ties every expert): a stable descending sort."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _batch_mesh():
    """(mesh, its batch axes) of the current mesh context, or (None, ())."""
    ctx = current_rules()
    return (None, ()) if ctx is None else (ctx[0], batch_axes(*ctx))


def _group_count(t: int) -> int:
    """Dispatch groups over ``t`` tokens: the batch-sharding extent of the
    mesh context (GShard groups align with data shards, so every sort and
    scatter stays shard-local), lowered until it divides ``t``; one
    outside a context, and one on a live mesh, where this rank's tokens
    are its own group."""
    mesh, axes = _batch_mesh()
    if mesh is None or isinstance(mesh, DeviceMesh):
        return 1
    g = math.prod(mesh_shape(mesh)[a] for a in axes)
    while t % g:
        g -= 1
    return max(g, 1)


def capacity(tokens: int, cfg: ModelConfig) -> int:
    """Per-expert buffer rows of a group of ``tokens`` tokens:
    ``int(T k capacity_factor / E)`` clamped to [4, T]."""
    cap = int(tokens * cfg.moe.top_k * cfg.moe.capacity_factor
              / cfg.moe.num_experts)
    return max(4, min(cap, tokens))


def moe_apply(params: Dict, x: torch.Tensor, cfg: ModelConfig,
              compute_dtype, impl: str = "capacity", tp=None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) -> (y (B, S, D) in the compute dtype, the Switch
    load-balance aux loss).  Under a compute split ``tp`` whose experts
    split (:mod:`repro_torch.distributed.tensor_parallel`), ``params``'
    expert stacks are this rank's E / n experts (``tp.local_experts``):
    the router, the aux loss and the dispatch run on every token as
    without a split, only the rank's experts' rows run through its
    stacks, and the partial outputs are summed over ``model``; the shared
    experts' MLP splits as its plan says."""
    b, s, d = x.shape
    e, k = cfg.moe.num_experts, cfg.moe.top_k
    t = b * s
    xt = x.reshape(t, d)
    split = tp is not None and tp.experts
    first, local = tp.expert_range() if split else (0, e)

    logits = xt.float() @ params["router"]["w"].float()
    probs = torch.softmax(logits, dim=-1)                     # (T, E)
    gates, idx = top_k(probs, k)                              # (T, k)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)

    # load-balance aux (Switch): E * sum_e fraction_e * mean_prob_e
    frac = F.one_hot(idx[:, 0], e).float().mean(0)
    mean_prob = probs.mean(0)
    mesh, axes = _batch_mesh()
    if isinstance(mesh, DeviceMesh):
        # the global batch's statistics (every rank's share is T tokens)
        n = math.prod(mesh_shape(mesh)[a] for a in axes)
        frac = collectives.all_reduce(frac.clone(), mesh, axes) / n
        mean_prob = collectives.sum_over(mean_prob, mesh, axes) / n
    aux = e * (frac * mean_prob).sum()

    xin = xt
    if split:
        # each rank's gradients of the expert path's input and of the
        # combine's gates cover its experts only: summed in the backward
        xin = collectives.copy_to(xt, tp.mesh, "model")
        gates = collectives.copy_to(gates, tp.mesh, "model")
    if impl == "dense":
        # (E, T, D): every (local) expert on every token
        xe = xin[None].expand(local, t, d)
        ye = _expert_ffn(params, xe, cfg, compute_dtype)      # (E, T, D)
        comb = torch.zeros((t, e), dtype=torch.float32,
                           device=x.device).scatter_add(1, idx, gates)
        y = torch.einsum("te,etd->td",
                         comb[:, first:first + local].to(compute_dtype), ye)
    elif impl == "capacity":
        g = _group_count(t)
        tg = t // g
        cap = capacity(tg, cfg)
        xg = shard_act(xin.reshape(g, tg, d), ("batch", None, None))
        flat_e = idx.reshape(g, tg * k)                       # (G, tg k)
        order = torch.argsort(flat_e, dim=1, stable=True)     # jnp.argsort
        sorted_e = torch.gather(flat_e, 1, order)
        start = torch.searchsorted(sorted_e, sorted_e, side="left")
        pos = torch.arange(tg * k, device=x.device) - start
        # kept and (under a split) one of this rank's experts
        keep = (pos < cap) & (sorted_e >= first) & (sorted_e < first + local)
        mine = (sorted_e - first).clamp(0, local - 1)
        group = torch.arange(g, device=x.device)[:, None]
        src_tok = group * tg + order // k                     # global rows
        gathered = xg.reshape(t, d)[src_tok].to(compute_dtype)
        # positions >= cap are dropped (the reference's scatter mode
        # "drop"), and other ranks' experts' rows skipped: they land on one
        # trash row past the buffers
        rows = g * local * cap
        dest = torch.where(keep, (group * local + mine) * cap + pos,
                           torch.full_like(pos, rows))
        buf = torch.zeros((rows + 1, d), dtype=compute_dtype,
                          device=x.device).index_put((dest.reshape(-1),),
                                                     gathered.reshape(-1, d))
        buf = shard_act(buf[:rows].reshape(g, local, cap, d),
                        ("batch", "expert", None, None))
        # every group's rows of an expert through one linear: each expert
        # stack stays one grouped launch whatever G
        out = _expert_ffn(params, buf.transpose(0, 1).reshape(
            local, g * cap, d), cfg, compute_dtype)
        out = shard_act(out.reshape(local, g, cap, d).transpose(0, 1),
                        ("batch", "expert", None, None))      # (G,E,cap,D)
        got = out[group, mine, pos.clamp_max(cap - 1)]        # (G, tg k, D)
        got = torch.where(keep[..., None], got, torch.zeros_like(got))
        gflat = torch.gather(gates.reshape(g, tg * k), 1,
                             order).to(compute_dtype)
        y = torch.zeros((t, d), dtype=compute_dtype,
                        device=x.device).index_add(
            0, src_tok.reshape(-1), (got * gflat[..., None]).reshape(-1, d))
        y = shard_act(y.reshape(g, tg, d), ("batch", None, None)
                      ).reshape(t, d)
    else:
        raise ValueError(f"moe impl {impl!r}: 'capacity' or 'dense'")

    if split:
        y = collectives.reduce_from(y, tp.mesh, "model")
    y = y.reshape(b, s, d).to(compute_dtype)
    if "shared" in params:
        from repro_torch.models.model import mlp_apply  # local import
        y = y + mlp_apply(params["shared"], x.to(compute_dtype), cfg,
                          compute_dtype,
                          tp=None if tp is None else tp.for_shared())
    return y, aux
