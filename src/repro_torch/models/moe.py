"""Mixture-of-Experts layer of the port: top-k routing with the reference's
two dispatch implementations.

* ``capacity`` (training): sort-based token -> expert dispatch into one
  (E, C, D) buffer, overflow tokens dropped as GShard/Switch drop them, the
  expert FFN run on the buffer, and a masked, gate-weighted combine.
* ``dense`` (serving, logits): every expert on every token and a
  gate-weighted combine; exact, and every row's output independent of its
  batch mates (capacity dispatch couples the rows of a batch through the
  shared buffer, so the engine never serves through it).

Expert linears are stacked ``(E, d_in, d_out)`` per layer (``(L, E, ...)``
in the model's tree) and apply through the PEFT dispatcher with the expert
axis written out as a batch dimension, where the reference vmaps one linear
over it: a PSOFT expert stack is one grouped ``psoft_matmul`` launch set,
a plain one a batched product.  The router is a plain fp32 ``{"w"}`` that
is never PEFT-wrapped and never banked.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core import peft as peft_lib
from repro_torch.models import layers
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


def capacity(tokens: int, cfg: ModelConfig) -> int:
    """Per-expert buffer rows: ``int(T k capacity_factor / E)`` clamped to
    [4, T]."""
    cap = int(tokens * cfg.moe.top_k * cfg.moe.capacity_factor
              / cfg.moe.num_experts)
    return max(4, min(cap, tokens))


def moe_apply(params: Dict, x: torch.Tensor, cfg: ModelConfig,
              compute_dtype, impl: str = "capacity"
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) -> (y (B, S, D) in the compute dtype, the Switch
    load-balance aux loss)."""
    b, s, d = x.shape
    e, k = cfg.moe.num_experts, cfg.moe.top_k
    t = b * s
    xt = x.reshape(t, d)

    logits = xt.float() @ params["router"]["w"].float()
    probs = torch.softmax(logits, dim=-1)                     # (T, E)
    gates, idx = top_k(probs, k)                              # (T, k)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)

    # load-balance aux (Switch): E * sum_e fraction_e * mean_prob_e
    frac = F.one_hot(idx[:, 0], e).float().mean(0)
    aux = e * (frac * probs.mean(0)).sum()

    if impl == "dense":
        # (E, T, D): every expert on every token
        xe = xt[None].expand(e, t, d)
        ye = _expert_ffn(params, xe, cfg, compute_dtype)      # (E, T, D)
        comb = torch.zeros((t, e), dtype=torch.float32,
                           device=x.device).scatter_add(1, idx, gates)
        y = torch.einsum("te,etd->td", comb.to(compute_dtype), ye)
    elif impl == "capacity":
        # One dispatch group: the reference splits the tokens into as many
        # groups as the batch is sharded over (GShard), and the port runs
        # on one card with no sharding rules, where that count is 1.  The
        # grouped (G, E, cap, D) form belongs with sharding.
        cap = capacity(t, cfg)
        flat_e = idx.reshape(-1)                              # (T k,)
        order = torch.argsort(flat_e, stable=True)            # jnp.argsort
        sorted_e = flat_e[order]
        first = torch.searchsorted(sorted_e, sorted_e, side="left")
        pos = torch.arange(t * k, device=x.device) - first
        src_tok = order // k
        keep = pos < cap
        gathered = xt[src_tok].to(compute_dtype)
        # positions >= cap are dropped (the reference's scatter mode
        # "drop"): they land on one trash row past the buffer
        dest = torch.where(keep, sorted_e * cap + pos,
                           torch.full_like(pos, e * cap))
        buf = torch.zeros((e * cap + 1, d), dtype=compute_dtype,
                          device=x.device).index_put((dest,), gathered)
        buf = buf[:e * cap].reshape(e, cap, d)
        out = _expert_ffn(params, buf, cfg, compute_dtype)    # (E, cap, D)
        got = out[sorted_e, pos.clamp_max(cap - 1)]
        got = torch.where(keep[:, None], got, torch.zeros_like(got))
        gflat = gates.reshape(-1)[order].to(compute_dtype)
        y = torch.zeros((t, d), dtype=compute_dtype,
                        device=x.device).index_add(0, src_tok,
                                                   got * gflat[:, None])
    else:
        raise ValueError(f"moe impl {impl!r}: 'capacity' or 'dense'")

    y = y.reshape(b, s, d).to(compute_dtype)
    if "shared" in params:
        from repro_torch.models.model import mlp_apply  # local import
        y = y + mlp_apply(params["shared"], x.to(compute_dtype), cfg,
                          compute_dtype)
    return y, aux
