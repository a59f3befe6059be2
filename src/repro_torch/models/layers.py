"""Shared building blocks: init, norms, half-split RoPE, MLP activations,
embedding lookup."""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F

from repro_torch.distributed import collectives

_PHI_LO = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))  # Φ(-2)
_PHI_HI = 0.5 * (1.0 + math.erf(2.0 / math.sqrt(2.0)))   # Φ(2)


def truncated_normal_init(generator: Optional[torch.Generator],
                          shape: Sequence[int], dtype, device,
                          scale: float = 1.0) -> torch.Tensor:
    """N(0, 1) truncated to [-2, 2] (inverse-CDF sampling), times
    ``scale / sqrt(fan_in)``; fan_in is ``shape[-2]`` (the input dim of a
    possibly layer-stacked weight)."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    u = torch.rand(tuple(shape), generator=generator, dtype=torch.float32,
                   device=device)
    x = torch.special.erfinv((_PHI_LO + (_PHI_HI - _PHI_LO) * u) * 2 - 1)
    x = (x * math.sqrt(2.0)).clamp_(-2.0, 2.0)
    return (x * (scale / math.sqrt(fan_in))).to(dtype)


def norm_init(d: int, norm_type: str, dtype, device,
              lead: Sequence[int] = ()) -> Dict[str, torch.Tensor]:
    p = {"scale": torch.ones(tuple(lead) + (d,), dtype=dtype, device=device)}
    if norm_type == "layernorm":
        p["bias"] = torch.zeros(tuple(lead) + (d,), dtype=dtype,
                                device=device)
    return p


def apply_norm(params: Dict[str, torch.Tensor], x: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm, or LayerNorm when the params carry a bias; fp32 math."""
    x32 = x.float()
    if "bias" in params:
        mu = x32.mean(-1, keepdim=True)
        var = (x32 - mu).square().mean(-1, keepdim=True)
        y = (x32 - mu) * torch.rsqrt(var + eps)
        y = y * params["scale"].float() + params["bias"].float()
    else:
        ms = x32.square().mean(-1, keepdim=True)
        y = x32 * torch.rsqrt(ms + eps) * params["scale"].float()
    return y.to(x.dtype)


def rope_frequencies(head_dim: int, theta: float,
                     device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Half-split RoPE.  x (..., S, H, hd); positions broadcastable to
    (..., S)."""
    hd = x.shape[-1]
    freqs = rope_frequencies(hd, theta, x.device)
    angles = positions[..., :, None, None].float() * freqs
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def mlp_activation(kind: str):
    if kind == "swiglu":
        return F.silu
    if kind == "gelu":
        return lambda x: F.gelu(x, approximate="tanh")
    if kind == "relu2":
        return lambda x: torch.square(F.relu(x))
    raise ValueError(kind)


def embed_lookup(params: Dict[str, torch.Tensor], tokens: torch.Tensor,
                 compute_dtype, split=None) -> torch.Tensor:
    """Rows of ``params["w"]`` (V, D) at ``tokens``.  ``split``, a
    vocab-parallel lookup, is ``(first id, mesh, axis)``: ``params["w"]``
    holds this rank's rows from that id on; the ids outside them are
    masked, looked up at row 0 and zeroed, and the ranks' rows are summed
    over ``axis`` (every id lies on exactly one rank)."""
    if split is None:
        return params["w"][tokens.long()].to(compute_dtype)
    start, mesh, axis = split
    w = params["w"]
    local = tokens.long() - start
    ours = (local >= 0) & (local < w.shape[0])
    rows = w[torch.where(ours, local, torch.zeros_like(local))]
    rows = torch.where(ours[..., None], rows, torch.zeros_like(rows))
    return collectives.reduce_from(rows.to(compute_dtype), mesh, axis)
