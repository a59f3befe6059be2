"""LoRA-family baselines the paper compares against: LoRA, PiSSA, DoRA,
LoRA-XS (init, apply, merge, trainable-parameter counts).

Everything broadcasts over leading (layer-stack) dims; the SVD inits take
one batched fp32 ``torch.linalg.svd`` per stack, on the weight's device.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch

Params = Dict[str, torch.Tensor]


def lora_init(generator: Optional[torch.Generator], w_pre: torch.Tensor,
              rank: int, param_dtype=torch.bfloat16,
              peft_dtype=torch.float32) -> Params:
    """``a`` Kaiming-normal from ``generator``, ``b`` zero (the update starts
    at exactly zero)."""
    d_in, d_out = w_pre.shape[-2:]
    lead = w_pre.shape[:-2]
    r = min(rank, min(d_in, d_out))
    a = torch.randn(lead + (d_in, r), generator=generator,
                    dtype=torch.float32, device=w_pre.device)
    return {
        "w": w_pre.to(param_dtype),
        "a": (a * math.sqrt(2.0 / d_in)).to(peft_dtype),
        "b": torch.zeros(lead + (r, d_out), dtype=peft_dtype,
                         device=w_pre.device),
    }


def lora_apply(params: Params, x: torch.Tensor, scale: float,
               compute_dtype=torch.bfloat16) -> torch.Tensor:
    x = x.to(compute_dtype)
    y = x @ params["w"].to(compute_dtype)
    u = x @ params["a"].to(compute_dtype)
    return y + (u @ params["b"].to(compute_dtype)) * torch.tensor(
        scale, dtype=compute_dtype)


def lora_merge(params: Params, scale: float) -> torch.Tensor:
    w = params["w"].float()
    w = w + scale * params["a"].float() @ params["b"].float()
    return w.to(params["w"].dtype)


def lora_num_params(d_in: int, d_out: int, r: int) -> int:
    return d_in * r + r * d_out


def _svd(w_pre: torch.Tensor, rank: int):
    """(r, U, S, Vh) of the fp32 thin SVD of ``w_pre`` (..., d_in, d_out),
    r = min(rank, d_in, d_out)."""
    d_in, d_out = w_pre.shape[-2:]
    u, s, vh = torch.linalg.svd(w_pre.float(), full_matrices=False)
    return min(rank, min(d_in, d_out)), u, s, vh


# -------------------------------------------------------------------- PiSSA

def pissa_init(w_pre: torch.Tensor, rank: int, param_dtype=torch.bfloat16,
               peft_dtype=torch.float32) -> Params:
    """LoRA with principal-SVD init (Meng et al., 2024): a = U sqrt(S) and
    b = sqrt(S) V^T train; the frozen base holds only the residual."""
    r, u, s, vh = _svd(w_pre, rank)
    sq = s[..., :r].sqrt()
    a = u[..., :, :r] * sq[..., None, :]
    b = sq[..., :, None] * vh[..., :r, :]
    return {
        "w": (w_pre.float() - a @ b).to(param_dtype),
        "a": a.to(peft_dtype),
        "b": b.to(peft_dtype),
    }


# --------------------------------------------------------------------- DoRA

def dora_init(generator: Optional[torch.Generator], w_pre: torch.Tensor,
              rank: int, param_dtype=torch.bfloat16,
              peft_dtype=torch.float32) -> Params:
    p = lora_init(generator, w_pre, rank, param_dtype, peft_dtype)
    p["m"] = torch.linalg.vector_norm(w_pre.float(), dim=-2).to(
        peft_dtype)                                      # column norms
    return p


def _dora_weight(params: Params, scale: float):
    """(W', m / ||W'||_col) with W' = W + s a b, fp32."""
    wp = params["w"].float() + scale * params["a"].float() @ \
        params["b"].float()
    norm = torch.linalg.vector_norm(wp, dim=-2) + 1e-6
    return wp, params["m"].float() / norm


def dora_apply(params: Params, x: torch.Tensor, scale: float,
               compute_dtype=torch.bfloat16) -> torch.Tensor:
    """y = x @ (m . W'/||W'||_col), W' = W + s a b (weight-decomposed)."""
    wp, g = _dora_weight(params, scale)
    y = x.to(compute_dtype) @ wp.to(compute_dtype)
    return y * g.to(compute_dtype).unsqueeze(-2)


def dora_merge(params: Params, scale: float) -> torch.Tensor:
    wp, g = _dora_weight(params, scale)
    return (wp * g.unsqueeze(-2)).to(params["w"].dtype)


def dora_num_params(d_in: int, d_out: int, r: int) -> int:
    return d_in * r + r * d_out + d_out


# ------------------------------------------------------------------ LoRA-XS

def lora_xs_init(w_pre: torch.Tensor, rank: int, param_dtype=torch.bfloat16,
                 peft_dtype=torch.float32) -> Params:
    """Frozen SVD factors, trainable square core s (Balazy et al., 2024)."""
    r, u, s, vh = _svd(w_pre, rank)
    lead = tuple(w_pre.shape[:-2])
    return {
        "w": w_pre.to(param_dtype),
        "a": u[..., :, :r].to(param_dtype),                     # frozen
        "b": (s[..., :r, None] * vh[..., :r, :]).to(param_dtype),  # frozen
        "s": torch.zeros(lead + (r, r), dtype=peft_dtype,
                         device=w_pre.device),               # trainable core
    }


def lora_xs_apply(params: Params, x: torch.Tensor,
                  compute_dtype=torch.bfloat16) -> torch.Tensor:
    x = x.to(compute_dtype)
    y = x @ params["w"].to(compute_dtype)
    u = x @ params["a"].to(compute_dtype)
    return y + (u @ params["s"].to(compute_dtype)) @ params["b"].to(
        compute_dtype)


def lora_xs_merge(params: Params) -> torch.Tensor:
    w = params["w"].float() + params["a"].float() @ params["s"].float() @ \
        params["b"].float()
    return w.to(params["w"].dtype)


def lora_xs_num_params(r: int) -> int:
    return r * r
