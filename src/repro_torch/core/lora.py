"""LoRA, the low-rank baseline (init, apply, merge)."""
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
