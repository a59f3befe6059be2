"""Plain PyTorch versions of the three kernels on the serving path.

Each computes exactly what its CUDA kernel computes (fp32 accumulation,
the same masking) with ordinary tensor ops.  They serve CPU tensors inside
the wrappers of :mod:`repro_torch.kernels.ops`, the CPU tests hold them
against the reference package, and ``chip_smoke.py`` holds each kernel
against its plain version on the card.  Nothing on the main path calls them
when the tensors live on a GPU.

Unlike the reference package's gather-based oracles, the attention versions
guard the exponent the way the kernels do: a fully masked row outputs exact
zeros (a decode row of length 0) instead of a uniform average.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def _scale(d: int) -> float:
    return 1.0 / math.sqrt(d)


def _masked_softmax_weights(scores: torch.Tensor,
                            valid: torch.Tensor) -> torch.Tensor:
    """exp(s - max) over valid entries, exact 0 elsewhere; not normalized."""
    s = torch.where(valid, scores, torch.full_like(scores, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    return torch.where(valid, torch.exp(s - m), torch.zeros_like(s))


def gather_delta_matmul(ids: torch.Tensor, x: torch.Tensor, w: torch.Tensor,
                        left: torch.Tensor, right: torch.Tensor,
                        out_dtype: Optional[torch.dtype] = None
                        ) -> torch.Tensor:
    """y[b] = x[b] @ W + (x[b] @ left[ids[b]]) @ right[ids[b]], fp32.

    ids (B,); x (B, K); w (K, N); left (A, K, r); right (A, r, N)."""
    out_dtype = out_dtype or x.dtype
    ids = ids.long()
    x32 = x.float()
    y = x32 @ w.float()
    u = torch.einsum("bk,bkr->br", x32, left[ids].float())
    y = y + torch.einsum("br,brn->bn", u, right[ids].float())
    return y.to(out_dtype)


def paged_decode_attention(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, page_table: torch.Tensor,
                           lengths: torch.Tensor,
                           out_dtype: Optional[torch.dtype] = None
                           ) -> torch.Tensor:
    """One-token GQA over a block-paged KV cache, fp32.

    q (B, H, D); pools (P, pg, KH, D); page_table (B, maxp) page ids in
    position order; lengths (B,) valid tokens per row (0 -> zeros)."""
    out_dtype = out_dtype or q.dtype
    b, h, d = q.shape
    pg, kh = k_pool.shape[1], k_pool.shape[2]
    maxp = page_table.shape[1]
    flat = page_table.reshape(-1).long()
    kg = k_pool[flat].reshape(b, maxp * pg, kh, d).float()
    vg = v_pool[flat].reshape(b, maxp * pg, kh, d).float()
    qg = q.reshape(b, kh, h // kh, d).float()
    scores = torch.einsum("bkgd,bskd->bkgs", qg, kg) * _scale(d)
    pos = torch.arange(maxp * pg, device=q.device)
    valid = (pos[None, :] < lengths.reshape(-1, 1).long())[:, None, None, :]
    p = _masked_softmax_weights(scores, valid)
    out = torch.einsum("bkgs,bskd->bkgd", p, vg)
    out = out / p.sum(-1, keepdim=True).clamp_min(1e-30)
    return out.reshape(b, h, d).to(out_dtype)


def paged_prefill_attention(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, k_pool: torch.Tensor,
                            v_pool: torch.Tensor, page_table: torch.Tensor,
                            prefix_len: torch.Tensor,
                            out_dtype: Optional[torch.dtype] = None
                            ) -> torch.Tensor:
    """Suffix prefill over a block-paged prefix plus the causal suffix, fp32.

    q (B, S, H, D); k/v (B, S, KH, D); pools (P, pg, KH, D); page_table
    (B, maxp >= 1) prefix page ids; prefix_len (B,) valid prefix tokens, any
    alignment."""
    out_dtype = out_dtype or q.dtype
    b, s, h, d = q.shape
    pg, kh = k_pool.shape[1], k_pool.shape[2]
    maxp = page_table.shape[1]
    flat = page_table.reshape(-1).long()
    kp = k_pool[flat].reshape(b, maxp * pg, kh, d)
    vp = v_pool[flat].reshape(b, maxp * pg, kh, d)
    qg = q.reshape(b, s, kh, h // kh, d).float()
    kc = torch.cat([kp, k], dim=1).float()
    vc = torch.cat([vp, v], dim=1).float()
    scores = torch.einsum("bskgd,btkd->bskgt", qg, kc) * _scale(d)
    spre = maxp * pg
    dev = q.device
    pre_ok = (torch.arange(spre, device=dev)[None, None, :]
              < prefix_len.reshape(-1, 1, 1).long()).expand(b, s, spre)
    ar = torch.arange(s, device=dev)
    suf_ok = (ar[:, None] >= ar[None, :])[None].expand(b, s, s)
    ok = torch.cat([pre_ok, suf_ok], dim=-1)[:, :, None, None, :]
    p = _masked_softmax_weights(scores, ok)
    out = torch.einsum("bskgt,btkd->bskgd", p, vc)
    out = out / p.sum(-1, keepdim=True).clamp_min(1e-30)
    return out.reshape(b, s, h, d).to(out_dtype)
