"""Plain PyTorch versions of the port's kernels: the three on the serving
path, the two on PSOFT's training path (``psoft_matmul``,
``cayley_neumann``) and the OFT family's ``blockdiag_rotate``.

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
                           out_dtype: Optional[torch.dtype] = None,
                           lse: bool = False):
    """One-token GQA over a block-paged KV cache, fp32.

    q (B, H, D); pools (P, pg, KH, D); page_table (B, maxp) page ids in
    position order; lengths (B,) valid tokens per row (0 -> zeros).  With
    ``lse`` also each row's and head's log-sum-exp of its scaled scores
    (B, H) fp32, ``max + log(sum of exps)`` as the kernel's combine
    writes it, -inf for a row of length 0."""
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
    total = p.sum(-1, keepdim=True)
    out = (out / total.clamp_min(1e-30)).reshape(b, h, d).to(out_dtype)
    if not lse:
        return out
    m = torch.where(valid, scores, torch.full_like(scores, NEG_INF)).amax(-1)
    total = total[..., 0]
    return out, torch.where(total > 0, m + torch.log(total),
                            torch.full_like(total, -math.inf)).reshape(b, h)


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


def psoft_matmul_parts(x: torch.Tensor, w_res: torch.Tensor, a: torch.Tensor,
                       rot: torch.Tensor, b: torch.Tensor, s_in: torch.Tensor,
                       s_out: torch.Tensor, transpose: bool = False):
    """The PSOFT linear and its intermediates, as the kernel computes them.

    forward:    u = x A, t = (u . s_in) R, y = x W_res + (t . s_out) B;
    transpose:  x is dy (M, N): u = dy B^T, t = (u . s_in) R^T,
                y = dy W_res^T + (t . s_out) A^T.
    x (M, K|N), W_res (K, N), A (K, r), B (r, N) in the compute dtype; rot
    (r, r), s_in, s_out (r,) fp32.  fp32 accumulation; v = t . s_out is
    rounded to x's dtype before its product, as the kernel rounds it when it
    enters a tile.  Returns (y in x's dtype, u fp32, t fp32).

    Grouped: every argument may carry one leading group axis G (x (G, M,
    K|N), W_res (G, K, N), ..., s_in and s_out (G, r)), and group g is the
    function above on its own slices, as the kernel's grouped launch
    computes it for an MoE layer's expert stack."""
    f32 = torch.float32
    w, p_in, p_out, r_mat = w_res.to(f32), a.to(f32), b.to(f32), rot.to(f32)
    if transpose:
        w, p_in, p_out, r_mat = w.mT, p_out.mT, p_in.mT, r_mat.mT
    x32 = x.to(f32)
    u = x32 @ p_in
    t = (u * s_in.to(f32).unsqueeze(-2)) @ r_mat
    v = (t * s_out.to(f32).unsqueeze(-2)).to(x.dtype).to(f32)
    y = x32 @ w + v @ p_out
    return y.to(x.dtype), u, t


def psoft_matmul(x: torch.Tensor, w_res: torch.Tensor, a: torch.Tensor,
                 rot: torch.Tensor, b: torch.Tensor,
                 alpha: Optional[torch.Tensor] = None,
                 beta: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y = x (W_res + A diag(alpha) R diag(beta) B), fp32 accumulation,
    y in x's dtype: the reference's ``psoft_matmul_ref`` but for one
    rounding.  Where x is bf16, the rank-r operand v = t . beta is rounded
    to bf16 before its product with B, as the kernel rounds it; the
    reference keeps that term in fp32.  In fp32 the two are the same
    function.  A leading group axis on every argument gives the grouped
    function (see :func:`psoft_matmul_parts`)."""
    r = a.shape[-1]
    ones = torch.ones(a.shape[:-2] + (r,), dtype=torch.float32,
                      device=x.device)
    alpha = ones if alpha is None else alpha
    beta = ones if beta is None else beta
    return psoft_matmul_parts(x, w_res, a, rot, b, alpha, beta)[0]


def cayley_neumann_series(q: torch.Tensor, terms: int):
    """R = (I - Q) sum_{k<=K} (-Q)^k by K Horner steps S <- I - Q S, fp32,
    batched over leading dims.  Returns (R, series) with series
    (K, ..., r, r) holding S_1 .. S_K, as the kernel writes them."""
    q = q.to(torch.float32)
    eye = torch.eye(q.shape[-1], dtype=torch.float32, device=q.device)
    s = eye.expand_as(q)
    series = []
    for _ in range(terms):
        s = eye - q @ s
        series.append(s)
    rot = s - q @ s
    stacked = torch.stack(series) if series else q.new_zeros(
        (0,) + tuple(q.shape))
    return rot, stacked


def cayley_neumann(q: torch.Tensor, terms: int) -> torch.Tensor:
    """R = (I - Q) sum_{k<=K} (-Q)^k for dense Q (..., r, r), fp32 (the
    reference's ``cayley_neumann_ref``)."""
    return cayley_neumann_series(q, terms)[0]


def blockdiag_rotate(x: torch.Tensor, rots: torch.Tensor,
                     transpose: bool = False) -> torch.Tensor:
    """y[:, g*b:(g+1)*b] = x[:, g*b:(g+1)*b] @ R_g (R_g^T with
    ``transpose``): x (M, d), rots (d/b, b, b); fp32 einsum, y in x's
    dtype (the reference's ``blockdiag_rotate_ref``)."""
    m, d = x.shape
    nb, bs, _ = rots.shape
    r = rots.float()
    if transpose:
        r = r.transpose(-1, -2)
    y = torch.einsum("mgb,gbc->mgc", x.float().reshape(m, nb, bs), r)
    return y.reshape(m, d).to(x.dtype)
