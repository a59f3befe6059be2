"""GQA attention: the chunked online-softmax prefill path, block-paged KV
writes and gathers, and the paged prefill / decode paths.

The paged prefill (with an aliased prefix) and paged decode go through the
wrappers of :mod:`repro_torch.kernels.ops`: the hand-written kernels on a
GPU, their plain versions on the CPU.  A decode over a dense per-slot
buffer (:func:`dense_decode_attention`) is the reference's plain
:func:`decode_attention` on the CPU and, on the card, the paged-decode
kernel over the buffer viewed as pages through an identity table: an
encoder-decoder's self cache, and its cross K/V, whose buffers the model
pads to a multiple of 16 rows so that they view as whole pages of 16.  ``chunked_attention`` mirrors the
reference's masked online softmax in fp32 (no fused library attention), so
a prefill with no aliased prefix matches the reference path.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import ops

NEG_INF = -1e30


def _scale(d: int) -> float:
    # f32(1 / sqrt(f32(d))), the reference's scale
    return float(np.float32(1.0) / np.sqrt(np.float32(d)))


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      causal: bool = True, q_chunk: int = 1024,
                      kv_chunk: int = 1024, q_offset: int = 0
                      ) -> torch.Tensor:
    """Online-softmax attention.  q (B, Sq, H, D); k, v (B, Skv, KH, D)."""
    b, sq, h, d = q.shape
    skv, kh = k.shape[1], k.shape[2]
    g = h // kh
    q_chunk = min(q_chunk, sq)
    kv_chunk = min(kv_chunk, skv)
    if sq % q_chunk or skv % kv_chunk:
        raise ValueError(f"lengths {sq}/{skv} not divisible by chunks "
                         f"{q_chunk}/{kv_chunk}")
    nq, nk = sq // q_chunk, skv // kv_chunk
    scale = _scale(d)
    qg = q.reshape(b, nq, q_chunk, kh, g, d).float()
    kg = k.reshape(b, nk, kv_chunk, kh, d).float()
    vg = v.reshape(b, nk, kv_chunk, kh, d).float()
    dev = q.device
    outs = []
    for qi in range(nq):
        acc = torch.zeros((b, q_chunk, kh, g, d), dtype=torch.float32,
                          device=dev)
        m = torch.full((b, q_chunk, kh, g), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((b, q_chunk, kh, g), dtype=torch.float32, device=dev)
        for ki in range(nk):
            s = torch.einsum("bqhgd,bkhd->bqhgk", qg[:, qi], kg[:, ki]) * scale
            if causal:
                qpos = q_offset + qi * q_chunk + torch.arange(q_chunk,
                                                              device=dev)
                kpos = ki * kv_chunk + torch.arange(kv_chunk, device=dev)
                mask = (qpos[:, None] >= kpos[None, :])[None, :, None, None]
                s = torch.where(mask, s, torch.full_like(s, NEG_INF))
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bqhgk,bkhd->bqhgd", p, vg[:, ki])
            m = m_new
        outs.append(acc / l.clamp_min(1e-30)[..., None])
    out = torch.stack(outs, dim=1).reshape(b, sq, h, d)
    return out.to(q.dtype)


def local_kv_heads(k: torch.Tensor, v: torch.Tensor, first: int,
                   heads: int, group: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kv heads (B, S, KH', D) that q heads ``first .. first + heads``
    (global indices) attend to, from all the kv heads (B, S, KH, D), ``group``
    q heads a kv head: under a split over heads whose kv heads stay whole,
    :func:`chunked_attention` of the local q heads over these groups them
    as the whole attention does.  Whole groups are sliced (views); q heads
    inside one group share its head; otherwise each q head gets its own."""
    kv_of = [(first + i) // group for i in range(heads)]
    if heads % group == 0:
        lo, n = kv_of[0], heads // group
        return k[:, :, lo:lo + n], v[:, :, lo:lo + n]
    if kv_of[0] == kv_of[-1]:
        return k[:, :, kv_of[0]:kv_of[0] + 1], v[:, :, kv_of[0]:kv_of[0] + 1]
    idx = torch.tensor(kv_of, device=k.device)
    return k.index_select(2, idx), v.index_select(2, idx)


def paged_gather(pool: torch.Tensor, page_table: torch.Tensor
                 ) -> torch.Tensor:
    """Contiguous per-row view (B, maxp*pg, KH, D) of a paged pool."""
    b, maxp = page_table.shape
    g = pool[page_table.reshape(-1).long()]
    return g.reshape(b, maxp * pool.shape[1], *pool.shape[2:])


def paged_write(pool: torch.Tensor, vals: torch.Tensor,
                page_table: torch.Tensor, positions: torch.Tensor,
                valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Scatter per-token KV into ``pool`` IN PLACE through the page table.

    pool (P, pg, KH, D); vals (B, S, KH, D); positions (B, S); valid
    optional (B, S) — invalid writes go to the trash page 0.  The in-place
    ``index_put_`` stands in for the reference's functional update with
    buffer donation: the pool is never copied.  Returns ``pool``."""
    pg = pool.shape[1]
    maxp = page_table.shape[1]
    pos = positions.long().clamp(max=maxp * pg - 1)
    page = torch.gather(page_table.long(), 1, pos // pg)
    if valid is not None:
        page = torch.where(valid, page, torch.zeros_like(page))
    off = pos % pg
    pool.index_put_((page.reshape(-1), off.reshape(-1)),
                    vals.reshape(-1, *vals.shape[2:]).to(pool.dtype))
    return pool


def paged_prefill_attention(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, k_pref: torch.Tensor,
                            v_pref: torch.Tensor, prefix_len: torch.Tensor
                            ) -> torch.Tensor:
    """Reference suffix prefill over GATHERED prefix pages: materializes the
    (S x (Spre + S)) score tile, fp32.  q/k/v (B, S, H|KH, D); k_pref/v_pref
    (B, Spre, KH, D); prefix_len (B,), any alignment."""
    b, s, h, d = q.shape
    kh = k.shape[2]
    g = h // kh
    spre = k_pref.shape[1]
    dev = q.device
    qg = q.reshape(b, s, kh, g, d).float()
    scale = _scale(d)
    sp = torch.einsum("bskgd,bpkd->bskgp", qg, k_pref.float()) * scale
    pref_ok = torch.arange(spre, device=dev)[None, :] < \
        prefix_len.long()[:, None]
    sp = torch.where(pref_ok[:, None, None, None, :], sp,
                     torch.full_like(sp, NEG_INF))
    ss = torch.einsum("bskgd,btkd->bskgt", qg, k.float()) * scale
    ar = torch.arange(s, device=dev)
    causal = ar[:, None] >= ar[None, :]
    ss = torch.where(causal[None, :, None, None, :], ss,
                     torch.full_like(ss, NEG_INF))
    p = torch.softmax(torch.cat([sp, ss], dim=-1), dim=-1)
    vcat = torch.cat([v_pref, v], dim=1).float()
    out = torch.einsum("bskgt,btkd->bskgd", p, vcat)
    return out.reshape(b, s, h, d).to(q.dtype)


def paged_prefix_prefill_attention(q: torch.Tensor, k: torch.Tensor,
                                   v: torch.Tensor, k_pool: torch.Tensor,
                                   v_pool: torch.Tensor,
                                   prefix_table: torch.Tensor,
                                   prefix_len: torch.Tensor) -> torch.Tensor:
    """Suffix prefill reading the paged pools directly (the prefix-prefill
    kernel on a GPU): q (B, S, H, D); k/v (B, S, KH, D) post-RoPE; pools
    (P, pg, KH, D); prefix_table (B, maxp); prefix_len (B,)."""
    prefix_len = torch.as_tensor(prefix_len, device=q.device).expand(
        q.shape[0])
    return ops.paged_prefill_attention(q.contiguous(), k.contiguous(),
                                       v.contiguous(), k_pool, v_pool,
                                       prefix_table, prefix_len)


def paged_decode_attention(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, page_table: torch.Tensor,
                           lengths: torch.Tensor, lse: bool = False):
    """One-token attention over paged pools (the paged-decode kernel on a
    GPU).  q (B, 1, H, D); lengths () or (B,).  With ``lse`` also each
    row's and head's fp32 log-sum-exp of its scores (B, H)."""
    lengths = torch.as_tensor(lengths, device=q.device).expand(q.shape[0])
    got = ops.paged_decode_attention(q[:, 0].contiguous(), k_pool, v_pool,
                                     page_table, lengths, lse=lse)
    if lse:
        return got[0][:, None], got[1]
    return got[:, None]


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len) -> torch.Tensor:
    """Reference one-token attention over a contiguous cache.
    q (B, 1, H, D); caches (B, S, KH, D); cache_len () or (B,)."""
    b, _, h, d = q.shape
    s, kh = k_cache.shape[1], k_cache.shape[2]
    qg = q.reshape(b, kh, h // kh, d).float()
    scores = torch.einsum("bhgd,bshd->bhgs", qg, k_cache.float()) * _scale(d)
    cache_len = torch.as_tensor(cache_len, device=q.device).reshape(-1, 1)
    valid = torch.arange(s, device=q.device)[None, :] < cache_len
    scores = torch.where(valid[:, None, None, :], scores,
                         torch.full_like(scores, NEG_INF))
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgs,bshd->bhgd", p, v_cache.float())
    return out.reshape(b, 1, h, d).to(q.dtype)


def dense_page_size(max_len: int) -> int:
    """Page size of a dense cache's paged view: the largest power of two
    <= 16 that divides ``max_len``."""
    pg = 16
    while max_len % pg:
        pg //= 2
    return pg


def dense_view_table(batch: int, max_len: int, device) -> torch.Tensor:
    """The identity page table of a dense ``(batch, max_len, KH, D)``
    buffer viewed as pages of :func:`dense_page_size` rows: row b lists
    pages ``b * max_len / pg + j``."""
    per = max_len // dense_page_size(max_len)
    return torch.arange(batch * per, dtype=torch.int32,
                        device=device).reshape(batch, per)


def dense_decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor, lengths: torch.Tensor,
                           view_table: Optional[torch.Tensor],
                           lse: bool = False):
    """One-token attention over dense per-slot buffers (B, S, KH, D) up to
    ``lengths`` (B,).  On the CPU the plain :func:`decode_attention`; on
    the card the paged-decode kernel over the contiguous buffers viewed
    (no copy) as ``(B * S / pg, pg, KH, D)`` pages through ``view_table``
    (:func:`dense_view_table`).  With ``lse`` (a decode over a slice of
    the sequence) it returns (out, each row's and head's fp32
    log-sum-exp (B, H)) from the paged-decode wrapper over that view on
    either device (its plain version on the CPU, which builds the table
    when it is None)."""
    if not q.is_cuda and not lse:
        return decode_attention(q, k_cache, v_cache, lengths)
    b, s, kh, d = k_cache.shape
    if view_table is None and not q.is_cuda:
        view_table = dense_view_table(b, s, q.device)
    pg = s // view_table.shape[1]
    if tuple(view_table.shape) != (b, s // pg) or s % pg \
            or not (k_cache.is_contiguous() and v_cache.is_contiguous()):
        raise ValueError(f"dense view: buffers {tuple(k_cache.shape)} "
                         f"(contiguous: {k_cache.is_contiguous()}, "
                         f"{v_cache.is_contiguous()}), table "
                         f"{tuple(view_table.shape)}")
    pages = (b * (s // pg), pg, kh, d)
    return paged_decode_attention(q, k_cache.view(pages),
                                  v_cache.view(pages), view_table, lengths,
                                  lse)
