"""Decoder of the port, dense, MoE, SSM (Mamba2), hybrid (Mamba2 with one
shared attention block), VLM (patch embeddings in front of the tokens) and
audio encoder-decoder: init, the training forward and loss, paged and
dense-cache prefill and decode, and the PEFT trainability mask.

Params are nested dicts of tensors in the reference's layout: the dense,
MoE and SSM families scan-stack every per-layer leaf on a leading
``(L, ...)`` axis; the hybrid keeps a Python list of per-layer dicts (an
attention position holds only a 0-d ``"marker"``) beside ``"shared_attn"``.
A reference tree converts 1:1 (:mod:`repro_torch.interop`).  A Python loop
over the layers takes the place of ``lax.scan``.  Banked serve linears take the
engine's per-row ``adapter_ids``, threaded explicitly through every call.
The training forward builds every PSOFT, OFT and BOFT layer stack's
rotations once per call (one ``cayley_neumann`` launch per stack), outside
the per-layer recompute boundary, so remat does not build them twice.
An MoE block holds ``"moe"`` (:mod:`repro_torch.models.moe`) where a dense
one holds ``"mlp"``; ``moe_impl`` picks its dispatch with the reference's
defaults: capacity in training and :func:`prefill`, every expert on every
token in :func:`decode_step`, the paged paths and logits (the engine
passes "dense" to all of them).

The VLM's stub frontend hands in ``patch_embeds`` (B, P, d_model), put in
front of the token embeddings: positions run over the patches, then the
text, and the loss pads the labels with -1 over the patches.  The audio
encoder-decoder's stub frontend hands in ``src_embeds`` (B, S_src,
d_model): a non-causal encoder (``"enc_layers"``, ``"enc_final_norm"``)
feeds every decoder block's cross-attention (``"ln_cross"``, ``"cross"``
{q, k, v, o}; no RoPE, K/V from the encoder output).  Its cache is
``{"self": the dense decoder cache, "cross": {"k", "v", "len"}}``, the
cross K/V built once per prefill and padded to a multiple of
:data:`CROSS_PAD` rows (read only up to ``len``), so that the card's decode
views it as full pages of 16.

The dense cache (:func:`init_cache` without a page size) is the SSM and
hybrid families' cache, and a baseline for the attention families: per
layer a ``(B, max_len, KH, hd)`` K/V buffer, or the Mamba2 conv and SSD
states.  Recurrent families prefill at the exact prompt length (pad tokens
would enter the states).  On the card a dense decode attends through the
paged-decode kernel over the buffer viewed as pages
(:func:`repro_torch.models.attention.dense_decode_attention`).
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist
from torch.utils import checkpoint as torch_checkpoint

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig, torch_dtype
from repro_torch.core import peft as peft_lib
from repro_torch.core import registry
from repro_torch.distributed import collectives, tensor_parallel
from repro_torch.kernels import ops
from repro_torch.models import attention, layers
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.sharding import shard_act
from repro_torch.tree import map_dicts, tree_leaves, tree_map_with_path

Params = Dict[str, Any]

_MLP = ("up", "down", "gate")
_ATTN = ("q", "k", "v", "o")
#: logical module names a param path of the decoder can name, the
#: reference's set (the router names a module but is never PEFT-wrapped:
#: ``moe_apply`` reads its weight directly)
_MODULE_NAMES = frozenset(_ATTN + _MLP + ("router", "in_proj", "out_proj",
                                          "fuse"))
#: families the port builds
FAMILIES = ("dense", "moe", "vlm", "audio", "ssm", "hybrid")
#: families whose layers are the stacked attention block
_ATTENTION_FAMILIES = ("dense", "moe", "vlm", "audio")
#: families with a block-paged KV cache (an encoder-decoder's cross cache
#: and the recurrent states stay dense)
PAGED_FAMILIES = ("dense", "moe", "vlm")
#: rows the cross K/V buffers are padded to a multiple of
CROSS_PAD = 16


def _layer(tree, i: int):
    """Layer ``i`` of a scan-stacked subtree (views, no copies)."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _linear_init(generator, cfg: ModelConfig, shape, name, param_dtype,
                 peft_dtype, targets, device) -> Params:
    """One linear stack of ``shape`` (lead..., d_in, d_out) drawn in fp32
    and PEFT-wrapped when ``name`` is a target."""
    w = layers.truncated_normal_init(generator, shape, torch.float32, device)
    return peft_lib.init_linear(generator, w, cfg.peft, name in targets,
                                param_dtype, peft_dtype, module=name)


def mlp_init(generator, cfg: ModelConfig, d_ff: int, param_dtype,
             peft_dtype, targets, device, lead: Tuple[int, ...] = ()
             ) -> Params:
    """A (gated) MLP of width ``d_ff`` for ``lead`` stacked layers."""
    d = cfg.d_model
    shapes = {"up": (d, d_ff), "down": (d_ff, d), "gate": (d, d_ff)}
    names = _MLP if cfg.mlp_type == "swiglu" else _MLP[:2]
    return {n: _linear_init(generator, cfg, tuple(lead) + shapes[n], n,
                            param_dtype, peft_dtype, targets, device)
            for n in names}


def _block_init(gen, cfg: ModelConfig, pdt, edt, targets, dev,
                lead: Tuple[int, ...], cross: bool = False) -> Params:
    """One attention + MLP (or MoE) block, stacked over ``lead`` layers;
    ``cross`` adds a decoder block's ``ln_cross`` and cross-attention (its
    k and v take the encoder's ``d_model`` outputs)."""
    d, f = cfg.d_model, cfg.d_ff
    h, kh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    shapes = {"q": (d, h * hd), "k": (d, kh * hd), "v": (d, kh * hd),
              "o": (h * hd, d)}

    def attn():
        return {n: _linear_init(gen, cfg, lead + shapes[n], n, pdt, edt,
                                targets, dev) for n in _ATTN}
    p: Params = {
        "ln1": layers.norm_init(d, cfg.norm_type, pdt, dev, lead),
        "attn": attn(),
        "ln2": layers.norm_init(d, cfg.norm_type, pdt, dev, lead),
    }
    if cfg.family == "moe":
        p["moe"] = moe_lib.moe_init(gen, cfg, pdt, edt, targets, dev,
                                    lead[0])
    else:
        p["mlp"] = mlp_init(gen, cfg, f, pdt, edt, targets, dev, lead)
    if cross:
        p["ln_cross"] = layers.norm_init(d, cfg.norm_type, pdt, dev, lead)
        p["cross"] = attn()
    return p


def _mamba_layer_init(gen, cfg: ModelConfig, pdt, edt, dev,
                      lead: Tuple[int, ...]) -> Params:
    return {"ssm": ssm_lib.mamba_block_init(
                gen, cfg, pdt, edt, cfg.peft.is_target("in_proj"),
                cfg.peft.is_target("out_proj"), dev, lead),
            "ln": layers.norm_init(cfg.d_model, cfg.norm_type, pdt, dev,
                                   lead)}


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda") -> Params:
    """Random decoder params from ``seed`` (a ``torch.Generator`` on
    ``device``), PEFT-wrapped per ``cfg.peft`` (any registered method); the
    SVD methods (PSOFT, PiSSA, LoRA-XS) split each linear stack by one
    batched fp32 SVD, on ``device``, each MoE expert stack one layer at a
    time, and each of the hybrid's unstacked linears alone.  The hybrid's
    shared block's ``fuse`` is never wrapped, as in the reference.  An
    encoder-decoder adds ``"enc_layers"`` (stacked, no cross-attention) and
    ``"enc_final_norm"``.  On the ``"meta"`` device every leaf is a shape
    and a dtype, and nothing is drawn or computed
    (:func:`abstract_params`)."""
    if cfg.family not in FAMILIES:
        raise ValueError(f"the port builds the {', '.join(FAMILIES)} "
                         f"families only, not {cfg.family!r}")
    dev = resolve_device(device)
    gen = None
    if dev.type != "meta":
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
    pdt, edt = torch_dtype(cfg.param_dtype), torch_dtype(cfg.peft_dtype)
    nl, d = cfg.num_layers, cfg.d_model
    targets = cfg.peft.target_modules
    p: Params = {
        "embed": {"w": layers.truncated_normal_init(
            gen, (cfg.padded_vocab_size, d), pdt, dev)},
        "final_norm": layers.norm_init(d, cfg.norm_type, pdt, dev),
    }
    if cfg.family in _ATTENTION_FAMILIES:
        p["layers"] = _block_init(gen, cfg, pdt, edt, targets, dev, (nl,),
                                  cross=cfg.is_encoder_decoder)
        if cfg.is_encoder_decoder:
            p["enc_layers"] = _block_init(gen, cfg, pdt, edt, targets, dev,
                                          (cfg.num_encoder_layers,))
            p["enc_final_norm"] = layers.norm_init(d, cfg.norm_type, pdt,
                                                   dev)
    elif cfg.family == "ssm":
        p["layers"] = _mamba_layer_init(gen, cfg, pdt, edt, dev, (nl,))
    else:
        p["layers"] = [
            _mamba_layer_init(gen, cfg, pdt, edt, dev, ()) if ch == "M"
            else {"marker": torch.zeros((), dtype=torch.float32, device=dev)}
            for ch in cfg.layer_pattern()]
        p["shared_attn"] = {
            "fuse": _linear_init(gen, cfg, (2 * d, d), "fuse", pdt, edt, (),
                                 dev),
            "block": _block_init(gen, cfg, pdt, edt, targets, dev, ())}
    if not cfg.tie_embeddings:
        p["lm_head"] = {"w": layers.truncated_normal_init(
            gen, (d, cfg.padded_vocab_size), pdt, dev)}
    return p


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               page_size: Optional[int] = None,
               num_pages: Optional[int] = None, device="cuda", tp=None):
    """The decode cache.  With ``page_size``: block-paged KV pools
    ``{"k","v"}: (L, num_pages, page_size, KH, hd)`` in the compute dtype
    (page 0 is the reserved trash page; ``num_pages`` defaults to
    dense-equivalent capacity plus the trash page), for the decoder-only
    attention families (dense, MoE, VLM) only.  Without: the dense cache,
    zeros, layer-stacked for the dense, MoE, VLM and SSM families
    (``{"k","v"}: (L, batch, max_len, KH, hd)``; ``{"conv_state": (L,
    batch, K-1, C), "ssm_state": (L, batch, H, N, P)}`` with the SSD state
    in fp32), ``{"self": those K/V buffers, "cross": None}`` for the audio
    encoder-decoder (the cross K/V come with its prefill) and a per-layer
    list for the hybrid.  Under a serving split ``tp``
    (:mod:`repro_torch.distributed.tensor_parallel`) every K/V buffer is
    this rank's block: KH / n heads (``tp.cache == "kv_heads"``) or
    max_len / n positions (``"cache_seq"``, ``max_len`` a multiple of n);
    where ``tp`` splits the Mamba2 mixer (``tp.mixer``) a rank's states are
    ``ssm_state`` (L, batch, H / n, N, P) and ``conv_state`` (L, batch,
    K-1, d_inner / n + 2 g_l N) in the rank's channel order ``[x_r, B_g,
    C_g]`` (:func:`repro_torch.models.ssm.split_dims`), and the ranks'
    blocks put back in channel order
    (:func:`repro_torch.models.ssm.gather_state_blocks`) are the whole
    states; otherwise every rank holds them whole."""
    dev = resolve_device(device)
    cdt = torch_dtype(cfg.dtype)
    kh, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    if tp is not None and cfg.family != "ssm":
        if page_size is not None:
            raise ValueError("a split decode cache is the dense cache: the "
                             "paged pools are not split over 'model'")
        kh, max_len = _split_cache_dims(cfg, max_len, tp)
    if page_size is not None:
        if cfg.family not in PAGED_FAMILIES:
            raise ValueError(
                f"paged KV cache supports attention families only, not "
                f"{cfg.family!r} — SSM/hybrid state caches stay dense")
        if num_pages is None:
            num_pages = 1 + batch * -(-max_len // page_size)
        shape = (cfg.num_layers, num_pages, page_size, kh, hd)
        return {"k": torch.zeros(shape, dtype=cdt, device=dev),
                "v": torch.zeros(shape, dtype=cdt, device=dev)}

    def attn_cache(lead):
        shape = lead + (batch, max_len, kh, hd)
        return {"k": torch.zeros(shape, dtype=cdt, device=dev),
                "v": torch.zeros(shape, dtype=cdt, device=dev)}
    if cfg.family in PAGED_FAMILIES:
        return attn_cache((cfg.num_layers,))
    if cfg.family == "audio":
        return {"self": attn_cache((cfg.num_layers,)), "cross": None}
    if cfg.family == "ssm":
        return ssm_lib.mamba_cache_init(cfg, batch, cdt, dev,
                                        (cfg.num_layers,), tp)
    if cfg.family == "hybrid":
        return [ssm_lib.mamba_cache_init(cfg, batch, cdt, dev, (), tp)
                if ch == "M" else attn_cache(())
                for ch in cfg.layer_pattern()]
    raise ValueError(cfg.family)


def _split_cache_dims(cfg: ModelConfig, max_len: int, tp) -> Tuple[int, int]:
    """(kv heads, positions) of a rank's K/V buffers under ``tp``."""
    if tp.cache == "kv_heads":
        return tp.local_heads()[1], max_len
    if tp.cache == "cache_seq":
        if max_len % tp.size:
            raise ValueError(f"a decode cache split over its sequence needs "
                             f"max_len a multiple of the 'model' size "
                             f"{tp.size}, not {max_len}")
        return cfg.num_kv_heads, max_len // tp.size
    raise ValueError(
        f"a split decode needs its cache split over kv heads or over its "
        f"sequence: {cfg.num_kv_heads} kv heads do not divide over "
        f"{tp.size} 'model' ranks and the rules keep 'cache_seq' off "
        f"'model' (plan with rules_for(cfg, mesh, 'decode'))")


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def _lin(params, x, cfg, cdt, module, adapter_ids, tp=None):
    return peft_lib.apply_linear(params, x, cfg.peft, cdt, module=module,
                                 adapter_ids=adapter_ids, tp=tp)


def mlp_apply(params: Params, x: torch.Tensor, cfg: ModelConfig, cdt,
              adapter_ids=None, tp=None) -> torch.Tensor:
    """The (gated) MLP; under a compute split ``tp`` (the sharded step's
    :class:`~repro_torch.distributed.tensor_parallel.TensorParallel`) this
    rank's columns of gate and up and its rows of down, summed over
    ranks."""
    act = layers.mlp_activation(cfg.mlp_type)
    if tp is not None:
        x = tp.copy_in(x, ("gate", "up"))
    up = _lin(params["up"], x, cfg, cdt, "up", adapter_ids, tp)
    if "gate" in params:
        g = _lin(params["gate"], x, cfg, cdt, "gate", adapter_ids, tp)
        h = act(g.float()).to(cdt) * up
    else:
        h = act(up.float()).to(cdt)
    h = shard_act(h, ("batch", "seq", "mlp"))
    return _lin(params["down"], h, cfg, cdt, "down", adapter_ids, tp)


def _heads(cfg: ModelConfig, tp) -> Tuple[int, int]:
    """(q heads, kv heads) this rank's q and k linears output."""
    if tp is None:
        return cfg.num_heads, cfg.num_kv_heads
    return tp.local_heads()


def _local_kv(k, v, cfg: ModelConfig, tp):
    """``k``, ``v`` as this rank's q heads attend them: whole kv heads
    (replicated k and v) narrowed to the heads its split q heads map to."""
    if tp is None or tp.kinds["q"] != "col" or tp.kinds["k"] == "col":
        return k, v
    h = cfg.num_heads // tp.size
    return attention.local_kv_heads(k, v, tp.rank * h, h,
                                    cfg.num_heads // cfg.num_kv_heads)


def _qkv(params, x, cfg: ModelConfig, cdt, positions, adapter_ids,
         tp=None, narrow: bool = True):
    """q, k, v (B, S, heads, hd) after RoPE; under a compute split this
    rank's q heads and the kv heads they attend (every kv head that k and
    v compute, without ``narrow``)."""
    (h, kh), hd = _heads(cfg, tp), cfg.resolved_head_dim
    b, s = x.shape[:2]
    if tp is not None:
        x = tp.copy_in(x, ("q", "k", "v"))
    q = _lin(params["q"], x, cfg, cdt, "q", adapter_ids, tp).reshape(
        b, s, h, hd)
    k = _lin(params["k"], x, cfg, cdt, "k", adapter_ids, tp).reshape(
        b, s, kh, hd)
    v = _lin(params["v"], x, cfg, cdt, "v", adapter_ids, tp).reshape(
        b, s, kh, hd)
    q = layers.apply_rope(q, positions, cfg.rope_theta)
    k = layers.apply_rope(k, positions, cfg.rope_theta)
    if narrow:
        k, v = _local_kv(k, v, cfg, tp)
    q = shard_act(q, ("batch", "seq", "heads", None))
    k = shard_act(k, ("batch", "seq", "kv_heads", None))
    v = shard_act(v, ("batch", "seq", "kv_heads", None))
    return q, k, v


def attn_prefill(params, x, cfg: ModelConfig, cdt, positions, kv, shared,
                 adapter_ids=None) -> torch.Tensor:
    """Paged suffix prefill of one layer: writes the suffix KV through the
    page table (pad tokens to the trash page), then attends over the aliased
    prefix pages + the causal suffix (the prefix-prefill kernel) or, with no
    prefix anywhere in the batch, the chunked causal path."""
    q, k, v = _qkv(params, x, cfg, cdt, positions, adapter_ids)
    s = x.shape[1]
    valid = torch.arange(s, device=x.device)[None, :] < \
        shared["lengths"][:, None]
    attention.paged_write(kv["k"], k, shared["page_table"], positions, valid)
    attention.paged_write(kv["v"], v, shared["page_table"], positions, valid)
    pre = shared["prefix_table"]
    if pre.shape[1] != 0:
        # rows read their prefix pages after the write; positions past
        # prefix_len (own suffix pages, trash) are masked exactly
        out = attention.paged_prefix_prefill_attention(
            q, k, v, kv["k"], kv["v"], pre, shared["prefix_len"])
    else:
        out = attention.chunked_attention(q, k, v, causal=True)
    out = out.reshape(*x.shape[:-1], -1)
    return _lin(params["o"], out, cfg, cdt, "o", adapter_ids)


def attn_decode(params, x_t, cfg: ModelConfig, cdt, positions, kv,
                page_table, adapter_ids=None) -> torch.Tensor:
    """One-token decode of one layer at per-slot ``positions`` (B,)."""
    q, k, v = _qkv(params, x_t, cfg, cdt, positions[:, None], adapter_ids)
    attention.paged_write(kv["k"], k, page_table, positions[:, None])
    attention.paged_write(kv["v"], v, page_table, positions[:, None])
    out = attention.paged_decode_attention(q, kv["k"], kv["v"], page_table,
                                           positions + 1)
    out = out.reshape(x_t.shape[0], 1, -1)
    return _lin(params["o"], out, cfg, cdt, "o", adapter_ids)


def attn_dense_prefill(params, x, cfg: ModelConfig, cdt, positions, kv,
                       adapter_ids=None, tp=None) -> torch.Tensor:
    """Prefill of one layer into a dense per-layer buffer ``kv`` (B,
    max_len, KH, hd): the prompt's K/V are written at positions [0, S) in
    place (the reference pad-writes the buffer), then the chunked causal
    path.  Under a serving split ``tp`` the buffer is the rank's block:
    its kv heads, or every kv head at its positions (``"cache_seq"``:
    the rank writes the prompt's positions it holds, and attends its q
    heads over the whole prompt's k and v as the train split does)."""
    q, k, v = _qkv(params, x, cfg, cdt, positions, adapter_ids, tp,
                   narrow=False)
    s = x.shape[1]
    lo, hi = 0, s
    if tp is not None and tp.cache == "cache_seq":
        c = kv["k"].shape[1]
        lo, hi = tp.rank * c, min(s, (tp.rank + 1) * c)
    if hi > lo:
        kv["k"][:, :hi - lo] = k[:, lo:hi].to(kv["k"].dtype)
        kv["v"][:, :hi - lo] = v[:, lo:hi].to(kv["v"].dtype)
    k, v = _local_kv(k, v, cfg, tp)
    out = attention.chunked_attention(q, k, v, causal=True)
    return _lin(params["o"], out.reshape(*x.shape[:-1], -1), cfg, cdt, "o",
                adapter_ids, tp)


def attn_dense_decode(params, x_t, cfg: ModelConfig, cdt, positions, kv,
                      view_table, adapter_ids=None, tp=None) -> torch.Tensor:
    """One-token decode of one layer over a dense buffer ``kv`` (B,
    max_len, KH, hd): the token's K/V written at ``[b, positions[b]]`` in
    place, then one-token attention over ``positions + 1`` (the paged-decode
    kernel over the buffer viewed as pages on the card, through
    ``view_table``).  Under a serving split ``tp`` the rank decodes its
    heads over its kv heads' buffer, or, over a sequence split, through
    :func:`_seq_decode`."""
    q, k, v = _qkv(params, x_t, cfg, cdt, positions[:, None], adapter_ids,
                   tp, narrow=False)
    if tp is not None and tp.cache == "cache_seq":
        out = _seq_decode(q, k, v, kv, positions, view_table, tp)
    else:
        bidx = torch.arange(x_t.shape[0], device=x_t.device)
        kv["k"][bidx, positions] = k[:, 0].to(kv["k"].dtype)
        kv["v"][bidx, positions] = v[:, 0].to(kv["v"].dtype)
        out = attention.dense_decode_attention(q, kv["k"], kv["v"],
                                               positions + 1, view_table)
    out = out.reshape(x_t.shape[0], 1, -1)
    return _lin(params["o"], out, cfg, cdt, "o", adapter_ids, tp)


def _seq_decode(q, k, v, kv, positions, view_table, tp) -> torch.Tensor:
    """One-token attention over a decode cache split over its sequence:
    this rank's buffers ``kv`` hold every kv head at positions [r c, (r +
    1) c).  The owner of each row's position writes the token's K/V
    (every rank computes them: the fallback leaves k and v replicated);
    each rank attends every q head (its own q heads all-gathered over
    ``model`` when q is split) over its positions through the paged-decode
    kernel, with each row's and head's log-sum-exp (-inf for an empty
    slice); the ranks combine: a MAX all-reduce of the lse, then one SUM
    all-reduce of the rescaled outputs and weights.  Returns this rank's
    q heads (B, 1, H', hd) in q's dtype."""
    b, c = q.shape[0], kv["k"].shape[1]
    lo = tp.rank * c
    own = ((positions >= lo) & (positions < lo + c))[:, None, None]
    bidx = torch.arange(b, device=q.device)
    at = (positions - lo).clamp(0, c - 1)
    for name, new in (("k", k), ("v", v)):
        buf = kv[name]
        buf[bidx, at] = torch.where(own, new[:, 0].to(buf.dtype),
                                    buf[bidx, at])
    h_local = q.shape[2]
    split_q = tp.kinds["q"] == "col"
    if split_q:
        q = collectives.all_gather(q, 2, tp.mesh, tensor_parallel.AXIS,
                                   tag="seq_q")
    lengths = (positions + 1 - lo).clamp(0, c)
    out, lse = attention.dense_decode_attention(q, kv["k"], kv["v"], lengths,
                                                view_table, lse=True)
    m = collectives.all_reduce(lse.clone(), tp.mesh, (tensor_parallel.AXIS,),
                               dist.ReduceOp.MAX, tag="seq_max")
    w = torch.exp(lse - torch.where(torch.isfinite(m), m,
                                    torch.zeros_like(m)))
    part = torch.cat([out[:, 0].float() * w[..., None], w[..., None]], -1)
    collectives.all_reduce(part, tp.mesh, (tensor_parallel.AXIS,),
                           tag="seq_sum")
    out = (part[..., :-1] / part[..., -1:].clamp_min(1e-30))[:, None]
    if split_q:
        out = out.narrow(2, tp.rank * h_local, h_local)
    return out.to(q.dtype)


def cross_kv(params, enc_out, cfg: ModelConfig, cdt, adapter_ids=None,
             tp=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decoder layer's cross-attention K and V (B, S_src, KH, hd) from
    the encoder output (no RoPE); under a compute split this rank's kv
    heads, or whole kv heads that :func:`cross_apply` narrows to the ones
    its split q heads attend (either way each rank's gradient of
    ``enc_out`` is partial, so it goes through ``copy_to``)."""
    kh, hd = _heads(cfg, tp)[1], cfg.resolved_head_dim
    b, s = enc_out.shape[:2]
    if tp is not None:
        enc_out = tp.copy_in(enc_out, ("q", "k", "v"))
    k = _lin(params["k"], enc_out, cfg, cdt, "k", adapter_ids, tp)
    v = _lin(params["v"], enc_out, cfg, cdt, "v", adapter_ids, tp)
    return k.reshape(b, s, kh, hd), v.reshape(b, s, kh, hd)


def _cross_q(params, h, cfg: ModelConfig, cdt, adapter_ids, tp=None):
    b, s = h.shape[:2]
    if tp is not None:
        h = tp.copy_in(h, ("q",))
    q = _lin(params["q"], h, cfg, cdt, "q", adapter_ids, tp)
    return q.reshape(b, s, _heads(cfg, tp)[0], cfg.resolved_head_dim)


def cross_apply(params, h, k, v, cfg: ModelConfig, cdt, adapter_ids=None,
                tp=None, local_kv: bool = False) -> torch.Tensor:
    """Non-causal cross-attention of ``h``'s queries (no RoPE) over the
    encoder's K/V (the training and prefill path); ``local_kv``: k and v
    are already the kv heads this rank's q heads attend (a split cross
    cache)."""
    if not local_kv:
        k, v = _local_kv(k, v, cfg, tp)
    out = attention.chunked_attention(_cross_q(params, h, cfg, cdt,
                                               adapter_ids, tp), k, v,
                                      causal=False)
    return _lin(params["o"], out.reshape(*h.shape[:-1], -1), cfg, cdt, "o",
                adapter_ids, tp)


def cross_decode(params, h_t, k, v, lengths, view_table, cfg: ModelConfig,
                 cdt, adapter_ids=None, tp=None) -> torch.Tensor:
    """One-token cross-attention over one layer's cross K/V buffers (B,
    S_pad, KH, hd) up to ``lengths`` (B,) (the paged-decode kernel over the
    buffers viewed as pages on the card, through ``view_table``); under a
    serving split the buffers hold the kv heads this rank's q heads
    attend (:func:`cross_cache`)."""
    q = _cross_q(params, h_t, cfg, cdt, adapter_ids, tp)
    out = attention.dense_decode_attention(q, k, v, lengths, view_table)
    return _lin(params["o"], out.reshape(h_t.shape[0], 1, -1), cfg, cdt,
                "o", adapter_ids, tp)


def _block(lp, x, cfg, cdt, attn_fn, adapter_ids, moe_impl="dense",
           cross_fn=None, tp=None):
    """(y, the layer's MoE aux loss, or None for a dense layer);
    ``cross_fn(cross_params, h)``, for a decoder block of an
    encoder-decoder, is the cross-attention of the path; ``tp`` splits
    the dense MLP, or an MoE layer's experts and shared experts."""
    h = layers.apply_norm(lp["ln1"], x)
    x = x + attn_fn(lp["attn"], h)
    if cross_fn is not None:
        x = x + cross_fn(lp["cross"], layers.apply_norm(lp["ln_cross"], x))
    h = layers.apply_norm(lp["ln2"], x)
    if "moe" in lp:
        m, aux = moe_lib.moe_apply(lp["moe"], h, cfg, cdt, moe_impl, tp)
    else:
        m, aux = mlp_apply(lp["mlp"], h, cfg, cdt, adapter_ids, tp), None
    return shard_act(x + m, ("batch", "seq_sp", "embed")), aux


def shared_block_apply(params, x, h0, cfg: ModelConfig, cdt, attn_fn,
                       adapter_ids=None, tp=None) -> torch.Tensor:
    """The hybrid's shared attention + MLP block at one position: its input
    is ``fuse([x, h0])`` (h0 the token embeddings), its output added to
    ``x``.  ``attn_fn(attn_params, h)`` is the attention of the path
    (training, prefill or decode); ``tp`` splits the block's MLP (``fuse``
    computes replicated)."""
    inp = _lin(params["fuse"], torch.cat([x, h0], dim=-1), cfg, cdt, "fuse",
               adapter_ids)
    y, _ = _block(params["block"], inp, cfg, cdt, attn_fn, adapter_ids,
                  tp=tp)
    return x + y


def attn_apply(params, x, cfg: ModelConfig, cdt, positions,
               causal: bool = True, tp=None) -> torch.Tensor:
    """Full-sequence self-attention of one layer (the training path;
    non-causal in an encoder); under a compute split ``tp`` this rank's
    heads, its rows of o summed over ranks."""
    q, k, v = _qkv(params, x, cfg, cdt, positions, None, tp)
    out = attention.chunked_attention(q, k, v, causal=causal)
    return _lin(params["o"], out.reshape(*x.shape[:-1], -1), cfg, cdt, "o",
                None, tp)


def _train_block(lp, cfg, cdt, positions, moe_impl, x, enc_out=None,
                 tp=None):
    def attn_fn(ap, h):
        return attn_apply(ap, h, cfg, cdt, positions, tp=tp)
    cross_fn = None
    if enc_out is not None:
        def cross_fn(cp, h):
            k, v = cross_kv(cp, enc_out, cfg, cdt, tp=tp)
            return cross_apply(cp, h, k, v, cfg, cdt, tp=tp)
    return _block(lp, x, cfg, cdt, attn_fn, None, moe_impl, cross_fn, tp)


def _encoder_block(lp, cfg, cdt, positions, x, tp=None):
    def attn_fn(ap, h):
        return attn_apply(ap, h, cfg, cdt, positions, causal=False, tp=tp)
    return _block(lp, x, cfg, cdt, attn_fn, None, tp=tp)[0]


def run_encoder(params: Params, src_embeds: torch.Tensor, cfg: ModelConfig,
                gather=None, tp=None) -> torch.Tensor:
    """The encoder-decoder's encoder over ``src_embeds`` (B, S_src,
    d_model), cast to the compute dtype: non-causal self-attention (RoPE
    over the source positions, as the reference's block applies it), one
    remat boundary per layer, every rotation of its stacks built once;
    returns the final-norm output (B, S_src, d_model).  ``gather`` and
    ``tp`` as in :func:`forward_hidden`."""
    cdt = torch_dtype(cfg.dtype)
    x = shard_act(src_embeds.to(cdt), ("batch", "seq", "embed"))
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    stack = _with_rotations(params["enc_layers"], cfg)
    block = _remat(_on_use(functools.partial(
        _encoder_block, cfg=cfg, cdt=cdt, positions=positions, tp=tp),
        gather), cfg)
    for i in range(cfg.num_encoder_layers):
        x = block(_layer(stack, i), ("enc_layers",), x=x)
    return layers.apply_norm(params["enc_final_norm"], x)


def _train_mamba(lp, cfg, cdt, x):
    hn = layers.apply_norm(lp["ln"], x)
    return x + ssm_lib.mamba_block_apply(lp["ssm"], hn, cfg, cdt)


def _train_shared(sp, cfg, cdt, positions, x, h0, tp=None):
    def attn_fn(ap, h):
        return attn_apply(ap, h, cfg, cdt, positions, tp=tp)
    return shared_block_apply(sp, x, h0, cfg, cdt, attn_fn, tp=tp)


#: the products without batch dims, whose outputs ``"minimal"`` keeps (the
#: reference's ``dots_with_no_batch_dims_saveable``): a 2-D matmul, which
#: every plain linear of the LoRA and OFT families and every frozen linear
#: dispatches to, and the PSOFT kernel's forward launch
_SAVED_PRODUCTS = frozenset((torch.ops.aten.mm.default,
                             torch.ops.aten.addmm.default,
                             ops.PSOFT_FORWARD_OP))


def _minimal_policy(_ctx, op, *_args, **_kwargs):
    if op in _SAVED_PRODUCTS:
        return torch_checkpoint.CheckpointPolicy.MUST_SAVE
    return torch_checkpoint.CheckpointPolicy.PREFER_RECOMPUTE


def _on_use(fn, gather):
    """``fn(lp, **kw)`` as ``run(lp, prefix, **kw)``, which first puts
    together the leaves a sharded step split (``gather(lp, prefix)``,
    ``prefix`` the path of ``lp``'s subtree in the param tree) when there
    is a ``gather``: inside the layer's remat boundary, so that a recompute
    gathers again and no gathered layer outlives its use."""
    if gather is None:
        return lambda lp, prefix, **kw: fn(lp, **kw)
    return lambda lp, prefix, **kw: fn(gather(lp, prefix), **kw)


def _remat(fn, cfg: ModelConfig):
    """One remat boundary, per ``remat_policy``: ``"none"`` keeps the
    layer's activations; ``"full"`` recomputes the layer in the backward
    (non-reentrant checkpoint); ``"minimal"`` (a selective checkpoint)
    keeps the outputs of its products without batch dims, every linear's,
    and recomputes the rest: attention (batched products and kernels),
    norms, activations and RoPE.  A kept PSOFT forward is not launched
    again in the backward."""
    if cfg.remat_policy == "none":
        return fn
    kw = dict(use_reentrant=False, preserve_rng_state=False)
    if cfg.remat_policy == "minimal":
        kw["context_fn"] = functools.partial(
            torch_checkpoint.create_selective_checkpoint_contexts,
            _minimal_policy)
    elif cfg.remat_policy != "full":
        raise ValueError(f"remat_policy {cfg.remat_policy!r}: expected "
                         f"'none', 'minimal' or 'full'")
    return functools.partial(torch_checkpoint.checkpoint, fn, **kw)


def _with_rotations(tree, cfg: ModelConfig):
    """``tree`` with every rotation a PEFT linear builds ahead (PSOFT's
    r x r rotation, the OFT/BOFT Cayley blocks (L, d/b, b, b) or
    (L, m, d/b, b, b)) under ``"rot"``: one ``cayley_neumann`` call per
    layer stack, or per unstacked linear of a hybrid."""
    def one(node, path):
        if not peft_lib.is_peft_linear(node):
            return None
        method = registry.resolve(node, cfg.peft,
                                  module=path[-1] if path else None)
        rot = method.rotations(node, cfg.peft)
        return node if rot is None else {**node, "rot": rot}
    return map_dicts(one, tree)


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def _embed_tokens(params: Params, tokens: torch.Tensor, cdt,
                  tp=None) -> torch.Tensor:
    """Token embeddings; under a compute split over the vocabulary, a
    vocab-parallel lookup of this rank's rows."""
    if tp is not None and tp.vocab:
        w, start = tp.vocab_block(params["embed"]["w"], 0)
        return layers.embed_lookup({"w": w}, tokens, cdt,
                                   (start, tp.mesh, tensor_parallel.AXIS))
    return layers.embed_lookup(params["embed"], tokens, cdt)


def _embed_inputs(params: Params, batch: Dict[str, torch.Tensor],
                  cfg: ModelConfig, cdt, tp=None) -> torch.Tensor:
    """Token embeddings (B, S, D); a VLM batch's ``patch_embeds`` (B, P,
    D), cast to the compute dtype, go in front of them.  Under a compute
    split over the vocabulary, a vocab-parallel lookup of this rank's
    rows."""
    x = _embed_tokens(params, batch["tokens"], cdt, tp)
    if cfg.family == "vlm" and "patch_embeds" in batch:
        x = torch.cat([batch["patch_embeds"].to(cdt), x], dim=1)
    return shard_act(x, ("batch", "seq", "embed"))


def forward_hidden(params: Params, batch: Dict[str, torch.Tensor],
                   cfg: ModelConfig, moe_impl: str = "capacity", gather=None,
                   tp=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(final-norm hidden states (B, S, D) of ``batch["tokens"]`` (B, S),
    behind a VLM's patches (B, P + S, D), the MoE aux loss summed over
    layers (0 for a dense model)): causal chunked attention or the chunked
    SSD scan, one remat boundary per layer (a hybrid's shared-block
    positions and an encoder's layers included); an encoder-decoder runs
    its encoder over ``batch["src_embeds"]`` first.  ``gather(subtree,
    prefix)``, from a sharded train step, puts each layer's split leaves
    together as the loop reaches the layer (:data:`LAYER_TREES`; the other
    top-level leaves must come in whole, as :func:`loss_fn` gathers
    them).  ``tp``, the sharded step's compute split over ``model``
    (:mod:`repro_torch.distributed.tensor_parallel`), runs every attention
    block's heads and dense MLP columns split, and the embedding over the
    vocabulary."""
    cdt = torch_dtype(cfg.dtype)
    enc_out = run_encoder(params, batch["src_embeds"], cfg, gather, tp) \
        if cfg.is_encoder_decoder else None
    x = _embed_inputs(params, batch, cfg, cdt, tp)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.family == "hybrid":
        h0 = x
        lays = _with_rotations(params["layers"], cfg)
        shared = _with_rotations(params["shared_attn"], cfg)
        mamba = _remat(_on_use(functools.partial(_train_mamba, cfg=cfg,
                                                 cdt=cdt), gather), cfg)
        attn = _remat(_on_use(functools.partial(
            _train_shared, cfg=cfg, cdt=cdt, positions=positions, tp=tp),
            gather), cfg)
        for i, ch in enumerate(cfg.layer_pattern()):
            x = mamba(lays[i], ("layers", str(i)), x=x) if ch == "M" else \
                attn(shared, ("shared_attn",), x=x, h0=h0)
        return layers.apply_norm(params["final_norm"], x), aux
    stack = _with_rotations(params["layers"] if tp is None
                            else tp.local_experts(params["layers"]), cfg)
    if cfg.family == "ssm":
        block = _remat(_on_use(functools.partial(_train_mamba, cfg=cfg,
                                                 cdt=cdt), gather), cfg)
        for i in range(cfg.num_layers):
            x = block(_layer(stack, i), ("layers",), x=x)
        return layers.apply_norm(params["final_norm"], x), aux
    block = _remat(_on_use(functools.partial(
        _train_block, cfg=cfg, cdt=cdt, positions=positions,
        moe_impl=moe_impl, tp=tp), gather), cfg)
    for i in range(cfg.num_layers):
        x, layer_aux = block(_layer(stack, i), ("layers",), x=x,
                             enc_out=enc_out)
        if layer_aux is not None:
            aux = aux + layer_aux
    return layers.apply_norm(params["final_norm"], x), aux


def chunked_ce_loss(params: Params, h: torch.Tensor, labels: torch.Tensor,
                    cfg: ModelConfig, loss_chunk: int = 1024, tp=None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean next-token cross-entropy over sequence chunks (the full
    (B, S, V) logits never exist at once); labels < 0 carry no loss.
    Under a compute split over the vocabulary each rank computes its
    slice of the logits and the loss is the vocab-parallel cross-entropy
    (:func:`repro_torch.distributed.tensor_parallel.vocab_parallel_ce`).
    Returns (loss, token count)."""
    b, s, _ = h.shape
    loss_chunk = min(loss_chunk, s)
    while s % loss_chunk:
        loss_chunk -= 1
    split = tp is not None and tp.vocab
    if split:
        h = collectives.copy_to(h, tp.mesh, tensor_parallel.AXIS)
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    cnt = torch.zeros((), dtype=torch.int32, device=h.device)
    for c0 in range(0, s, loss_chunk):
        logits = lm_logits(params, h[:, c0:c0 + loss_chunk], cfg, tp).float()
        ll = labels[:, c0:c0 + loss_chunk].long()
        mask = ll >= 0
        if split:
            per_token = tensor_parallel.vocab_parallel_ce(
                logits, ll, tp.rank * logits.shape[-1], tp)
        else:
            lse = torch.logsumexp(logits, dim=-1)
            gold = torch.gather(logits, -1,
                                ll.clamp_min(0)[..., None])[..., 0]
            per_token = lse - gold
        tot = tot + (per_token * mask).sum()
        cnt = cnt + mask.sum(dtype=torch.int32)
    return tot / cnt.clamp_min(1), cnt


#: the subtrees the layer loops walk a layer at a time
LAYER_TREES = ("layers", "enc_layers", "shared_attn")


def loss_fn(params: Params, batch: Dict[str, torch.Tensor],
            cfg: ModelConfig, moe_impl: str = "capacity", gather=None,
            tp=None) -> Tuple[torch.Tensor, Dict]:
    """(loss, {"loss", "aux", "tokens"}) of a token batch with labels; an
    MoE model adds ``aux_loss_weight`` times its aux loss; a VLM's patch
    positions carry no loss (their labels are -1).  Under a sharded step's
    ``gather`` the leaves outside :data:`LAYER_TREES` (embeddings, head,
    final norms) are put together once, and the layers' as the loop
    reaches them (:func:`forward_hidden`).  Under the sharded step's
    compute split ``tp`` (:func:`repro_torch.distributed.tensor_parallel.
    plan`) the heads, the MLP columns and the vocabulary split over
    ``model``; the loss is whole on every rank."""
    if gather is not None:
        params = {k: v if k in LAYER_TREES else gather(v, (k,))
                  for k, v in params.items()}
    h, aux = forward_hidden(params, batch, cfg, moe_impl, gather, tp)
    labels = batch["labels"]
    if cfg.family == "vlm" and "patch_embeds" in batch:
        pad = torch.full((labels.shape[0], batch["patch_embeds"].shape[1]),
                         -1, dtype=labels.dtype, device=labels.device)
        labels = torch.cat([pad, labels], dim=1)
    loss, n_tok = chunked_ce_loss(params, h, labels, cfg, tp=tp)
    if cfg.family == "moe":
        loss = loss + cfg.moe.aux_loss_weight * aux
    return loss, {"loss": loss, "aux": aux, "tokens": n_tok}


def forward_logits(params: Params, batch: Dict[str, torch.Tensor],
                   cfg: ModelConfig, moe_impl: str = "dense"
                   ) -> torch.Tensor:
    """Full logits (B, S, V): small-scale and eval use only."""
    h, _ = forward_hidden(params, batch, cfg, moe_impl)
    return lm_logits(params, h, cfg)


def lm_logits(params: Params, h: torch.Tensor,
              cfg: ModelConfig, tp=None) -> torch.Tensor:
    """Logits (..., V); under a compute split over the vocabulary this
    rank's slice (..., V / n)."""
    cdt = torch_dtype(cfg.dtype)
    w = params["embed"]["w"].T if cfg.tie_embeddings \
        else params["lm_head"]["w"]
    if tp is not None and tp.vocab:
        w = tp.vocab_block(w, 1)[0]
    return shard_act(h.to(cdt) @ w.to(cdt), ("batch", "seq", "vocab"))


def _serve_logits(params: Params, h: torch.Tensor, cfg: ModelConfig,
                  tp=None) -> torch.Tensor:
    """Logits (B, 1, V) of a serving call, whole on every rank: under a
    split over the vocabulary each rank's (B, 1, V / n) gathered over
    ``model`` (the reference's ``out_shardings=None``)."""
    logits = lm_logits(params, h, cfg, tp)
    if tp is not None and tp.vocab:
        logits = collectives.all_gather(logits, -1, tp.mesh,
                                        tensor_parallel.AXIS, tag="logits")
    return logits


def _serving_split(params: Params, cfg: ModelConfig, tp, adapter_ids,
                   paged: bool = False) -> Params:
    """``params`` as a split serving call reads them (its expert stacks
    cut to the rank's experts, its Mamba2 mixers to the rank's heads:
    :func:`repro_torch.models.ssm.local_mixer`, once a call); raises where
    the split has no path: a banked adapter (``adapter_ids``) or a paged
    cache."""
    if tp is None:
        return params
    if adapter_ids is not None:
        raise ValueError("a split prefill / decode_step serves the base "
                         "model only: an adapter bank (adapter_ids) is not "
                         "split over 'model'")
    if paged:
        raise ValueError("a split decode_step takes the dense cache "
                         "(init_cache without a page size): the paged "
                         "pools are not split over 'model'")
    layers_ = params["layers"]
    if tp.mixer and cfg.family == "ssm":
        layers_ = {**layers_, "ssm": ssm_lib.local_mixer(layers_["ssm"], cfg,
                                                         tp)}
    elif tp.mixer and cfg.family == "hybrid":
        layers_ = [{**lp, "ssm": ssm_lib.local_mixer(lp["ssm"], cfg, tp)}
                   if "ssm" in lp else lp for lp in layers_]
    return {**params, "layers": tp.local_experts(layers_)}


def _last_hidden(h: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """(B, 1, D) hidden state at each row's last real token."""
    idx = lengths.long() - 1
    return h[torch.arange(h.shape[0], device=h.device), idx][:, None]


def paged_prefill(params: Params, batch: Dict[str, torch.Tensor],
                  cache: Dict[str, torch.Tensor], cfg: ModelConfig,
                  lengths: torch.Tensor, prefix_lengths: torch.Tensor, *,
                  adapter_ids: Optional[torch.Tensor] = None,
                  all_logits: bool = False
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Suffix prefill through block-paged KV indirection.

    ``cache``: pools ``{"k","v"}: (L, P, pg, KH, hd)`` plus ``"page_table"``
    (B, maxp) and ``"prefix_table"`` (B, 0 or maxp).  ``batch["tokens"]``
    holds only the right-padded suffix tokens; row i's token j runs at
    position ``prefix_lengths[i] + j``.  Pools are updated in place.
    Returns (last-real-token logits (B, 1, V), the pools); with
    ``all_logits=True`` the logits cover every suffix position, (B, S, V),
    as the speculative-decode verify pass reads them (positions past a
    row's length carry values the caller must ignore)."""
    if cfg.family not in PAGED_FAMILIES:
        raise ValueError(f"paged prefill supports attention families only, "
                         f"not {cfg.family!r}")
    cdt = torch_dtype(cfg.dtype)
    x = _embed_inputs(params, batch, cfg, cdt)
    s = x.shape[1]
    prefix = prefix_lengths.long()
    positions = prefix[:, None] + torch.arange(s, device=x.device)[None, :]
    shared = {"page_table": cache["page_table"],
              "prefix_table": cache["prefix_table"],
              "prefix_len": prefix_lengths, "lengths": lengths.long()}
    for i in range(cfg.num_layers):
        kv = {"k": cache["k"][i], "v": cache["v"][i]}

        def attn_fn(ap, h, kv=kv):
            return attn_prefill(ap, h, cfg, cdt, positions, kv, shared,
                                adapter_ids)
        # moe_impl "dense": capacity dispatch couples the rows of a batch
        # through the shared expert buffer; the dense impl keeps every
        # row's output independent of its batch mates
        x, _ = _block(_layer(params["layers"], i), x, cfg, cdt, attn_fn,
                      adapter_ids, "dense")
    x = layers.apply_norm(params["final_norm"], x)
    if not all_logits:
        x = _last_hidden(x, lengths)
    return lm_logits(params, x, cfg), {"k": cache["k"], "v": cache["v"]}


def prefill(params: Params, batch: Dict[str, torch.Tensor],
            cfg: ModelConfig, max_len: int,
            lengths: Optional[torch.Tensor] = None, *,
            moe_impl: str = "capacity",
            adapter_ids: Optional[torch.Tensor] = None, tp=None):
    """Prompt prefill into a fresh dense cache (:func:`init_cache` with no
    page size): returns (the logits at each row's last real token (B, 1,
    V), the cache).  ``lengths`` (B,) are the true prompt lengths of
    right-padded attention-family rows, a VLM's patches included (None:
    every row is full); the recurrent families' states take every token
    in, so their rows must all be exactly ``lengths`` long.  Every MoE
    layer runs ``moe_impl``'s dispatch ("capacity", the reference's
    default, or "dense", which the engine passes).  An encoder-decoder
    runs its encoder over ``batch["src_embeds"]`` and builds each decoder
    layer's cross K/V once (:func:`cross_cache`), which its
    cross-attention reads.

    ``tp``, a serving split over ``model``
    (``tensor_parallel.plan(cfg, mesh, rules_for(cfg, mesh, "decode"))``
    on a live mesh; every rank calls with the same inputs and whole
    ``params``, or its blocks of the embedding, the head and the expert
    stacks), splits heads, MLP columns, experts and the vocabulary as
    the train split does; the cache is this rank's block
    (:func:`init_cache`) and the logits are whole on every rank."""
    params = _serving_split(params, cfg, tp, adapter_ids)
    cdt = torch_dtype(cfg.dtype)
    x = _embed_inputs(params, batch, cfg, cdt, tp)
    b, s = x.shape[:2]
    if lengths is None:
        lengths = torch.full((b,), s, dtype=torch.long, device=x.device)
    positions = torch.arange(s, device=x.device)[None, :]
    cache = init_cache(cfg, b, max_len, device=x.device, tp=tp)

    def attn_fn_for(kv):
        def attn_fn(ap, h):
            return attn_dense_prefill(ap, h, cfg, cdt, positions, kv,
                                      adapter_ids, tp)
        return attn_fn
    if cfg.family in PAGED_FAMILIES:
        for i in range(cfg.num_layers):
            kv = {"k": cache["k"][i], "v": cache["v"][i]}
            x, _ = _block(_layer(params["layers"], i), x, cfg, cdt,
                          attn_fn_for(kv), adapter_ids, moe_impl, tp=tp)
    elif cfg.family == "audio":
        enc_out = run_encoder(params, batch["src_embeds"], cfg, tp=tp)
        s_src = enc_out.shape[1]
        cross = cache["cross"] = cross_cache(params, enc_out, cfg,
                                             adapter_ids, tp)
        for i in range(cfg.num_layers):
            kv = {"k": cache["self"]["k"][i], "v": cache["self"]["v"][i]}

            def cross_fn(cp, h, i=i):
                return cross_apply(cp, h, cross["k"][i][:, :s_src],
                                   cross["v"][i][:, :s_src], cfg, cdt,
                                   adapter_ids, tp, local_kv=True)
            x, _ = _block(_layer(params["layers"], i), x, cfg, cdt,
                          attn_fn_for(kv), adapter_ids, moe_impl, cross_fn,
                          tp)
    elif cfg.family == "ssm":
        for i in range(cfg.num_layers):
            lp = _layer(params["layers"], i)
            hn = layers.apply_norm(lp["ln"], x)
            y, c = ssm_lib.mamba_block_apply(lp["ssm"], hn, cfg, cdt, True,
                                             adapter_ids, tp)
            x = x + y
            for k, v in c.items():
                cache[k][i] = v
    elif cfg.family == "hybrid":
        h0 = x
        for i, ch in enumerate(cfg.layer_pattern()):
            if ch == "M":
                lp = params["layers"][i]
                hn = layers.apply_norm(lp["ln"], x)
                y, cache[i] = ssm_lib.mamba_block_apply(
                    lp["ssm"], hn, cfg, cdt, True, adapter_ids, tp)
                x = x + y
            else:
                x = shared_block_apply(params["shared_attn"], x, h0, cfg, cdt,
                                       attn_fn_for(cache[i]), adapter_ids,
                                       tp)
    else:
        raise ValueError(cfg.family)
    x = layers.apply_norm(params["final_norm"], x)
    return _serve_logits(params, _last_hidden(x, lengths), cfg, tp), cache


def cross_cache(params: Params, enc_out: torch.Tensor, cfg: ModelConfig,
                adapter_ids: Optional[torch.Tensor] = None, tp=None
                ) -> Dict[str, torch.Tensor]:
    """The decoder's cross K/V, built once from the encoder output:
    ``{"k","v"}: (L, B, S_pad, KH, hd)`` in the compute dtype, the source's
    ``S_src`` rows followed by zeros up to ``S_pad``, the next multiple of
    :data:`CROSS_PAD`; ``"len"`` (B,) int32, ``S_src`` in every row (the
    reference keeps one scalar).  Padded, the buffers view as whole pages
    of 16 rows on the card (:func:`repro_torch.models.attention
    .dense_page_size`) at any source length.  Under a serving split
    ``tp`` the buffers hold the kv heads this rank's q heads attend: its
    KH / n heads where k and v split, else the ones its q heads map to
    (:func:`repro_torch.models.attention.local_kv_heads`)."""
    cdt = torch_dtype(cfg.dtype)
    b, s = enc_out.shape[:2]
    s_pad = -(-s // CROSS_PAD) * CROSS_PAD
    kvs = [_local_kv(*cross_kv(_layer(params["layers"]["cross"], i), enc_out,
                               cfg, cdt, adapter_ids, tp), cfg, tp)
           for i in range(cfg.num_layers)]
    shape = (cfg.num_layers, b, s_pad) + tuple(kvs[0][0].shape[2:])
    k = torch.zeros(shape, dtype=cdt, device=enc_out.device)
    v = torch.zeros(shape, dtype=cdt, device=enc_out.device)
    for i, (ki, vi) in enumerate(kvs):
        k[i, :, :s], v[i, :, :s] = ki, vi
    return {"k": k, "v": v,
            "len": torch.full((b,), s, dtype=torch.int32,
                              device=enc_out.device)}


def decode_step(params: Params, batch: Dict[str, torch.Tensor], cache,
                pos, cfg: ModelConfig, *, moe_impl: str = "dense",
                adapter_ids: Optional[torch.Tensor] = None,
                view_table: Optional[torch.Tensor] = None, tp=None):
    """One-token serve step.  ``batch["tokens"]`` (B, 1); ``pos`` a scalar
    or (B,) per-slot positions; ``cache``: paged pools plus
    ``"page_table"`` (shared by every layer), or a dense cache
    (:func:`init_cache` with no page size; an encoder-decoder's after its
    :func:`prefill`).  The cache is updated in place.  ``view_table`` is
    the dense cache's paged view on the card
    (:func:`repro_torch.models.attention.dense_view_table`, built here
    when None; an encoder-decoder's cross cache gets its own here).
    ``moe_impl``: the MoE layers' dispatch ("dense", the reference's
    default).  ``tp``: a serving split (:func:`prefill`) over the dense
    cache its prefill built.  Returns (logits (B, 1, V), cache)."""
    params = _serving_split(params, cfg, tp, adapter_ids, paged=isinstance(
        cache, dict) and "page_table" in cache)
    cdt = torch_dtype(cfg.dtype)
    x = shard_act(_embed_tokens(params, batch["tokens"], cdt, tp),
                  ("batch", None, "embed"))
    b = x.shape[0]
    positions = torch.as_tensor(pos, device=x.device).long()
    if positions.ndim == 0:
        positions = positions.expand(b)
    if isinstance(cache, dict) and "page_table" in cache:
        pt = cache["page_table"]
        for i in range(cfg.num_layers):
            kv = {"k": cache["k"][i], "v": cache["v"][i]}

            def attn_fn(ap, h, kv=kv):
                return attn_decode(ap, h, cfg, cdt, positions, kv, pt,
                                   adapter_ids)
            x, _ = _block(_layer(params["layers"], i), x, cfg, cdt, attn_fn,
                          adapter_ids, moe_impl)
        x = layers.apply_norm(params["final_norm"], x)
        return lm_logits(params, x, cfg), cache

    table = view_table

    def attn_fn_for(kv):
        nonlocal table
        if table is None and kv["k"].is_cuda:
            table = attention.dense_view_table(b, kv["k"].shape[1],
                                               x.device)

        def attn_fn(ap, h):
            return attn_dense_decode(ap, h, cfg, cdt, positions, kv, table,
                                     adapter_ids, tp)
        return attn_fn

    def mamba_step(lp, x, c):
        hn = layers.apply_norm(lp["ln"], x)
        y, nc = ssm_lib.mamba_block_decode(lp["ssm"], hn, c, cfg, cdt,
                                           adapter_ids, tp)
        for k, v in nc.items():
            c[k].copy_(v)
        return x + y
    if cfg.family in PAGED_FAMILIES:
        for i in range(cfg.num_layers):
            kv = {"k": cache["k"][i], "v": cache["v"][i]}
            x, _ = _block(_layer(params["layers"], i), x, cfg, cdt,
                          attn_fn_for(kv), adapter_ids, moe_impl, tp=tp)
    elif cfg.family == "audio":
        cross = cache["cross"]
        cross_table = attention.dense_view_table(
            b, cross["k"].shape[2], x.device) if x.is_cuda else None
        for i in range(cfg.num_layers):
            kv = {"k": cache["self"]["k"][i], "v": cache["self"]["v"][i]}

            def cross_fn(cp, h, i=i):
                return cross_decode(cp, h, cross["k"][i], cross["v"][i],
                                    cross["len"], cross_table, cfg, cdt,
                                    adapter_ids, tp)
            x, _ = _block(_layer(params["layers"], i), x, cfg, cdt,
                          attn_fn_for(kv), adapter_ids, moe_impl, cross_fn,
                          tp)
    elif cfg.family == "ssm":
        for i in range(cfg.num_layers):
            x = mamba_step(_layer(params["layers"], i), x,
                           _layer(cache, i))
    elif cfg.family == "hybrid":
        h0 = x
        for i, ch in enumerate(cfg.layer_pattern()):
            if ch == "M":
                x = mamba_step(params["layers"][i], x, cache[i])
            else:
                x = shared_block_apply(params["shared_attn"], x, h0, cfg, cdt,
                                       attn_fn_for(cache[i]), adapter_ids,
                                       tp)
    else:
        raise ValueError(cfg.family)
    x = layers.apply_norm(params["final_norm"], x)
    return _serve_logits(params, x, cfg, tp), cache


# ---------------------------------------------------------------------------
# trainability and re-wrapping
# ---------------------------------------------------------------------------

def _module_of(names: Tuple[str, ...]) -> Optional[str]:
    """Innermost logical-module name on a param path, the leaf name
    excluded (PSOFT's "q" param would otherwise shadow the "q" module)."""
    for n in reversed(names[:-1]):
        if n in _MODULE_NAMES:
            return n
    return None


def trainable_mask(cfg: ModelConfig, params: Params,
                   full_finetune: bool = False):
    """Per-leaf trainability (the same tree of bools, lists included),
    resolved per module through the registry: a leaf trains when its key
    is one of its module's method's ``trainable_names``."""
    def one(path, _leaf):
        if full_finetune:
            return True
        module = _module_of(path)
        method = cfg.peft.method_for(module) if module else "none"
        return path[-1] in peft_lib.trainable_names(method, cfg.peft)
    return tree_map_with_path(one, params)


# ---------------------------------------------------------------------------
# logical sharding axes of the param and cache trees
# ---------------------------------------------------------------------------

#: row-parallel linears (the reduction dim is the output's); every other
#: module name is column-parallel
_ROW_PAR = frozenset(("o", "down", "out_proj"))


def _leaf_role_axes(path: Tuple[str, ...], leaf, cfg: ModelConfig) -> Tuple:
    """The logical axes of one unstacked leaf from its path: embeddings,
    norms and SSM scalars by name, a linear's params through its module's
    registered method (``fsdp`` on the reduction dim, ``tensor`` on the
    other)."""
    leaf_name = path[-1]
    module = path[-2] if len(path) >= 2 else ""
    if module == "embed" and leaf_name == "w":
        return ("vocab", "fsdp")
    if module == "lm_head" and leaf_name == "w":
        return ("fsdp", "vocab")
    if leaf_name in ("scale", "bias", "a_log", "d_skip", "dt_bias", "conv_b",
                     "marker"):
        return (None,)
    if leaf_name == "conv_w":
        return (None, None)
    lin_module = _module_of(path)
    in_ax, out_ax = (("tensor", "fsdp") if lin_module in _ROW_PAR
                     else ("fsdp", "tensor"))
    method = cfg.peft.method_for(lin_module) if lin_module else "none"
    role = registry.get_method(method).logical_axes(cfg.peft, in_ax, out_ax)
    if leaf_name in role:
        return role[leaf_name]
    if leaf_name == "w":   # plain / merged linear under a PEFT-enabled config
        return (in_ax, out_ax)
    # param tree and config disagree (e.g. a foreign checkpoint): any
    # registered method that knows this param name at this rank
    for m in registry.available_methods():
        ax = registry.get_method(m).logical_axes(cfg.peft, in_ax, out_ax)
        if leaf_name in ax and len(ax[leaf_name]) <= leaf.ndim:
            return ax[leaf_name]
    return (None,) * leaf.ndim


class LogicalAxes:
    """Tuple-like logical axis names of one leaf; a leaf of the port's
    trees (a tuple would be walked)."""
    __slots__ = ("axes",)

    def __init__(self, axes):
        self.axes = tuple(axes)

    def __iter__(self):
        return iter(self.axes)

    def __len__(self):
        return len(self.axes)

    def __getitem__(self, i):
        return self.axes[i]

    def __repr__(self):
        return f"LogicalAxes{self.axes}"

    def __eq__(self, other):
        return tuple(self) == tuple(other)

    def __hash__(self):
        return hash(self.axes)


def param_axes(cfg: ModelConfig, params: Params):
    """Logical sharding axes, a tree parallel to ``params`` (real or meta
    tensors; a hybrid's list of layers too) of :class:`LogicalAxes`: the
    leaf's role axes behind ``None`` for its stack dims, the innermost of
    which is ``"expert"`` for an MoE expert stack."""
    def assign(path, leaf):
        role = _leaf_role_axes(path, leaf, cfg)
        extra = leaf.ndim - len(role)
        if extra < 0:
            return LogicalAxes((None,) * leaf.ndim)
        lead = [None] * extra
        if extra >= 1 and "moe" in path and "shared" not in path \
                and path[-2] in moe_lib.EXPERT_LINEARS:
            lead[-1] = "expert"
        return LogicalAxes(tuple(lead) + tuple(role))
    return tree_map_with_path(assign, params)


def cache_axes(cfg: ModelConfig, cache):
    """Logical sharding axes of a decode cache tree (the dense cache; a
    paged pool's page axis would read as ``"batch"``, as in the
    reference).  They place the whole cache, as the reference's do: a
    serving split's rank computes from its own blocks of the Mamba2 states
    (:func:`init_cache`), ``ssm_state``'s heads as placed here but
    ``conv_state``'s channels ``[x_r, B_g, C_g]``, not this even cut of
    ``conv_ch`` (which would part a head's channels from its B and C);
    the ranks' blocks put back in channel order are the whole cache."""
    def assign(path, leaf):
        n = path[-1]
        if n == "page_table":
            role = (None,) * leaf.ndim
        elif n in ("k", "v"):
            role = ("batch", "cache_seq", "kv_heads", None)
        elif n == "conv_state":
            role = ("batch", None, "conv_ch")
        elif n == "ssm_state":
            role = ("batch", "heads", None, None)
        elif n == "len":
            role = ()
        else:
            role = (None,) * leaf.ndim
        extra = leaf.ndim - len(role)
        return LogicalAxes((None,) * max(extra, 0) + tuple(role))
    return tree_map_with_path(assign, cache)


def abstract_params(cfg: ModelConfig) -> Params:
    """:func:`init_params`'s tree as meta tensors: every leaf's shape and
    dtype at any size, with no memory allocated, no draw and no SVD (on the
    meta device an op only infers its outputs' shapes)."""
    return init_params(cfg, device="meta")


def count_params(params) -> int:
    """Elements over every leaf of a tree (meta or real; ``None`` leaves,
    as in a train state's split trees, count nothing)."""
    return sum(int(t.numel()) for t in tree_leaves(params))


def count_trainable(cfg: ModelConfig, params: Params) -> int:
    """Elements over the leaves :func:`trainable_mask` trains."""
    mask = trainable_mask(cfg, params)
    return sum(int(t.numel()) for t, m in zip(tree_leaves(params),
                                              tree_leaves(mask)) if m)


def rewrap_peft(merged_params: Params, cfg: ModelConfig) -> Params:
    """Wrap every plain ``{"w"}`` linear of a merged or pre-trained tree
    with the ``cfg.peft`` structure (PSOFT: the SVD split), layer stacks
    in one batched call and expert stacks one layer at a time: the "load a
    checkpoint, attach PSOFT" entry.  As in the reference, an untargeted
    linear goes through the ``"none"`` method, which casts it to
    ``param_dtype``: the MoE router too (``moe_apply`` reads it in fp32
    either way).  A router in ``target_modules`` raises: ``moe_apply``
    reads its weight directly, so a wrapped router could not route."""
    pdt, edt = torch_dtype(cfg.param_dtype), torch_dtype(cfg.peft_dtype)

    def one(node, path):
        if set(node) == {"w"} and node["w"].ndim >= 2 and path \
                and path[-1] in _MODULE_NAMES:
            module = path[-1]
            if module == "router" and cfg.peft.is_target(module):
                raise ValueError(
                    f"rewrap_peft: target module 'router' "
                    f"({'/'.join(path)}) cannot be PEFT-wrapped: moe_apply "
                    f"reads the router's weight directly; drop 'router' "
                    f"from target_modules")
            return peft_lib.init_linear(None, node["w"], cfg.peft,
                                        cfg.peft.is_target(module), pdt, edt,
                                        module=module)
        return None
    return map_dicts(one, merged_params)
