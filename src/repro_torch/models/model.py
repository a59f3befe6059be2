"""Decoder of the port, dense and MoE: init, the training forward and loss,
paged prefill and paged decode, and the PEFT trainability mask.

Params are nested dicts of tensors in the reference's scan-stacked layout:
every per-layer leaf has a leading ``(L, ...)`` axis, so a reference tree
converts 1:1 (:mod:`repro_torch.interop`).  A Python loop over the layer
axis takes the place of ``lax.scan``.  Banked serve linears take the
engine's per-row ``adapter_ids``, threaded explicitly through every call.
The training forward builds every PSOFT, OFT and BOFT layer stack's
rotations once per call (one ``cayley_neumann`` launch per stack), outside
the per-layer recompute boundary, so remat does not build them twice.
An MoE block holds ``"moe"`` (:mod:`repro_torch.models.moe`) where a dense
one holds ``"mlp"``; training dispatches tokens with capacity, serving and
logits run every expert on every token (``moe_impl``), as the reference
does.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils import checkpoint as torch_checkpoint

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig, torch_dtype
from repro_torch.core import peft as peft_lib
from repro_torch.core import registry
from repro_torch.models import attention, layers
from repro_torch.models import moe as moe_lib

Params = Dict[str, Any]

_MLP = ("up", "down", "gate")
_ATTN = ("q", "k", "v", "o")
#: logical module names a param path of the decoder can name (the router
#: names a module, as in the reference, but is never PEFT-wrapped)
_MODULE_NAMES = frozenset(_ATTN + _MLP + ("router",))


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


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda") -> Params:
    """Random decoder params (dense or MoE) from ``seed`` (a
    ``torch.Generator`` on ``device``), PEFT-wrapped per ``cfg.peft`` (any
    registered method); the SVD methods (PSOFT, PiSSA, LoRA-XS) split each
    linear stack by one batched fp32 SVD, on ``device``, and each MoE
    expert stack one layer at a time."""
    if cfg.family not in ("dense", "moe"):
        raise ValueError(f"the port builds the dense and MoE families only, "
                         f"not {cfg.family!r}")
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    pdt, edt = torch_dtype(cfg.param_dtype), torch_dtype(cfg.peft_dtype)
    nl, d, f = cfg.num_layers, cfg.d_model, cfg.d_ff
    h, kh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    targets = cfg.peft.target_modules
    shapes = {"q": (d, h * hd), "k": (d, kh * hd), "v": (d, kh * hd),
              "o": (h * hd, d)}
    p: Params = {
        "embed": {"w": layers.truncated_normal_init(
            gen, (cfg.padded_vocab_size, d), pdt, dev)},
        "final_norm": layers.norm_init(d, cfg.norm_type, pdt, dev),
        "layers": {
            "ln1": layers.norm_init(d, cfg.norm_type, pdt, dev, (nl,)),
            "attn": {n: _linear_init(gen, cfg, (nl,) + shapes[n], n, pdt,
                                     edt, targets, dev) for n in _ATTN},
            "ln2": layers.norm_init(d, cfg.norm_type, pdt, dev, (nl,)),
        },
    }
    if cfg.family == "moe":
        p["layers"]["moe"] = moe_lib.moe_init(gen, cfg, pdt, edt, targets,
                                              dev, nl)
    else:
        p["layers"]["mlp"] = mlp_init(gen, cfg, f, pdt, edt, targets, dev,
                                      (nl,))
    if not cfg.tie_embeddings:
        p["lm_head"] = {"w": layers.truncated_normal_init(
            gen, (d, cfg.padded_vocab_size), pdt, dev)}
    return p


def init_cache(cfg: ModelConfig, batch: int, max_len: int, page_size: int,
               num_pages: Optional[int] = None, device="cuda"
               ) -> Dict[str, torch.Tensor]:
    """Block-paged KV pools ``{"k","v"}: (L, num_pages, page_size, KH, hd)``
    in the compute dtype.  Page 0 is the reserved trash page; ``num_pages``
    defaults to dense-equivalent capacity plus the trash page."""
    if num_pages is None:
        num_pages = 1 + batch * -(-max_len // page_size)
    shape = (cfg.num_layers, num_pages, page_size, cfg.num_kv_heads,
             cfg.resolved_head_dim)
    dev = resolve_device(device)
    cdt = torch_dtype(cfg.dtype)
    return {"k": torch.zeros(shape, dtype=cdt, device=dev),
            "v": torch.zeros(shape, dtype=cdt, device=dev)}


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def _lin(params, x, cfg, cdt, module, adapter_ids):
    return peft_lib.apply_linear(params, x, cfg.peft, cdt, module=module,
                                 adapter_ids=adapter_ids)


def mlp_apply(params: Params, x: torch.Tensor, cfg: ModelConfig, cdt,
              adapter_ids=None) -> torch.Tensor:
    act = layers.mlp_activation(cfg.mlp_type)
    up = _lin(params["up"], x, cfg, cdt, "up", adapter_ids)
    if "gate" in params:
        g = _lin(params["gate"], x, cfg, cdt, "gate", adapter_ids)
        h = act(g.float()).to(cdt) * up
    else:
        h = act(up.float()).to(cdt)
    return _lin(params["down"], h, cfg, cdt, "down", adapter_ids)


def _qkv(params, x, cfg: ModelConfig, cdt, positions, adapter_ids):
    h, kh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    b, s = x.shape[:2]
    q = _lin(params["q"], x, cfg, cdt, "q", adapter_ids).reshape(b, s, h, hd)
    k = _lin(params["k"], x, cfg, cdt, "k", adapter_ids).reshape(b, s, kh, hd)
    v = _lin(params["v"], x, cfg, cdt, "v", adapter_ids).reshape(b, s, kh, hd)
    q = layers.apply_rope(q, positions, cfg.rope_theta)
    k = layers.apply_rope(k, positions, cfg.rope_theta)
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


def _block(lp, x, cfg, cdt, attn_fn, adapter_ids, moe_impl="dense"):
    """(y, the layer's MoE aux loss, or None for a dense layer)."""
    h = layers.apply_norm(lp["ln1"], x)
    x = x + attn_fn(lp["attn"], h)
    h = layers.apply_norm(lp["ln2"], x)
    if "moe" in lp:
        m, aux = moe_lib.moe_apply(lp["moe"], h, cfg, cdt, moe_impl)
        return x + m, aux
    return x + mlp_apply(lp["mlp"], h, cfg, cdt, adapter_ids), None


def attn_apply(params, x, cfg: ModelConfig, cdt, positions) -> torch.Tensor:
    """Full-sequence causal attention of one layer (the training path)."""
    q, k, v = _qkv(params, x, cfg, cdt, positions, None)
    out = attention.chunked_attention(q, k, v, causal=True)
    return _lin(params["o"], out.reshape(*x.shape[:-1], -1), cfg, cdt, "o",
                None)


def _train_block(lp, cfg, cdt, positions, moe_impl, x):
    def attn_fn(ap, h):
        return attn_apply(ap, h, cfg, cdt, positions)
    return _block(lp, x, cfg, cdt, attn_fn, None, moe_impl)


def _remat(fn, cfg: ModelConfig):
    """``remat_policy`` "full": recompute the layer in the backward
    (non-reentrant checkpoint); "none": keep its activations."""
    if cfg.remat_policy == "none":
        return fn
    if cfg.remat_policy == "full":
        return functools.partial(torch_checkpoint.checkpoint, fn,
                                 use_reentrant=False,
                                 preserve_rng_state=False)
    raise ValueError(f"remat_policy {cfg.remat_policy!r} is not ported "
                     f"(the port has 'none' and 'full')")


def _with_rotations(tree, cfg: ModelConfig, path: Tuple[str, ...] = ()):
    """``tree`` with every rotation a PEFT linear builds ahead (PSOFT's
    r x r rotation, the OFT/BOFT Cayley blocks (L, d/b, b, b) or
    (L, m, d/b, b, b)) under ``"rot"``: one ``cayley_neumann`` call per
    layer stack."""
    if isinstance(tree, dict):
        if peft_lib.is_peft_linear(tree):
            method = registry.resolve(tree, cfg.peft,
                                      module=path[-1] if path else None)
            rot = method.rotations(tree, cfg.peft)
            return tree if rot is None else {**tree, "rot": rot}
        return {k: _with_rotations(v, cfg, path + (k,))
                for k, v in tree.items()}
    return tree


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def forward_hidden(params: Params, batch: Dict[str, torch.Tensor],
                   cfg: ModelConfig, moe_impl: str = "capacity"
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(final-norm hidden states (B, S, D) of ``batch["tokens"]`` (B, S),
    the MoE aux loss summed over layers (0 for a dense model)): causal
    chunked attention, one remat boundary per layer."""
    cdt = torch_dtype(cfg.dtype)
    x = layers.embed_lookup(params["embed"], batch["tokens"], cdt)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    stack = _with_rotations(params["layers"], cfg)
    block = _remat(functools.partial(_train_block, cfg=cfg, cdt=cdt,
                                     positions=positions,
                                     moe_impl=moe_impl), cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(cfg.num_layers):
        x, layer_aux = block(_layer(stack, i), x=x)
        if layer_aux is not None:
            aux = aux + layer_aux
    return layers.apply_norm(params["final_norm"], x), aux


def chunked_ce_loss(params: Params, h: torch.Tensor, labels: torch.Tensor,
                    cfg: ModelConfig, loss_chunk: int = 1024
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean next-token cross-entropy over sequence chunks (the full
    (B, S, V) logits never exist at once); labels < 0 carry no loss.
    Returns (loss, token count)."""
    b, s, _ = h.shape
    loss_chunk = min(loss_chunk, s)
    while s % loss_chunk:
        loss_chunk -= 1
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    cnt = torch.zeros((), dtype=torch.int32, device=h.device)
    for c0 in range(0, s, loss_chunk):
        logits = lm_logits(params, h[:, c0:c0 + loss_chunk], cfg).float()
        ll = labels[:, c0:c0 + loss_chunk].long()
        mask = ll >= 0
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, ll.clamp_min(0)[..., None])[..., 0]
        tot = tot + ((lse - gold) * mask).sum()
        cnt = cnt + mask.sum(dtype=torch.int32)
    return tot / cnt.clamp_min(1), cnt


def loss_fn(params: Params, batch: Dict[str, torch.Tensor],
            cfg: ModelConfig, moe_impl: str = "capacity"
            ) -> Tuple[torch.Tensor, Dict]:
    """(loss, {"loss", "aux", "tokens"}) of a token batch with labels; an
    MoE model adds ``aux_loss_weight`` times its aux loss."""
    h, aux = forward_hidden(params, batch, cfg, moe_impl)
    loss, n_tok = chunked_ce_loss(params, h, batch["labels"], cfg)
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
              cfg: ModelConfig) -> torch.Tensor:
    cdt = torch_dtype(cfg.dtype)
    w = params["embed"]["w"].T if cfg.tie_embeddings \
        else params["lm_head"]["w"]
    return h.to(cdt) @ w.to(cdt)


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
    cdt = torch_dtype(cfg.dtype)
    x = layers.embed_lookup(params["embed"], batch["tokens"], cdt)
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


def decode_step(params: Params, batch: Dict[str, torch.Tensor],
                cache: Dict[str, torch.Tensor], pos, cfg: ModelConfig, *,
                adapter_ids: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token serve step.  ``batch["tokens"]`` (B, 1); ``pos`` a scalar
    or (B,) per-slot positions; ``cache``: pools plus ``"page_table"``
    (shared by every layer).  Pools are updated in place.  Returns
    (logits (B, 1, V), cache)."""
    cdt = torch_dtype(cfg.dtype)
    x = layers.embed_lookup(params["embed"], batch["tokens"], cdt)
    b = x.shape[0]
    positions = torch.as_tensor(pos, device=x.device).long()
    if positions.ndim == 0:
        positions = positions.expand(b)
    pt = cache["page_table"]
    for i in range(cfg.num_layers):
        kv = {"k": cache["k"][i], "v": cache["v"][i]}

        def attn_fn(ap, h, kv=kv):
            return attn_decode(ap, h, cfg, cdt, positions, kv, pt,
                               adapter_ids)
        x, _ = _block(_layer(params["layers"], i), x, cfg, cdt, attn_fn,
                      adapter_ids, "dense")
    x = layers.apply_norm(params["final_norm"], x)
    return lm_logits(params, x, cfg), cache


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
    """Per-leaf trainability (the same tree of bools), resolved per module
    through the registry: a leaf trains when its key is one of its
    module's method's ``trainable_names``."""
    def rec(node, path):
        if isinstance(node, dict):
            return {k: rec(v, path + (k,)) for k, v in node.items()}
        if full_finetune:
            return True
        module = _module_of(path)
        method = cfg.peft.method_for(module) if module else "none"
        return path[-1] in peft_lib.trainable_names(method, cfg.peft)
    return rec(params, ())


def rewrap_peft(merged_params: Params, cfg: ModelConfig) -> Params:
    """Wrap every plain ``{"w"}`` linear of a merged or pre-trained tree
    with the ``cfg.peft`` structure (PSOFT: the SVD split), layer stacks
    in one batched call and expert stacks one layer at a time: the "load a
    checkpoint, attach PSOFT" entry.  The MoE router stays as it is (fp32,
    never wrapped: ``moe_apply`` reads its weight directly)."""
    pdt, edt = torch_dtype(cfg.param_dtype), torch_dtype(cfg.peft_dtype)

    def rec(node, path):
        if isinstance(node, dict) and set(node) == {"w"} and \
                node["w"].ndim >= 2 and path and path[-1] in _MODULE_NAMES \
                and path[-1] != "router":
            module = path[-1]
            return peft_lib.init_linear(None, node["w"], cfg.peft,
                                        cfg.peft.is_target(module), pdt, edt,
                                        module=module)
        if isinstance(node, dict):
            return {k: rec(v, path + (k,)) for k, v in node.items()}
        return node
    return rec(merged_params, ())
