"""Mamba2 SSD (state-space duality) block of the port: the chunked training
and prefill scan and the O(1)-state decode step.

The reference computes the scan in plain ``jnp`` under XLA (it has no
Pallas kernel for it), and so does the port in plain torch.  Every chunk is
one iteration of a Python loop over ``lax.scan``'s chunks: within a chunk
the output is the matmul ("attention") form, ``(C Bᵀ ∘ L) · x̄`` with
``L[i, j] = exp(cum_i − cum_j)`` for ``i ≥ j``, and one recurrence over
chunk states carries the rest.  All of it runs in fp32; ``y`` is cast back
to ``x``'s dtype.  The intra-chunk term contracts ``C Bᵀ ∘ L`` (B, Q, Q, H)
with ``x̄`` and never forms the (B, Q, Q, H, P) product.

One deliberate difference: ``L``'s exponent is masked before the ``exp``
(the reference masks after it).  The forward values are the same, but the
reference's masked-out entries ``exp(cum_i − cum_j)``, ``i < j``, overflow
to ``inf`` over a chunk of realistic decays, and the gradient of
``where(mask, inf, 0)`` is ``0 · inf = NaN``: the reference's training
gradients through the scan are NaN, the port's are finite.

Params follow the reference's layout (``in_proj`` and ``out_proj`` PEFT
linears, ``conv_w``, ``conv_b``, ``a_log``, ``d_skip``, ``dt_bias`` and the
gated ``norm``), with any leading (layer-stack) dims.  Banked serve
linears take the engine's per-row ``adapter_ids``; a decode step applies
``in_proj`` and ``out_proj`` to 2-D ``(B, d)`` rows, which
:func:`repro_torch.core.registry.apply_batched` sends through the
gather-delta wrapper.

Under a serving split over ``model`` that splits the mixer
(:attr:`repro_torch.distributed.tensor_parallel.TensorParallel.mixer`) a
rank computes H / n SSM heads (:func:`split_dims`) from its view of the
params (:func:`local_mixer`): ``in_proj``'s columns of its z, x and dt
heads and of the B and C groups those heads read, the conv's channels
``[x_r, B_g, C_g]``, its heads of ``a_log``, ``d_skip``, ``dt_bias`` and
the norm, and ``out_proj``'s rows of its ``d_inner`` slice, summed over
ranks.  The gated RMSNorm over the whole ``d_inner`` sums the ranks' fp32
sums of squares (:func:`split_norm`).  Its decode states are its heads of
``ssm_state`` and its ``[x_r, B_g, C_g]`` channels of ``conv_state``;
:func:`gather_state_blocks` puts the ranks' blocks back together as the
whole states.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core import peft as peft_lib
from repro_torch.core import registry
from repro_torch.distributed import collectives, tensor_parallel
from repro_torch.models import layers

Params = Dict[str, torch.Tensor]


def ssm_dims(cfg: ModelConfig) -> Dict[str, int]:
    d_inner = cfg.ssm.expand * cfg.d_model
    heads = d_inner // cfg.ssm.head_dim
    g, n = cfg.ssm.ngroups, cfg.ssm.state_size
    conv_ch = d_inner + 2 * g * n
    in_proj_out = 2 * d_inner + 2 * g * n + heads  # z, x, B, C, dt
    return dict(d_inner=d_inner, heads=heads, g=g, n=n, conv_ch=conv_ch,
                in_proj_out=in_proj_out)


def split_dims(cfg: ModelConfig, rank: int, size: int) -> Dict[str, int]:
    """:func:`ssm_dims` of a rank's share of the mixer under a serving
    split over ``size`` ranks, plus ``head0`` and ``group0``, its first
    head and group: H / n heads from ``rank * H / n`` and the groups they
    read (g / n of them where the groups divide over the ranks, else the
    one group all its heads map to)."""
    d = ssm_dims(cfg)
    h, n = d["heads"] // size, d["n"]
    g = max(d["g"] // size, 1)
    head0 = rank * h
    d_inner = h * cfg.ssm.head_dim
    return dict(d_inner=d_inner, heads=h, g=g, n=n,
                conv_ch=d_inner + 2 * g * n,
                in_proj_out=2 * d_inner + 2 * g * n + h, head0=head0,
                group0=head0 // (d["heads"] // d["g"]))


def _column_blocks(cfg: ModelConfig, rank: int, size: int
                   ) -> Sequence[Tuple[int, int]]:
    """(first column, columns) of each of the rank's z, x, B, C and dt
    blocks in ``in_proj``'s output."""
    whole, d = ssm_dims(cfg), split_dims(cfg, rank, size)
    di, gn = whole["d_inner"], whole["g"] * whole["n"]
    x0, g0 = d["head0"] * cfg.ssm.head_dim, d["group0"] * d["n"]
    gl = d["g"] * d["n"]
    return ((x0, d["d_inner"]), (di + x0, d["d_inner"]), (2 * di + g0, gl),
            (2 * di + gn + g0, gl), (2 * di + 2 * gn + d["head0"], d["heads"]))


def _index(blocks, offset: int, device) -> torch.Tensor:
    return torch.cat([torch.arange(a - offset, a - offset + n, device=device)
                      for a, n in blocks])


def in_proj_columns(cfg: ModelConfig, rank: int, size: int,
                    device=None) -> torch.Tensor:
    """The columns of ``in_proj``'s output a rank computes, in its order
    ``[z_r, x_r, B_g, C_g, dt_r]``."""
    return _index(_column_blocks(cfg, rank, size), 0, device)


def conv_channels(cfg: ModelConfig, rank: int, size: int,
                  device=None) -> torch.Tensor:
    """The conv channels a rank computes, ``[x_r, B_g, C_g]``."""
    return _index(_column_blocks(cfg, rank, size)[1:4],
                  ssm_dims(cfg)["d_inner"], device)


def local_mixer(params: Params, cfg: ModelConfig, tp) -> Params:
    """A rank's view of a Mamba2 mixer (or a layer stack of them) under a
    serving split ``tp`` that splits it: ``in_proj`` cut to
    :func:`in_proj_columns` (a copy), ``conv_w`` and ``conv_b`` to
    :func:`conv_channels` (copies), ``a_log``, ``d_skip``, ``dt_bias`` and
    the norm's scale to the rank's heads and ``out_proj`` to its rows
    (views; ``out_proj`` stays whole where it is ``"gathered_row"``)."""
    d = split_dims(cfg, tp.rank, tp.size)
    dev = params["conv_w"].device
    p = cfg.ssm.head_dim
    chans = conv_channels(cfg, tp.rank, tp.size, dev)
    out = dict(params)
    out["in_proj"] = tensor_parallel.column_set(
        params["in_proj"], registry.resolve(params["in_proj"], cfg.peft,
                                            module="in_proj"),
        cfg.peft, in_proj_columns(cfg, tp.rank, tp.size, dev))
    out["conv_w"] = params["conv_w"].index_select(-1, chans)
    out["conv_b"] = params["conv_b"].index_select(-1, chans)
    for name in ("a_log", "d_skip", "dt_bias"):
        out[name] = params[name].narrow(-1, d["head0"], d["heads"])
    out["norm"] = {"scale": params["norm"]["scale"].narrow(
        -1, d["head0"] * p, d["d_inner"])}
    if tp.kinds["out_proj"] == "row":
        out["out_proj"] = tensor_parallel.local_params(
            params["out_proj"], registry.resolve(
                params["out_proj"], cfg.peft, module="out_proj"),
            cfg.peft, "row", tp.rank, tp.size)
    return out


def gather_state_blocks(cfg: ModelConfig, blocks: Sequence[Params]
                        ) -> Params:
    """The whole decode states ``{"conv_state", "ssm_state"}`` from every
    rank's blocks, in rank order: the heads of ``ssm_state`` concatenated,
    and ``conv_state``'s channels put back in order ``[x, B, C]`` (ranks
    that read the same group hold the same B and C)."""
    size = len(blocks)
    xs, bs, cs = [], {}, {}
    for r, blk in enumerate(blocks):
        d = split_dims(cfg, r, size)
        gl = d["g"] * d["n"]
        x, b, c = torch.split(blk["conv_state"], [d["d_inner"], gl, gl], -1)
        xs.append(x)
        bs.setdefault(d["group0"], b)
        cs.setdefault(d["group0"], c)
    return {"conv_state": torch.cat(xs + [bs[k] for k in sorted(bs)]
                                    + [cs[k] for k in sorted(cs)], -1),
            "ssm_state": torch.cat([b["ssm_state"] for b in blocks], -3)}


def _dims(cfg: ModelConfig, tp) -> Dict[str, int]:
    """The mixer's dims a rank computes: its share under a split ``tp``
    that splits the mixer, else the whole."""
    if tp is not None and tp.mixer:
        return split_dims(cfg, tp.rank, tp.size)
    return ssm_dims(cfg)


def _split_in_proj(zxbcdt: torch.Tensor, d: Dict[str, int]):
    """(z, x, B, C, dt) along the last axis of ``in_proj``'s output at the
    dims ``d``."""
    gn = d["g"] * d["n"]
    return torch.split(zxbcdt, [d["d_inner"], d["d_inner"], gn, gn,
                                d["heads"]], dim=-1)


def causal_conv(x: torch.Tensor, w: torch.Tensor,
                b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv and SiLU.  x (B, S, C); w (K, C); b (C,)."""
    k, s = w.shape[0], x.shape[1]
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(k):
        shift = k - 1 - i
        xi = F.pad(x, (0, 0, shift, 0))[:, :s]
        out = out + xi.float() * w[i].float()
    return F.silu(out + b.float()).to(x.dtype)


def conv_step(x_t: torch.Tensor, conv_state: torch.Tensor, w: torch.Tensor,
              b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x_t (B, C); conv_state (B, K-1, C) past inputs.  Returns (y_t, the
    new state)."""
    window = torch.cat([conv_state, x_t[:, None, :]], dim=1)   # (B, K, C)
    y = torch.einsum("bkc,kc->bc", window.float(), w.float())
    y = F.silu(y + b.float()).to(x_t.dtype)
    return y, window[:, 1:]


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
                bmat: torch.Tensor, cmat: torch.Tensor, d_skip: torch.Tensor,
                dt_bias: torch.Tensor, chunk: int,
                initial_state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """SSD forward.  x (B, S, H, P); dt (B, S, H); a_log (H,); bmat, cmat
    (B, S, G, N); d_skip (H,).  Returns y (B, S, H, P) in x's dtype and the
    final state (B, H, N, P) in fp32.  ``chunk`` is cut to ``S`` and must
    then divide it."""
    bsz, s, h, p = x.shape
    g, n = bmat.shape[2], bmat.shape[3]
    rep = h // g
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"ssd_chunked: sequence length {s} is not a "
                         f"multiple of the chunk {chunk}")
    dev = x.device
    dt = F.softplus(dt.float() + dt_bias.float())              # (B, S, H)
    a = -torch.exp(a_log.float())                              # (H,) < 0
    da = dt * a                                                # (B, S, H)
    xbar = x.float() * dt[..., None]                           # (B, S, H, P)
    bf, cf = bmat.float(), cmat.float()
    iq = torch.arange(chunk, device=dev)
    causal = (iq[:, None] >= iq[None, :])[None, :, :, None]    # (1,Q,Q,1)
    hprev = torch.zeros((bsz, h, n, p), dtype=torch.float32, device=dev) \
        if initial_state is None else initial_state.float()
    ys = []
    for c0 in range(0, s, chunk):
        sl = slice(c0, c0 + chunk)
        da_q, xb_q, b_q, c_q = da[:, sl], xbar[:, sl], bf[:, sl], cf[:, sl]
        cum = torch.cumsum(da_q, dim=1)                        # (B, Q, H)
        total = cum[:, -1]                                     # (B, H)
        # intra-chunk: L[i, j] = exp(cum_i - cum_j) for i >= j, the exponent
        # masked first so that the masked entries are exp(-inf) = 0 with a
        # zero gradient
        expo = (cum[:, :, None, :] - cum[:, None, :, :]).masked_fill(
            ~causal, -math.inf)
        cb = torch.einsum("bqgn,bkgn->bqkg", c_q, b_q)         # (B, Q, Q, G)
        cb = torch.repeat_interleave(cb, rep, dim=-1)          # (B, Q, Q, H)
        y_intra = torch.einsum("bqkh,bkhp->bqhp", cb * torch.exp(expo),
                               xb_q)
        # inter-chunk: y += exp(cum) C . h_prev
        c_h = torch.repeat_interleave(c_q, rep, dim=2)         # (B, Q, H, N)
        y_inter = torch.einsum("bqhn,bhnp->bqhp",
                               c_h * torch.exp(cum)[..., None], hprev)
        # the carry into the next chunk
        decay_r = torch.exp(total[:, None, :] - cum)           # (B, Q, H)
        b_h = torch.repeat_interleave(b_q, rep, dim=2)         # (B, Q, H, N)
        st = torch.einsum("bqhn,bqhp->bhnp", b_h * decay_r[..., None], xb_q)
        hprev = hprev * torch.exp(total)[..., None, None] + st
        ys.append(y_intra + y_inter)
    y = torch.cat(ys, dim=1) + x.float() * d_skip.float()[None, None, :,
                                                          None]
    return y.to(x.dtype), hprev


def ssd_step(x_t: torch.Tensor, dt_t: torch.Tensor, a_log: torch.Tensor,
             b_t: torch.Tensor, c_t: torch.Tensor, d_skip: torch.Tensor,
             dt_bias: torch.Tensor, state: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-token SSD recurrence.  x_t (B, H, P); dt_t (B, H); b_t, c_t
    (B, G, N); state (B, H, N, P) fp32."""
    h, g = x_t.shape[1], b_t.shape[1]
    rep = h // g
    dt = F.softplus(dt_t.float() + dt_bias.float())            # (B, H)
    a = -torch.exp(a_log.float())
    decay = torch.exp(dt * a)
    b_h = torch.repeat_interleave(b_t.float(), rep, dim=1)     # (B, H, N)
    c_h = torch.repeat_interleave(c_t.float(), rep, dim=1)
    xbar = x_t.float() * dt[..., None]                         # (B, H, P)
    new_state = state.float() * decay[..., None, None] \
        + b_h[..., :, None] * xbar[..., None, :]               # (B,H,N,P)
    y = torch.einsum("bhn,bhnp->bhp", c_h, new_state)
    y = y + x_t.float() * d_skip.float()[None, :, None]
    return y.to(x_t.dtype), new_state


# ---------------------------------------------------------------------------
# the Mamba2 block
# ---------------------------------------------------------------------------

def mamba_block_init(generator, cfg: ModelConfig, param_dtype, peft_dtype,
                     wrapped_in: bool, wrapped_out: bool, device,
                     lead: Sequence[int] = ()) -> Params:
    """One Mamba2 block (or ``lead`` stacked ones): the projections drawn
    in fp32 and PEFT-wrapped where ``wrapped_*`` (PSOFT's SVD split runs
    once per stack)."""
    d = ssm_dims(cfg)
    lead = tuple(lead)
    w_in = layers.truncated_normal_init(
        generator, lead + (cfg.d_model, d["in_proj_out"]), torch.float32,
        device)
    w_out = layers.truncated_normal_init(
        generator, lead + (d["d_inner"], cfg.d_model), torch.float32, device)
    heads = d["heads"]
    a_log = torch.log(torch.linspace(1.0, 16.0, heads, dtype=torch.float32,
                                     device=device))
    return {
        "in_proj": peft_lib.init_linear(generator, w_in, cfg.peft, wrapped_in,
                                        param_dtype, peft_dtype,
                                        module="in_proj"),
        "out_proj": peft_lib.init_linear(generator, w_out, cfg.peft,
                                         wrapped_out, param_dtype,
                                         peft_dtype, module="out_proj"),
        "conv_w": layers.truncated_normal_init(
            generator, lead + (cfg.ssm.conv_width, d["conv_ch"]),
            param_dtype, device, 2.0),
        "conv_b": torch.zeros(lead + (d["conv_ch"],), dtype=param_dtype,
                              device=device),
        "a_log": a_log.expand(lead + (heads,)).clone(),
        "d_skip": torch.ones(lead + (heads,), dtype=torch.float32,
                             device=device),
        "dt_bias": torch.zeros(lead + (heads,), dtype=torch.float32,
                               device=device),
        "norm": layers.norm_init(d["d_inner"], "rmsnorm", param_dtype,
                                 device, lead),
    }


def _lin(params, x, cfg, cdt, module, adapter_ids):
    return peft_lib.apply_linear(params, x, cfg.peft, cdt, module=module,
                                 adapter_ids=adapter_ids)


def split_norm(params: Params, x: torch.Tensor, width: int, tp,
               eps: float = 1e-6) -> torch.Tensor:
    """:func:`layers.apply_norm`'s RMSNorm over a last axis of ``width``
    split over ``model``: the rank's fp32 sum of squares summed over the
    ranks (one all-reduce of (tokens, 1), tag ``"ssm_norm"``), divided by
    the whole ``width``; ``params`` hold the rank's slice of the scale."""
    x32 = x.float()
    ss = x32.square().sum(-1, keepdim=True)
    collectives.all_reduce(ss, tp.mesh, (tensor_parallel.AXIS,),
                           tag="ssm_norm")
    y = x32 * torch.rsqrt(ss / width + eps) * params["scale"].float()
    return y.to(x.dtype)


def _gate_out(params, y, z, cfg, cdt, adapter_ids, tp=None):
    """norm(y * silu(z)) through ``out_proj``; under a split ``tp`` that
    splits the mixer, the rank's heads normed over the whole ``d_inner``
    and ``out_proj``'s partial rows summed over ranks (its input gathered
    first where it is ``"gathered_row"``)."""
    y = y * F.silu(z.float()).to(y.dtype)
    if tp is None or not tp.mixer:
        return _lin(params["out_proj"], layers.apply_norm(params["norm"], y),
                    cfg, cdt, "out_proj", adapter_ids)
    y = split_norm(params["norm"], y, ssm_dims(cfg)["d_inner"], tp)
    kind = tp.kinds["out_proj"]
    if kind == "gathered_row":
        y = collectives.gather_from(y, tp.mesh, tensor_parallel.AXIS, -1)
    y = _lin(params["out_proj"], y, cfg, cdt, "out_proj", adapter_ids)
    if kind == "row":
        y = collectives.reduce_from(y, tp.mesh, tensor_parallel.AXIS)
    return y


def mamba_block_apply(params: Params, u: torch.Tensor, cfg: ModelConfig,
                      cdt, return_cache: bool = False, adapter_ids=None,
                      tp=None):
    """Training and prefill forward.  u (B, S, D) -> (B, S, D), plus the
    decode cache ``{"conv_state", "ssm_state"}`` with ``return_cache``.
    Under a serving split ``tp`` that splits the mixer, ``params`` are the
    rank's view (:func:`local_mixer`), the block computes the rank's heads
    and the cache is the rank's block of the states."""
    d = _dims(cfg, tp)
    zxbcdt = _lin(params["in_proj"], u, cfg, cdt, "in_proj", adapter_ids)
    z, x, bmat, cmat, dt = _split_in_proj(zxbcdt, d)
    xbc_raw = torch.cat([x, bmat, cmat], dim=-1)
    xbc = causal_conv(xbc_raw, params["conv_w"], params["conv_b"])
    gn = d["g"] * d["n"]
    x, bmat, cmat = torch.split(xbc, [d["d_inner"], gn, gn], dim=-1)
    bsz, s = x.shape[:2]
    y, hfinal = ssd_chunked(
        x.reshape(bsz, s, d["heads"], cfg.ssm.head_dim), dt,
        params["a_log"], bmat.reshape(bsz, s, d["g"], d["n"]),
        cmat.reshape(bsz, s, d["g"], d["n"]), params["d_skip"],
        params["dt_bias"], cfg.ssm.chunk_size)
    out = _gate_out(params, y.reshape(bsz, s, d["d_inner"]), z, cfg, cdt,
                    adapter_ids, tp)
    if not return_cache:
        return out
    # the last K-1 conv inputs; a prompt shorter than that is led by the
    # zeros causal_conv pads it with
    hist = cfg.ssm.conv_width - 1
    conv_state = F.pad(xbc_raw[:, -hist:], (0, 0, max(hist - s, 0), 0))
    cache = {"conv_state": conv_state.to(u.dtype), "ssm_state": hfinal}
    return out, cache


def mamba_block_decode(params: Params, u_t: torch.Tensor, cache: Params,
                       cfg: ModelConfig, cdt, adapter_ids=None, tp=None
                       ) -> Tuple[torch.Tensor, Params]:
    """One-token decode.  u_t (B, 1, D); cache ``{"conv_state",
    "ssm_state"}``.  Returns ((B, 1, D), the new cache); the projections
    take 2-D rows.  ``tp``: as in :func:`mamba_block_apply`, over the
    rank's blocks of the states."""
    d = _dims(cfg, tp)
    zxbcdt = _lin(params["in_proj"], u_t[:, 0], cfg, cdt, "in_proj",
                  adapter_ids)
    z, x, bmat, cmat, dt = _split_in_proj(zxbcdt, d)
    xbc = torch.cat([x, bmat, cmat], dim=-1)                   # (B, conv_ch)
    xbc, conv_state = conv_step(xbc, cache["conv_state"], params["conv_w"],
                                params["conv_b"])
    gn = d["g"] * d["n"]
    x, bmat, cmat = torch.split(xbc, [d["d_inner"], gn, gn], dim=-1)
    bsz = x.shape[0]
    y, ssm_state = ssd_step(
        x.reshape(bsz, d["heads"], cfg.ssm.head_dim), dt, params["a_log"],
        bmat.reshape(bsz, d["g"], d["n"]), cmat.reshape(bsz, d["g"], d["n"]),
        params["d_skip"], params["dt_bias"], cache["ssm_state"])
    out = _gate_out(params, y.reshape(bsz, d["d_inner"]), z, cfg, cdt,
                    adapter_ids, tp)
    return out[:, None, :], {"conv_state": conv_state,
                             "ssm_state": ssm_state}


def mamba_cache_init(cfg: ModelConfig, batch: int, dtype, device,
                     lead: Sequence[int] = (), tp=None) -> Params:
    """Zero decode states (``lead`` stacked): ``conv_state`` (..., batch,
    K-1, C) in ``dtype``, ``ssm_state`` (..., batch, H, N, P) in fp32; a
    rank's blocks under a split ``tp`` that splits the mixer (H / n heads,
    the channels ``[x_r, B_g, C_g]``)."""
    d = _dims(cfg, tp)
    lead = tuple(lead)
    return {
        "conv_state": torch.zeros(
            lead + (batch, cfg.ssm.conv_width - 1, d["conv_ch"]),
            dtype=dtype, device=device),
        "ssm_state": torch.zeros(
            lead + (batch, d["heads"], d["n"], cfg.ssm.head_dim),
            dtype=torch.float32, device=device),
    }
