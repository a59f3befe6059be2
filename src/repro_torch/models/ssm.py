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
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core import peft as peft_lib
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


def _split_in_proj(zxbcdt: torch.Tensor, cfg: ModelConfig):
    """(z, x, B, C, dt) along the last axis of ``in_proj``'s output."""
    d = ssm_dims(cfg)
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


def _gate_out(params, y, z, cfg, cdt, adapter_ids):
    """norm(y * silu(z)) through ``out_proj``."""
    y = layers.apply_norm(params["norm"], y * F.silu(z.float()).to(y.dtype))
    return _lin(params["out_proj"], y, cfg, cdt, "out_proj", adapter_ids)


def mamba_block_apply(params: Params, u: torch.Tensor, cfg: ModelConfig,
                      cdt, return_cache: bool = False, adapter_ids=None):
    """Training and prefill forward.  u (B, S, D) -> (B, S, D), plus the
    decode cache ``{"conv_state", "ssm_state"}`` with ``return_cache``."""
    d = ssm_dims(cfg)
    zxbcdt = _lin(params["in_proj"], u, cfg, cdt, "in_proj", adapter_ids)
    z, x, bmat, cmat, dt = _split_in_proj(zxbcdt, cfg)
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
                    adapter_ids)
    if not return_cache:
        return out
    # the last K-1 conv inputs; a prompt shorter than that is led by the
    # zeros causal_conv pads it with
    hist = cfg.ssm.conv_width - 1
    conv_state = F.pad(xbc_raw[:, -hist:], (0, 0, max(hist - s, 0), 0))
    cache = {"conv_state": conv_state.to(u.dtype), "ssm_state": hfinal}
    return out, cache


def mamba_block_decode(params: Params, u_t: torch.Tensor, cache: Params,
                       cfg: ModelConfig, cdt, adapter_ids=None
                       ) -> Tuple[torch.Tensor, Params]:
    """One-token decode.  u_t (B, 1, D); cache ``{"conv_state",
    "ssm_state"}``.  Returns ((B, 1, D), the new cache); the projections
    take 2-D rows."""
    d = ssm_dims(cfg)
    zxbcdt = _lin(params["in_proj"], u_t[:, 0], cfg, cdt, "in_proj",
                  adapter_ids)
    z, x, bmat, cmat, dt = _split_in_proj(zxbcdt, cfg)
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
                    adapter_ids)
    return out[:, None, :], {"conv_state": conv_state,
                             "ssm_state": ssm_state}


def mamba_cache_init(cfg: ModelConfig, batch: int, dtype, device,
                     lead: Sequence[int] = ()) -> Params:
    d = ssm_dims(cfg)
    lead = tuple(lead)
    return {
        "conv_state": torch.zeros(
            lead + (batch, cfg.ssm.conv_width - 1, d["conv_ch"]),
            dtype=dtype, device=device),
        "ssm_state": torch.zeros(
            lead + (batch, d["heads"], d["n"], cfg.ssm.head_dim),
            dtype=torch.float32, device=device),
    }
