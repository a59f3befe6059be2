"""PEFT method registry: ``none``, ``psoft`` and ``lora``, plus the adapter
bank that serves several fine-tunes of one base model in a single batch.

Each method is one :class:`PEFTMethod` registered by name and owns init /
apply / merge for one linear, and names its trainable keys.  PSOFT's apply
is the fused ``psoft_matmul`` wrapper on every device.  A method with
``supports_batched_delta`` also reports its weight update as exact low-rank
factors (:meth:`PEFTMethod.delta_factors`); :func:`stack_deltas` stacks
those into a per-linear bank and :func:`apply_batched` gathers one adapter
column per batch row.

Unlike the reference, which scopes the per-row adapter ids in a trace-time
context, the port threads ``adapter_ids`` explicitly from the engine through
the model to every banked linear; the result is the same.

All methods broadcast over leading (layer-stack) dimensions.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import lora, psoft
from repro_torch.kernels import ops

Params = Dict[str, torch.Tensor]


class PEFTMethod:
    """One PEFT method.  ``cfg`` everywhere is a :class:`PEFTConfig`."""

    #: registry key, e.g. "psoft"
    name: str = ""
    #: param keys whose presence marks a dict as this method's
    marker_keys: Tuple[str, ...] = ()
    #: param key holding the (d_in, d_out) base weight
    base_key: str = "w"
    #: True when :meth:`delta_factors` returns exact low-rank factors
    supports_batched_delta: bool = False

    def init(self, generator, w_pre, cfg, param_dtype, peft_dtype) -> Params:
        raise NotImplementedError

    def apply(self, params: Params, x, cfg, compute_dtype) -> torch.Tensor:
        raise NotImplementedError

    def merge(self, params: Params, cfg) -> torch.Tensor:
        raise NotImplementedError

    def trainable_names(self, cfg=None) -> Tuple[str, ...]:
        """Param keys the PEFT-masked trainer updates."""
        return ()

    def num_params(self, d_in: int, d_out: int, cfg) -> int:
        """Trainable params of one (d_in, d_out) linear."""
        return 0

    def base_weight(self, params: Params, cfg) -> torch.Tensor:
        """The pre-trained weight :meth:`delta_factors` is relative to."""
        return params[self.base_key]

    def delta_factors(self, params: Params, cfg
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """fp32 ``(left, right)`` with merge == base_weight + left @ right."""
        raise NotImplementedError(
            f"method {self.name!r} has no low-rank delta")

    def matches(self, params: Dict) -> bool:
        if not self.marker_keys:
            return set(params) == {"w"}
        return all(k in params for k in self.marker_keys)


_METHODS: Dict[str, PEFTMethod] = {}


def register(method: PEFTMethod) -> PEFTMethod:
    if not method.name:
        raise ValueError("PEFTMethod.name must be a non-empty string")
    if method.name in _METHODS:
        raise ValueError(f"PEFT method {method.name!r} is already registered")
    _METHODS[method.name] = method
    return method


def get_method(name: str) -> PEFTMethod:
    try:
        return _METHODS[name]
    except KeyError:
        raise KeyError(f"unknown PEFT method {name!r}; registered methods: "
                       f"{available_methods()}") from None


def available_methods() -> List[str]:
    return sorted(_METHODS)


def linear_markers() -> Tuple[str, ...]:
    out: List[str] = []
    for m in _METHODS.values():
        for k in m.marker_keys:
            if k not in out:
                out.append(k)
    return tuple(out)


def is_peft_param_dict(node) -> bool:
    return isinstance(node, dict) and any(k in node for k in linear_markers())


def infer_method(params: Dict, hint: Optional[str] = None) -> PEFTMethod:
    candidates = [m for m in _METHODS.values() if m.matches(params)]
    if not candidates:
        raise ValueError(f"param dict with keys {sorted(params)} matches no "
                         f"registered PEFT method ({available_methods()})")
    for m in candidates:
        if m.name == hint:
            return m
    return candidates[0]


def resolve(params: Dict, cfg, module: Optional[str] = None,
            method: Optional[str] = None) -> PEFTMethod:
    """Explicit name > config(module) > structure inference."""
    if method is not None:
        return get_method(method)
    if module is not None and hasattr(cfg, "method_for"):
        m = get_method(cfg.method_for(module))
        if m.matches(params):
            return m
    return infer_method(params, hint=getattr(cfg, "method", None))


# ---------------------------------------------------------------------------
# adapter banks
# ---------------------------------------------------------------------------
#
# A bank holds every adapter's update for ONE linear, stacked on an adapter
# axis right after the layer-stack dims:
#   low-rank: {"left": (..., N, d_in, k), "right": (..., N, k, d_out)}
#   dense:    {"delta": (..., N, d_in, d_out)}


def stack_deltas(base_w: torch.Tensor,
                 adapters: Sequence[Tuple[Dict, object, Optional[str]]],
                 *, atol: float = 1e-5, rtol: float = 1e-5
                 ) -> Optional[Dict[str, torch.Tensor]]:
    """One linear's bank from per-adapter ``(params, cfg, module)`` in bank
    order.  The low-rank form is exact only when every adapter's frozen base
    equals ``base_w`` (checked numerically); otherwise the bank falls back to
    dense deltas.  Returns None when every adapter sits at the base."""
    extra = base_w.ndim - 2
    resolved = []
    low_rank = True
    for params, cfg, module in adapters:
        m = resolve(params, cfg, module=module)
        resolved.append((m, params, cfg))
        if low_rank and m.supports_batched_delta:
            recon = m.base_weight(params, cfg)
            low_rank = bool(torch.allclose(recon.float(), base_w.float(),
                                           atol=atol, rtol=rtol))
        else:
            low_rank = False
    if low_rank:
        factors = [m.delta_factors(params, cfg) for m, params, cfg in resolved]
        kmax = max(left.shape[-1] for left, _ in factors)
        if kmax == 0:
            return None
        lefts, rights = [], []
        for left, right in factors:
            pad = kmax - left.shape[-1]
            if pad:
                left = F.pad(left, (0, pad))
                right = F.pad(right, (0, 0, 0, pad))
            lefts.append(left)
            rights.append(right)
        right = torch.stack(rights, dim=extra)
        if not bool(right.any()):
            return None    # every adapter sits exactly at the base weights
        return {"left": torch.stack(lefts, dim=extra), "right": right}
    deltas = [m.merge(params, cfg).float() - base_w.float()
              for m, params, cfg in resolved]
    delta = torch.stack(deltas, dim=extra)
    if not bool(delta.any()):
        return None
    return {"delta": delta}


def apply_batched(params: Dict, x: torch.Tensor, compute_dtype,
                  adapter_ids: Optional[torch.Tensor]) -> torch.Tensor:
    """One banked linear: ``y[b] = x[b] @ (W + delta[ids[b]])``.

    ``x``: (B, ..., d_in), leading dim = batch slots; ``adapter_ids``: (B,)
    int32 (None -> base weights only).  Decode-shaped inputs (B, 1, d_in) on
    a low-rank bank always go through the gather-delta wrapper: the kernel
    on a GPU, its plain version on the CPU."""
    x = x.to(compute_dtype)
    bank = params.get("bank")
    if bank is not None and adapter_ids is not None and "left" in bank \
            and x.ndim == 3 and x.shape[1] == 1:
        return ops.gather_delta_matmul(
            x[:, 0], params["w"], bank["left"], bank["right"], adapter_ids,
            compute_dtype=compute_dtype)[:, None, :]
    y = x @ params["w"].to(compute_dtype)
    if bank is None or adapter_ids is None:
        return y
    if "delta" in bank:
        d = bank["delta"][adapter_ids]
        y = y + torch.einsum("b...d,bdo->b...o", x, d.to(compute_dtype))
    if "left" in bank:
        left = bank["left"][adapter_ids]
        right = bank["right"][adapter_ids]
        u = torch.einsum("b...d,bdk->b...k", x, left.to(compute_dtype))
        y = y + torch.einsum("b...k,bko->b...o", u, right.to(compute_dtype))
    return y


def is_banked_linear(node) -> bool:
    return isinstance(node, dict) and "bank" in node and "w" in node


# ---------------------------------------------------------------------------
# methods
# ---------------------------------------------------------------------------


class NoneMethod(PEFTMethod):
    name = "none"
    supports_batched_delta = True   # rank-0 delta: the weight IS the base

    def init(self, generator, w_pre, cfg, param_dtype, peft_dtype):
        return {"w": w_pre.to(param_dtype)}

    def apply(self, params, x, cfg, compute_dtype):
        return x.to(compute_dtype) @ params["w"].to(compute_dtype)

    def merge(self, params, cfg):
        return params["w"]

    def delta_factors(self, params, cfg):
        w = params["w"]
        lead, (d_in, d_out) = w.shape[:-2], w.shape[-2:]
        return (w.new_zeros(lead + (d_in, 0), dtype=torch.float32),
                w.new_zeros(lead + (0, d_out), dtype=torch.float32))


class PSOFTMethod(PEFTMethod):
    name = "psoft"
    marker_keys = ("w_res",)
    base_key = "w_res"
    supports_batched_delta = True

    def init(self, generator, w_pre, cfg, param_dtype, peft_dtype):
        return psoft.psoft_init(w_pre, cfg.rank, cfg.relax_vectors,
                                param_dtype, peft_dtype)

    def apply(self, params, x, cfg, compute_dtype):
        # the fused psoft_matmul wrapper on every device: its kernel on a
        # GPU, its plain version on the CPU
        return psoft.psoft_fused_apply(params, x, cfg.neumann_terms,
                                       cfg.exact_cayley, compute_dtype)

    def merge(self, params, cfg):
        return psoft.psoft_merge(params, cfg.neumann_terms, cfg.exact_cayley)

    def base_weight(self, params, cfg):
        # W_pre = W_res + A·B (the SVD split is exact at init)
        w = params["w_res"].float() + params["A"].float() @ params["B"].float()
        return w.to(params["w_res"].dtype)

    def delta_factors(self, params, cfg):
        # W_merged − W_pre = A·(diag(α) R diag(β) B − B): exact rank r
        rot = psoft.psoft_rotation(params, cfg.neumann_terms,
                                   cfg.exact_cayley)
        if "alpha" in params:
            rot = params["alpha"].float()[..., :, None] * rot
        if "beta" in params:
            rot = rot * params["beta"].float()[..., None, :]
        b = params["B"].float()
        return params["A"].float(), rot @ b - b

    def trainable_names(self, cfg=None):
        if cfg is not None and not cfg.relax_vectors:
            return ("q",)
        return ("q", "alpha", "beta")

    def num_params(self, d_in, d_out, cfg):
        return psoft.psoft_num_params(cfg.rank, cfg.relax_vectors)


class LoRAMethod(PEFTMethod):
    name = "lora"
    marker_keys = ("a", "b")
    supports_batched_delta = True

    def _scale(self, cfg):
        return cfg.lora_alpha / cfg.rank

    def matches(self, params):
        return "a" in params and "b" in params and "w_res" not in params

    def init(self, generator, w_pre, cfg, param_dtype, peft_dtype):
        return lora.lora_init(generator, w_pre, cfg.rank, param_dtype,
                              peft_dtype)

    def apply(self, params, x, cfg, compute_dtype):
        return lora.lora_apply(params, x, self._scale(cfg), compute_dtype)

    def merge(self, params, cfg):
        return lora.lora_merge(params, self._scale(cfg))

    def delta_factors(self, params, cfg):
        # merge − w == s·a@b; the scale folds into the narrow right factor
        return params["a"].float(), params["b"].float() * self._scale(cfg)

    def trainable_names(self, cfg=None):
        return ("a", "b")

    def num_params(self, d_in, d_out, cfg):
        return lora.lora_num_params(d_in, d_out, cfg.rank)



for _m in (NoneMethod(), PSOFTMethod(), LoRAMethod()):
    register(_m)
del _m
