"""PEFT method registry: PSOFT and every baseline the paper measures it
against (``none``, ``psoft``, ``lora``, ``pissa``, ``dora``, ``lora_xs``,
``oft``, ``boft``, ``goft``, ``qgoft``), plus the adapter bank that serves
several fine-tunes of one base model in a single batch.

Each method is one :class:`PEFTMethod` registered by name and owns init /
apply / merge for one linear, and names its trainable keys.  PSOFT's apply
is the fused ``psoft_matmul`` wrapper on every device, and the OFT
family's rotations go through ``blockdiag_rotate``.  A method with
``supports_batched_delta`` also reports its weight update as exact low-rank
factors (:meth:`PEFTMethod.delta_factors`); :func:`stack_deltas` stacks
those into a per-linear bank, :func:`apply_batched` gathers one adapter
column per batch row, and :func:`extend_bank` / :func:`take_bank_columns`
grow and compact a live bank without touching the columns they keep.

Unlike the reference, which scopes the per-row adapter ids in a trace-time
context, the port threads ``adapter_ids`` explicitly from the engine through
the model to every banked linear; the result is the same.

All methods broadcast over leading (layer-stack) dimensions, and so do the
structure matchers: a matcher that tells methods apart by the rank of a
param (OFT's ``q`` against BOFT's) counts it relative to the base weight's
(``w.ndim - 2`` leading dims), so a layer-stacked tree resolves as an
unstacked one does.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import lora, oft, psoft
from repro_torch.kernels import ops

Params = Dict[str, torch.Tensor]
#: one logical axis name (or None) per param dim
Axes = Tuple[Optional[str], ...]


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
    #: True when :meth:`apply` splits along the input dim: the outputs of
    #: every input slice with its rows of the input-dim params (the
    #: ``in_axis`` entries of :meth:`logical_axes`) and the rest whole add
    #: up to the whole output, so a row-split linear sums its ranks'
    #: partial outputs; False where the method mixes input dims across
    #: any cut (a norm over the input dim, an input rotation)
    row_separable: bool = False

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

    def rotations(self, params: Params, cfg) -> Optional[torch.Tensor]:
        """The method's rotations for a whole layer stack, built ahead of the
        forward (the model passes them to :meth:`apply` under ``"rot"``),
        or None when it has none to build."""
        return None

    def logical_axes(self, cfg, in_axis: Optional[str],
                     out_axis: Optional[str]) -> Dict[str, Axes]:
        """Per-param logical sharding axes: one entry per param
        :meth:`init` can emit, ``len(axes) == param.ndim`` for the
        *unstacked* param (the model's ``param_axes`` pads the layer and
        expert stack dims)."""
        return {"w": (in_axis, out_axis)}

    def matches(self, params: Dict) -> bool:
        if not self.marker_keys:
            return set(params) == {"w"}
        return all(k in params for k in self.marker_keys)


def _rel_ndim(params: Dict, key: str) -> int:
    """``params[key]``'s rank without the layer-stack dims (those of the
    2-D base weight ``w``)."""
    return params[key].ndim - (params["w"].ndim - 2)


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
    int32 (None -> base weights only).  Decode-shaped inputs, (B, 1, d_in)
    or the Mamba2 decode's (B, d_in) rows, on a low-rank bank always go
    through the gather-delta wrapper: the kernel on a GPU, its plain
    version on the CPU.  A MIXED bank
    (``{"left", "right", "delta"}``, from :func:`extend_bank` growing a
    low-rank bank with a dense newcomer) adds the dense term after either
    low-rank path; every column holds an exact zero in the form it does not
    use, so a pure column's output is unchanged by the other term."""
    x = x.to(compute_dtype)
    bank = params.get("bank")
    if bank is not None and adapter_ids is not None and "left" in bank \
            and (x.ndim == 2 or (x.ndim == 3 and x.shape[1] == 1)):
        rows = x.reshape(x.shape[0], x.shape[-1])
        y = ops.gather_delta_matmul(
            rows, params["w"], bank["left"], bank["right"], adapter_ids,
            compute_dtype=compute_dtype)
        if "delta" in bank:
            y = y + _dense_term(rows, bank["delta"], adapter_ids,
                                compute_dtype)
        return y.reshape(*x.shape[:-1], y.shape[-1])
    y = x @ params["w"].to(compute_dtype)
    if bank is None or adapter_ids is None:
        return y
    if "delta" in bank:
        y = y + _dense_term(x, bank["delta"], adapter_ids, compute_dtype)
    if "left" in bank:
        left = bank["left"][adapter_ids]
        right = bank["right"][adapter_ids]
        u = torch.einsum("b...d,bdk->b...k", x, left.to(compute_dtype))
        y = y + torch.einsum("b...k,bko->b...o", u, right.to(compute_dtype))
    return y


def _dense_term(x: torch.Tensor, delta: torch.Tensor,
                adapter_ids: torch.Tensor, compute_dtype) -> torch.Tensor:
    """``x[b] @ delta[ids[b]]``, the dense half of a bank."""
    d = delta[adapter_ids]
    return torch.einsum("b...d,bdo->b...o", x, d.to(compute_dtype))


def _pad_rank(left: torch.Tensor, right: torch.Tensor,
              kmax: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Zero-pad a low-rank pair to rank ``kmax``: the padded ranks add exact
    +0.0 terms at the END of the contraction, so the live ranks' partial
    sums are untouched."""
    pad = kmax - left.shape[-1]
    if pad:
        left = F.pad(left, (0, pad))
        right = F.pad(right, (0, 0, 0, pad))
    return left, right


def extend_bank(base_w: torch.Tensor, bank: Optional[Dict],
                new_bank: Optional[Dict], n_existing: int,
                n_new: Optional[int] = None) -> Optional[Dict]:
    """Append adapter columns to one linear's bank without touching the
    existing ones (the hot-swap exactness contract).

    ``bank`` is the linear's current bank (None: its ``n_existing`` columns
    all sit at the base weight); ``new_bank`` is :func:`stack_deltas` over
    the new adapters alone (None: the new columns are all zero, and
    ``n_new`` is required).  A side missing from either is filled with
    exact zero columns in that side's dtype, so a dense newcomer on a
    low-rank bank gives a MIXED bank instead of recomputing the live
    columns in the dense form; rank growth zero-pads.  Existing arrays are
    only concatenated onto.  Returns None only when both are None."""
    if bank is None and new_bank is None:
        return None
    axis = base_w.ndim - 2          # adapter axis of every bank array
    lead = tuple(base_w.shape[:-2])
    d_in, d_out = base_w.shape[-2:]
    if n_new is None:
        if new_bank is None:
            raise ValueError("n_new is required when new_bank is None")
        probe = "left" if "left" in new_bank else "delta"
        n_new = new_bank[probe].shape[axis]
    out: Dict[str, torch.Tensor] = {}
    old_lr = bank is not None and "left" in bank
    new_lr = new_bank is not None and "left" in new_bank
    if old_lr or new_lr:
        ref = bank if old_lr else new_bank
        kmax = max(bank["left"].shape[-1] if old_lr else 0,
                   new_bank["left"].shape[-1] if new_lr else 0)

        def lr_side(b, n):
            if b is not None and "left" in b:
                return _pad_rank(b["left"], b["right"], kmax)
            return (ref["left"].new_zeros(lead + (n, d_in, kmax)),
                    ref["right"].new_zeros(lead + (n, kmax, d_out)))

        l_old, r_old = lr_side(bank, n_existing)
        l_new, r_new = lr_side(new_bank, n_new)
        out["left"] = torch.cat([l_old, l_new.to(l_old.dtype)], dim=axis)
        out["right"] = torch.cat([r_old, r_new], dim=axis)
    old_d = bank is not None and "delta" in bank
    new_d = new_bank is not None and "delta" in new_bank
    if old_d or new_d:
        d_ref = (bank if old_d else new_bank)["delta"]

        def dense_side(b, n):
            if b is not None and "delta" in b:
                return b["delta"]
            return d_ref.new_zeros(lead + (n, d_in, d_out))

        out["delta"] = torch.cat([dense_side(bank, n_existing),
                                  dense_side(new_bank, n_new)], dim=axis)
    return out


def take_bank_columns(bank: Optional[Dict],
                      idx: Sequence[int]) -> Optional[Dict]:
    """Adapter columns ``idx`` (in order) of one linear's bank: a gather
    along the adapter axis, so kept columns are bit-exact.  A form whose
    kept columns are all zero is dropped (it added exact +0.0), and None
    comes back when nothing remains: the linear reverts to its base
    weight.  The zero checks read device values."""
    if bank is None or not len(idx):
        return None
    out = {}
    for k, v in bank.items():
        ids = torch.as_tensor(list(idx), dtype=torch.long, device=v.device)
        out[k] = torch.index_select(v, v.ndim - 3, ids)
    if "delta" in out and not bool(out["delta"].any()):
        del out["delta"]
    if "right" in out and not bool(out["right"].any()):
        out.pop("left", None)
        out.pop("right", None)
    return out or None


def is_banked_linear(node) -> bool:
    return isinstance(node, dict) and "bank" in node and "w" in node


# ---------------------------------------------------------------------------
# methods
# ---------------------------------------------------------------------------


class NoneMethod(PEFTMethod):
    name = "none"
    row_separable = True
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
    row_separable = True
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

    def rotations(self, params, cfg):
        return psoft.psoft_rotation(params, cfg.neumann_terms,
                                    cfg.exact_cayley)

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

    def logical_axes(self, cfg, in_axis, out_axis):
        return {"w_res": (in_axis, out_axis), "A": (in_axis, "rank"),
                "B": ("rank", out_axis), "q": (None,),
                "alpha": ("rank",), "beta": ("rank",)}


class LoRAMethod(PEFTMethod):
    name = "lora"
    row_separable = True
    marker_keys = ("a", "b")
    supports_batched_delta = True

    def _scale(self, cfg):
        return cfg.lora_alpha / cfg.rank

    def matches(self, params):
        return ("a" in params and "b" in params and "m" not in params
                and "s" not in params and "w_res" not in params)

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

    def logical_axes(self, cfg, in_axis, out_axis):
        return {"w": (in_axis, out_axis), "a": (in_axis, "rank"),
                "b": ("rank", out_axis)}


class PiSSAMethod(LoRAMethod):
    name = "pissa"

    def _scale(self, cfg):
        return 1.0  # principal factors are trained directly, unit scaling

    def init(self, generator, w_pre, cfg, param_dtype, peft_dtype):
        return lora.pissa_init(w_pre, cfg.rank, param_dtype, peft_dtype)


class DoRAMethod(LoRAMethod):
    name = "dora"
    marker_keys = ("a", "b", "m")
    # the per-column magnitude renormalization makes the weight update
    # full-rank: DoRA serves through the dense-delta bank
    supports_batched_delta = False
    # the column norm runs over the input dim: a row split cannot normalise
    row_separable = False

    def matches(self, params):
        return "m" in params and "a" in params

    def init(self, generator, w_pre, cfg, param_dtype, peft_dtype):
        return lora.dora_init(generator, w_pre, cfg.rank, param_dtype,
                              peft_dtype)

    def apply(self, params, x, cfg, compute_dtype):
        return lora.dora_apply(params, x, self._scale(cfg), compute_dtype)

    def merge(self, params, cfg):
        return lora.dora_merge(params, self._scale(cfg))

    def trainable_names(self, cfg=None):
        return ("a", "b", "m")

    def num_params(self, d_in, d_out, cfg):
        return lora.dora_num_params(d_in, d_out, cfg.rank)

    def logical_axes(self, cfg, in_axis, out_axis):
        ax = super().logical_axes(cfg, in_axis, out_axis)
        ax["m"] = (out_axis,)
        return ax


class LoRAXSMethod(PEFTMethod):
    name = "lora_xs"
    row_separable = True
    marker_keys = ("s",)
    supports_batched_delta = True

    def matches(self, params):
        return "s" in params and "a" in params

    def delta_factors(self, params, cfg):
        # merge − w == a@s@b; the r×r core folds into the left factor
        return (params["a"].float() @ params["s"].float(),
                params["b"].float())

    def init(self, generator, w_pre, cfg, param_dtype, peft_dtype):
        return lora.lora_xs_init(w_pre, cfg.rank, param_dtype, peft_dtype)

    def apply(self, params, x, cfg, compute_dtype):
        return lora.lora_xs_apply(params, x, compute_dtype)

    def merge(self, params, cfg):
        return lora.lora_xs_merge(params)

    def trainable_names(self, cfg=None):
        return ("s",)

    def num_params(self, d_in, d_out, cfg):
        return lora.lora_xs_num_params(cfg.rank)

    def logical_axes(self, cfg, in_axis, out_axis):
        return {"w": (in_axis, out_axis), "a": (in_axis, "rank"),
                "b": ("rank", out_axis), "s": ("rank", "rank")}


class OFTMethod(PEFTMethod):
    name = "oft"
    marker_keys = ("out_scale",)
    #: rank of ``q`` in one linear's dict: (d/b, b(b-1)/2)
    q_ndim = 2

    def _block(self, cfg):
        return cfg.oft_block_size

    def matches(self, params):
        return ("out_scale" in params and "q" in params and "w" in params
                and _rel_ndim(params, "q") == self.q_ndim)

    def rotations(self, params, cfg):
        # every Cayley block of the stack in one cayley_neumann call
        return oft.block_rotations(params["q"], self._block(cfg),
                                   cfg.neumann_terms)

    def init(self, generator, w_pre, cfg, param_dtype, peft_dtype):
        return oft.oft_init(w_pre, cfg.oft_block_size, param_dtype,
                            peft_dtype)

    def apply(self, params, x, cfg, compute_dtype):
        return oft.oft_apply(params, x, cfg.oft_block_size, cfg.neumann_terms,
                             compute_dtype)

    def merge(self, params, cfg):
        return oft.oft_merge(params, cfg.oft_block_size, cfg.neumann_terms)

    def trainable_names(self, cfg=None):
        return ("q", "out_scale")

    def num_params(self, d_in, d_out, cfg):
        return oft.oft_num_params(d_in, d_out, cfg.oft_block_size)

    def logical_axes(self, cfg, in_axis, out_axis):
        return {"w": (in_axis, out_axis), "q": ("oft_blocks", None),
                "out_scale": (out_axis,)}


class BOFTMethod(OFTMethod):
    name = "boft"
    #: (m, d/b, b(b-1)/2)
    q_ndim = 3

    def _block(self, cfg):
        return cfg.boft_blocks

    def init(self, generator, w_pre, cfg, param_dtype, peft_dtype):
        return oft.boft_init(w_pre, cfg.boft_blocks, cfg.boft_factors,
                             param_dtype, peft_dtype)

    def apply(self, params, x, cfg, compute_dtype):
        return oft.boft_apply(params, x, cfg.boft_blocks, cfg.neumann_terms,
                              compute_dtype)

    def merge(self, params, cfg):
        return oft.boft_merge(params, cfg.boft_blocks, cfg.neumann_terms)

    def num_params(self, d_in, d_out, cfg):
        return oft.boft_num_params(d_in, d_out, cfg.boft_blocks,
                                   cfg.boft_factors)

    def logical_axes(self, cfg, in_axis, out_axis):
        return {"w": (in_axis, out_axis), "q": (None, "oft_blocks", None),
                "out_scale": (out_axis,)}


class GOFTMethod(PEFTMethod):
    name = "goft"
    marker_keys = ("theta",)
    quasi = False

    def init(self, generator, w_pre, cfg, param_dtype, peft_dtype):
        return oft.goft_init(w_pre, self.quasi, param_dtype, peft_dtype)

    def apply(self, params, x, cfg, compute_dtype):
        return oft.goft_apply(params, x, compute_dtype)

    def merge(self, params, cfg):
        return oft.goft_merge(params)

    def trainable_names(self, cfg=None):
        return ("theta",)

    def num_params(self, d_in, d_out, cfg):
        return oft.goft_num_params(d_in, self.quasi)

    def logical_axes(self, cfg, in_axis, out_axis):
        return {"w": (in_axis, out_axis), "theta": (None, None)}


class QGOFTMethod(GOFTMethod):
    name = "qgoft"
    marker_keys = ("g",)
    quasi = True

    def trainable_names(self, cfg=None):
        return ("g",)

    def logical_axes(self, cfg, in_axis, out_axis):
        return {"w": (in_axis, out_axis), "g": (None, None, None, None)}


for _m in (NoneMethod(), PSOFTMethod(), LoRAMethod(), PiSSAMethod(),
           DoRAMethod(), LoRAXSMethod(), OFTMethod(), BOFTMethod(),
           GOFTMethod(), QGOFTMethod()):
    register(_m)
del _m
