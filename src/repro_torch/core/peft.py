"""PEFT dispatcher: registry-backed entry points for one linear and the
whole-tree merge.

The method of a linear is named explicitly, resolved from the config by its
module name (``PEFTConfig.method_for``), or inferred from the param keys.
A banked serve linear (``{"w", "bank"}``) applies through
:func:`repro_torch.core.registry.apply_batched` with the caller's
``adapter_ids``.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import PEFTConfig
from repro_torch.core import registry
from repro_torch.tree import map_dicts


def init_linear(generator: Optional[torch.Generator], w_pre: torch.Tensor,
                cfg: PEFTConfig, wrapped: bool, param_dtype=torch.bfloat16,
                peft_dtype=torch.float32, *, module: Optional[str] = None,
                method: Optional[str] = None) -> Dict[str, torch.Tensor]:
    """The param dict for one linear (or a layer stack of them) from its
    pre-trained weight ``w_pre`` (..., d_in, d_out)."""
    if method is None:
        if not wrapped:
            method = "none"
        elif module is not None:
            method = cfg.method_for(module)
        else:
            method = cfg.method
    return registry.get_method(method).init(generator, w_pre, cfg,
                                            param_dtype, peft_dtype)


def apply_linear(params: Dict[str, torch.Tensor], x: torch.Tensor,
                 cfg: PEFTConfig, compute_dtype=torch.bfloat16, *,
                 module: Optional[str] = None, method: Optional[str] = None,
                 adapter_ids: Optional[torch.Tensor] = None,
                 tp=None) -> torch.Tensor:
    """One linear through its method.  ``tp``, the sharded step's compute
    split (:class:`repro_torch.distributed.tensor_parallel.TensorParallel`),
    applies the method to this rank's view of the params under the
    module's planned kind; PSOFT stays on the ``psoft_matmul`` wrapper,
    at the local shapes."""
    if registry.is_banked_linear(params):
        return registry.apply_batched(params, x, compute_dtype, adapter_ids)
    m = registry.resolve(params, cfg, module=module, method=method)
    if tp is not None:
        return tp.apply(m, params, x, cfg, compute_dtype, module)
    return m.apply(params, x, cfg, compute_dtype)


def merge_linear(params: Dict[str, torch.Tensor], cfg: PEFTConfig, *,
                 module: Optional[str] = None,
                 method: Optional[str] = None) -> torch.Tensor:
    return registry.resolve(params, cfg, module=module,
                            method=method).merge(params, cfg)


def trainable_names(method: str,
                    cfg: Optional[PEFTConfig] = None) -> Tuple[str, ...]:
    return registry.get_method(method).trainable_names(cfg)


def linear_logical_axes(params_or_names, cfg: PEFTConfig,
                        in_axis: Optional[str], out_axis: Optional[str],
                        *, module: Optional[str] = None,
                        method: Optional[str] = None,
                        ) -> Dict[str, Tuple[Optional[str], ...]]:
    """Logical sharding axes per param of one linear, through its method's
    ``logical_axes``: the big (d_in x d_out) tensors shard like the base
    weight, rank-space tensors shard their wide dim like the adjoining
    weight dim and replicate r.  One entry per (unstacked) param dim."""
    names = set(params_or_names)
    if isinstance(params_or_names, dict):
        m = registry.resolve(params_or_names, cfg, module=module,
                             method=method)
    elif method is not None:
        m = registry.get_method(method)
    elif module is not None:
        m = registry.get_method(cfg.method_for(module))
    else:
        m = registry.get_method(cfg.method if names != {"w"} else "none")
    ax = m.logical_axes(cfg, in_axis, out_axis)
    return {n: ax.get(n, (in_axis, out_axis) if n == "w" else None)
            for n in names if n in ax or n == "w"}


def count_trainable_params(d_in: int, d_out: int, cfg: PEFTConfig, *,
                           module: Optional[str] = None) -> int:
    method = cfg.method_for(module) if module is not None else cfg.method
    return registry.get_method(method).num_params(d_in, d_out, cfg)


def is_peft_linear(node) -> bool:
    return registry.is_peft_param_dict(node)


def merge_tree(params, cfg: PEFTConfig):
    """Collapse every PEFT linear into a plain ``{"w": W_final}``; layer-
    stacked linears merge in one batched call.  The dict key naming a linear
    is its module name, so per-module method maps merge correctly.  Lists
    (a hybrid's per-layer dicts) are walked like dicts."""
    def one(node, path):
        if not is_peft_linear(node):
            return None
        return {"w": merge_linear(node, cfg,
                                  module=path[-1] if path else None)}
    return map_dicts(one, params)
