"""PSOFT: orthogonal fine-tuning in the principal subspace (paper §4).

Per linear ``y = x @ W`` with W_pre (d_in, d_out):

    SVD:  W_pre = U Σ Vᵀ,  A = U[:, :r],  B = Σ[:r,:r] V[:, :r]ᵀ,
          W_res = W_pre − A B                       (frozen)
    forward:  y = x @ (A diag(α) R diag(β) B + W_res)

Trainable: q (the r(r−1)/2 Cayley entries), α and β (ones at init, so
training starts exactly at W_pre).  The forward of one linear, or of an MoE
layer's expert stack, runs through the ``psoft_matmul`` kernel wrapper
(:func:`psoft_fused_apply`) on every device; :func:`psoft_apply` mirrors
the reference's unfused apply.  The other functions broadcast over leading
(layer-stack, expert) dimensions, so a scan-stacked ``(L, d_in, d_out)``
weight is decomposed by one batched SVD, and an ``(L, E, d_in, d_out)``
expert stack by one batched SVD per layer.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.core import cayley
from repro_torch.kernels import ops
from repro_torch.tree import stack_filled

Params = Dict[str, torch.Tensor]


def psoft_init(w_pre: torch.Tensor, rank: int, relax_vectors: bool = True,
               param_dtype=torch.bfloat16, peft_dtype=torch.float32,
               ) -> Params:
    """One-time SVD split (Algorithm 1 lines 4-5), in fp32 on w_pre's
    device.  A stack of stacks (two or more leading dims, e.g. an
    ``(L, E, d_in, d_out)`` expert stack) is split one leading index at a
    time into preallocated outputs: one fp32 SVD over all 28 x 64 expert
    matrices of deepseek-moe-16b would need ~21 GB of input and as much
    again of factors."""
    if w_pre.ndim >= 4:
        return stack_filled(w_pre.shape[0], lambda i: psoft_init(
            w_pre[i], rank, relax_vectors, param_dtype, peft_dtype))
    d_in, d_out = w_pre.shape[-2:]
    lead = w_pre.shape[:-2]
    r = min(rank, min(d_in, d_out))
    w32 = w_pre.float()
    u, s, vh = torch.linalg.svd(w32, full_matrices=False)
    a = u[..., :, :r]
    b = s[..., :r, None] * vh[..., :r, :]
    w_res = w32 - a @ b
    dev = w_pre.device
    params = {
        "w_res": w_res.to(param_dtype),
        "A": a.to(param_dtype),
        "B": b.to(param_dtype),
        "q": torch.zeros(lead + (cayley.num_skew_params(r),),
                         dtype=peft_dtype, device=dev),
    }
    if relax_vectors:
        params["alpha"] = torch.ones(lead + (r,), dtype=peft_dtype,
                                     device=dev)
        params["beta"] = torch.ones(lead + (r,), dtype=peft_dtype, device=dev)
    return params


def psoft_rotation(params: Params, neumann_terms: int = 5,
                   exact: bool = False) -> torch.Tensor:
    r = params["A"].shape[-1]
    return cayley.make_rotation(params["q"], r, neumann_terms, exact)


def psoft_apply(params: Params, x: torch.Tensor, neumann_terms: int = 5,
                exact: bool = False, compute_dtype=torch.bfloat16
                ) -> torch.Tensor:
    """Unmerged forward: the subspace path runs at rank r."""
    rot = psoft_rotation(params, neumann_terms, exact)
    x = x.to(compute_dtype)
    y = x @ params["w_res"].to(compute_dtype)
    u = x @ params["A"].to(compute_dtype)
    if "alpha" in params:
        u = u * params["alpha"].to(compute_dtype)
    u = u @ rot.to(compute_dtype)
    if "beta" in params:
        u = u * params["beta"].to(compute_dtype)
    return y + u @ params["B"].to(compute_dtype)


def psoft_fused_apply(params: Params, x: torch.Tensor,
                      neumann_terms: int = 5, exact: bool = False,
                      compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Forward of ONE linear (2-D ``w_res``) through the fused
    ``psoft_matmul`` wrapper, for any leading shape of ``x`` (flattened to
    tokens); or of one expert stack (3-D ``w_res`` (E, d_in, d_out)) on
    ``x`` (E, ..., d_in), expert e's tokens through linear e, in one grouped
    launch set (the reference vmaps one linear over the expert axis).  A
    precomputed rotation under ``"rot"`` is used as is (the model builds
    each layer stack's rotations once per forward); otherwise it is built
    here."""
    shape = tuple(params["w_res"].shape)
    if len(shape) not in (2, 3) or (len(shape) == 3 and (
            x.ndim < 2 or x.shape[0] != shape[0])):
        raise ValueError(f"psoft_fused_apply takes one linear or one expert "
                         f"stack with x (E, ..., d_in); index the layer "
                         f"stack first (w_res {shape}, x {tuple(x.shape)})")
    rot = params.get("rot")
    if rot is None:
        rot = psoft_rotation(params, neumann_terms, exact)
    lead = x.shape[:-1]
    rows = (shape[0], -1) if len(shape) == 3 else (-1,)
    y = ops.psoft_matmul(x.reshape(*rows, x.shape[-1]), params["w_res"],
                         params["A"], rot, params["B"], params.get("alpha"),
                         params.get("beta"), compute_dtype=compute_dtype)
    return y.reshape(*lead, y.shape[-1])


def psoft_merge(params: Params, neumann_terms: int = 5,
                exact: bool = False) -> torch.Tensor:
    """W_final = A diag(α) R diag(β) B + W_res (Algorithm 1 line 12); a
    stack of stacks (``(L, E, d_in, d_out)``) one leading index at a time,
    into one preallocated output (its fp32 intermediates at once would be
    ~21 GB at deepseek-moe-16b)."""
    if params["w_res"].ndim >= 4:
        out = torch.empty_like(params["w_res"])
        for i in range(out.shape[0]):
            out[i] = psoft_merge({k: v[i] for k, v in params.items()},
                                 neumann_terms, exact)
        return out
    rot = psoft_rotation(params, neumann_terms, exact)
    a = params["A"].float()
    b = params["B"].float()
    if "alpha" in params:
        a = a * params["alpha"].float()[..., None, :]
    if "beta" in params:
        b = b * params["beta"].float()[..., :, None]
    w = a @ rot @ b + params["w_res"].float()
    return w.to(params["w_res"].dtype)


def psoft_num_params(r: int, relax_vectors: bool = True) -> int:
    """Table 8: r(r−1)/2 + 2r."""
    return cayley.num_skew_params(r) + (2 * r if relax_vectors else 0)


def orthogonality_deviation(params: Params,
                            neumann_terms: int = 5) -> torch.Tensor:
    """‖CᵀC − I‖_F with C = diag(α) R diag(β) (paper §4.3)."""
    c = psoft_rotation(params, neumann_terms)
    if "alpha" in params:
        c = params["alpha"].float()[..., :, None] * c
    if "beta" in params:
        c = c * params["beta"].float()[..., None, :]
    return cayley.orthogonality_error(c)
