"""Full-space OFT baselines: block-diagonal OFTv2, butterfly BOFT, Givens
GOFT and quasi-Givens qGOFT.

All rotate the *input* of ``y = x @ W`` (paper Eq. 2, with the transpose
absorbed into the free rotation, as the reference writes it).  Every
rotation of an apply goes through the ``blockdiag_rotate`` kernel wrapper
on every device (the kernel on a GPU, its plain version on the CPU):

- OFT: one call with the d/b Cayley blocks of size ``oft_block_size``;
- BOFT: per factor, a stride permutation of the features, one call with
  blocks of ``boft_blocks``, and the inverse permutation;
- GOFT / qGOFT: per level, the same with 2 x 2 blocks (Givens rotations,
  or free 2 x 2 matrices for qGOFT).

As in the reference, the rotations are cast to the compute dtype before
the rotate.  The Cayley blocks of a whole layer stack come from one
``cayley_neumann`` call; a precomputed stack of them under ``"rot"`` (the
model builds them once per forward) is used as is.  Everything broadcasts
over leading (layer-stack) dims: a stacked apply or merge loops the
wrapper over the stack.
"""
from __future__ import annotations

import functools
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import cayley
from repro_torch.kernels import ops

Params = Dict[str, torch.Tensor]


# ------------------------------------------------------------ the rotation

def _rotate(x: torch.Tensor, rots: torch.Tensor) -> torch.Tensor:
    """x (*S, ..., d) through the block rotations rots (*S, d/b, b, b): one
    ``ops.blockdiag_rotate`` call per element of the stack dims S (one call
    in all for a single linear), the other leading dims of x flattened into
    the kernel's rows."""
    stack = rots.shape[:-3]
    if stack:
        n = math.prod(stack)
        xs = x.reshape(n, -1, x.shape[-1])
        rs = rots.reshape((n,) + tuple(rots.shape[-3:]))
        return torch.stack([_rotate(xs[i], rs[i]) for i in range(n)]
                           ).reshape(x.shape)
    y = ops.blockdiag_rotate(x.reshape(-1, x.shape[-1]), rots)
    return y.reshape(x.shape)


@functools.lru_cache(maxsize=None)
def _perm_np(d: int, block: int, level: int) -> Optional[np.ndarray]:
    stride = (block * (2 ** level)) % d
    if stride in (0, 1):
        return None
    if d % stride:
        raise ValueError(f"butterfly stride {stride} does not divide d={d}")
    return np.arange(d).reshape(stride, d // stride).T.reshape(-1)


def _butterfly_perm(d: int, block: int, level: int) -> torch.Tensor:
    """Stride permutation pairing indices at distance block * 2**level
    (mod d): the reference's ``_butterfly_perm``, identity when the stride
    is 0 or 1."""
    perm = _perm_np(d, block, level)
    return torch.arange(d) if perm is None else torch.from_numpy(perm)


@functools.lru_cache(maxsize=None)
def _perm_pair(d: int, block: int, level: int, device: torch.device
               ) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
    """(perm, inverse perm) on ``device``, cached; None for the identity."""
    perm = _perm_np(d, block, level)
    if perm is None:
        return None
    return (torch.from_numpy(perm).to(device),
            torch.from_numpy(np.argsort(perm)).to(device))


def _levels(x: torch.Tensor, rots: torch.Tensor, block: int,
            compute_dtype) -> torch.Tensor:
    """x through each level of rots (*S, levels, d/block, block, block):
    permute the features by level's stride, rotate, permute back."""
    d = x.shape[-1]
    for lvl in range(rots.shape[-4]):
        pair = _perm_pair(d, block, lvl, x.device)
        if pair is not None:
            x = x.index_select(-1, pair[0])
        x = _rotate(x, rots[..., lvl, :, :, :].to(compute_dtype))
        if pair is not None:
            x = x.index_select(-1, pair[1])
    return x


def _stacked_eye(w: torch.Tensor) -> torch.Tensor:
    """The (*S, d_in, d_in) identity of a (*S, d_in, d_out) weight, fp32."""
    d = w.shape[-2]
    eye = torch.eye(d, dtype=torch.float32, device=w.device)
    return eye.expand(tuple(w.shape[:-2]) + (d, d))


def block_rotations(q_flat: torch.Tensor, b: int,
                    terms: int = 5) -> torch.Tensor:
    """Cayley-Neumann blocks (..., b, b) of flat skew params (..., b(b-1)/2):
    one ``cayley_neumann`` call for every leading dim, fp32."""
    return cayley.cayley_neumann(q_flat, b, terms)


# ----------------------------------------------------- block-diagonal OFTv2

def oft_init(w_pre: torch.Tensor, block_size: int,
             param_dtype=torch.bfloat16, peft_dtype=torch.float32) -> Params:
    d_in, d_out = w_pre.shape[-2:]
    lead = tuple(w_pre.shape[:-2])
    b = block_size
    if d_in % b:
        raise ValueError(f"d_in={d_in} not divisible by OFT block {b}")
    dev = w_pre.device
    return {
        "w": w_pre.to(param_dtype),
        "q": torch.zeros(lead + (d_in // b, cayley.num_skew_params(b)),
                         dtype=peft_dtype, device=dev),
        "out_scale": torch.ones(lead + (d_out,), dtype=peft_dtype,
                                device=dev),     # OFTv2 scaling vector
    }


def _rotations(params: Params, b: int, terms: int) -> torch.Tensor:
    rot = params.get("rot")
    return block_rotations(params["q"], b, terms) if rot is None else rot


def oft_apply(params: Params, x: torch.Tensor, block_size: int,
              neumann_terms: int = 5, compute_dtype=torch.bfloat16
              ) -> torch.Tensor:
    rots = _rotations(params, block_size, neumann_terms)   # (*S, d/b, b, b)
    x = _rotate(x.to(compute_dtype), rots.to(compute_dtype))
    y = x @ params["w"].to(compute_dtype)
    return y * params["out_scale"].to(compute_dtype).unsqueeze(-2)


def oft_merge(params: Params, block_size: int,
              neumann_terms: int = 5) -> torch.Tensor:
    b = block_size
    rots = block_rotations(params["q"], b, neumann_terms)
    w = params["w"].float()
    wb = w.reshape(w.shape[:-2] + (-1, b, w.shape[-1]))      # (*S, d/b, b, n)
    # apply rotates x by M = blockdiag(R_g) (y = x@M@W), so W' = M @ W
    wr = (rots @ wb).reshape(w.shape)
    w = wr * params["out_scale"].float().unsqueeze(-2)
    return w.to(params["w"].dtype)


def oft_num_params(d_in: int, d_out: int, block_size: int) -> int:
    return (d_in // block_size) * cayley.num_skew_params(block_size) + d_out


# ------------------------------------------------------------ butterfly BOFT

def boft_init(w_pre: torch.Tensor, block_size: int, num_factors: int,
              param_dtype=torch.bfloat16, peft_dtype=torch.float32
              ) -> Params:
    d_in, d_out = w_pre.shape[-2:]
    lead = tuple(w_pre.shape[:-2])
    b = block_size
    if d_in % b:
        raise ValueError(f"d_in={d_in} not divisible by BOFT block {b}")
    dev = w_pre.device
    return {
        "w": w_pre.to(param_dtype),
        "q": torch.zeros(lead + (num_factors, d_in // b,
                                 cayley.num_skew_params(b)),
                         dtype=peft_dtype, device=dev),
        "out_scale": torch.ones(lead + (d_out,), dtype=peft_dtype,
                                device=dev),
    }


def boft_apply(params: Params, x: torch.Tensor, block_size: int,
               neumann_terms: int = 5, compute_dtype=torch.bfloat16
               ) -> torch.Tensor:
    rots = _rotations(params, block_size, neumann_terms)  # (*S, m, d/b, b, b)
    x = _levels(x.to(compute_dtype), rots, block_size, compute_dtype)
    y = x @ params["w"].to(compute_dtype)
    return y * params["out_scale"].to(compute_dtype).unsqueeze(-2)


def boft_merge(params: Params, block_size: int,
               neumann_terms: int = 5) -> torch.Tensor:
    """W' = M W diag(out_scale), M the product of the factors, obtained by
    rotating the identity in fp32 (as the reference does)."""
    w = params["w"]
    rots = block_rotations(params["q"], block_size, neumann_terms)
    rot_full = _levels(_stacked_eye(w), rots, block_size, torch.float32)
    w32 = rot_full @ w.float()
    return (w32 * params["out_scale"].float().unsqueeze(-2)).to(w.dtype)


def boft_num_params(d_in: int, d_out: int, block_size: int,
                    num_factors: int) -> int:
    return num_factors * (d_in // block_size) * cayley.num_skew_params(
        block_size) + d_out


# -------------------------------------------------------- Givens GOFT/qGOFT

def _num_levels(d_in: int) -> int:
    return max(1, int(math.log2(d_in)))


def goft_init(w_pre: torch.Tensor, quasi: bool, param_dtype=torch.bfloat16,
              peft_dtype=torch.float32) -> Params:
    """log2(d) levels of d/2 pairwise 2 x 2 transforms (Ma et al., 2024).

    GOFT: one angle per pair (strict rotations).  qGOFT: a general 2 x 2
    per pair, at the identity (4 params)."""
    d_in = w_pre.shape[-2]
    lead = tuple(w_pre.shape[:-2])
    levels = _num_levels(d_in)
    dev = w_pre.device
    if quasi:
        g = torch.eye(2, dtype=peft_dtype, device=dev).expand(
            lead + (levels, d_in // 2, 2, 2)).clone()
        return {"w": w_pre.to(param_dtype), "g": g}
    return {"w": w_pre.to(param_dtype),
            "theta": torch.zeros(lead + (levels, d_in // 2),
                                 dtype=peft_dtype, device=dev)}


def _givens_rotations(theta: torch.Tensor) -> torch.Tensor:
    c, s = torch.cos(theta), torch.sin(theta)
    return torch.stack([torch.stack([c, -s], -1), torch.stack([s, c], -1)],
                       -2)


def _goft_rotations(params: Params) -> torch.Tensor:
    """(*S, levels, d/2, 2, 2): qGOFT's free 2 x 2s or GOFT's rotations."""
    if "g" in params:
        return params["g"]
    return _givens_rotations(params["theta"])


def goft_apply(params: Params, x: torch.Tensor,
               compute_dtype=torch.bfloat16) -> torch.Tensor:
    x = _levels(x.to(compute_dtype), _goft_rotations(params), 1,
                compute_dtype)
    return x @ params["w"].to(compute_dtype)


def goft_merge(params: Params) -> torch.Tensor:
    w = params["w"]
    rot = _levels(_stacked_eye(w), _goft_rotations(params), 1,
                  torch.float32)
    return (rot @ w.float()).to(w.dtype)


def goft_num_params(d_in: int, quasi: bool) -> int:
    return _num_levels(d_in) * (d_in // 2) * (4 if quasi else 1)
