"""Cayley parameterization of the orthogonal group (paper §4.2, Appendix C).

R = (I - Q)(I + Q)^{-1} with Q skew-symmetric; the inverse is approximated
by the truncated Neumann series Σ_{k=0}^{K} (−Q)^k (K = 5 by default), and
the exact solve is kept as the reference path.  Q is stored as its strictly
lower-triangular entries in ``np.tril_indices`` order, exactly as the
reference package stores them, so a converted ``q`` means the same matrix.

Every function broadcasts over leading (layer-stack) dimensions.  The
Neumann rotation goes through the ``cayley_neumann`` kernel wrapper on every
device (the kernel on a GPU, its plain version on the CPU), one call for a
whole layer stack.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.kernels import ops


def num_skew_params(r: int) -> int:
    return r * (r - 1) // 2


@functools.lru_cache(maxsize=None)
def _tril_indices(r: int):
    # numpy's row-major strictly-lower order: the reference's flat layout
    return np.tril_indices(r, k=-1)


def skew_from_flat(q_flat: torch.Tensor, r: int) -> torch.Tensor:
    """Skew-symmetric Q (..., r, r) from its r(r-1)/2 free entries."""
    i, j = _tril_indices(r)
    q = q_flat.new_zeros(q_flat.shape[:-1] + (r, r))
    q[..., torch.as_tensor(i, device=q.device),
      torch.as_tensor(j, device=q.device)] = q_flat
    return q - q.transpose(-1, -2)


def cayley_neumann(q_flat: torch.Tensor, r: int,
                   terms: int = 5) -> torch.Tensor:
    """R ≈ (I − Q) Σ_{k=0}^{K}(−Q)^k, in fp32, differentiable in
    ``q_flat`` (the wrapper's exact backward, then the scatter of
    :func:`skew_from_flat`)."""
    return ops.cayley_neumann(skew_from_flat(q_flat.float(), r), terms)


def cayley_exact(q_flat: torch.Tensor, r: int) -> torch.Tensor:
    """R = (I − Q)(I + Q)^{-1} by an exact solve (the two factors commute)."""
    q = skew_from_flat(q_flat.float(), r)
    eye = torch.eye(r, dtype=torch.float32, device=q.device)
    return torch.linalg.solve(eye + q, eye - q)


def make_rotation(q_flat: torch.Tensor, r: int, terms: int = 5,
                  exact: bool = False) -> torch.Tensor:
    return cayley_exact(q_flat, r) if exact else cayley_neumann(q_flat, r,
                                                                terms)


def orthogonality_error(r_mat: torch.Tensor) -> torch.Tensor:
    """‖RᵀR − I‖_F, the paper's deviation metric (§4.3)."""
    eye = torch.eye(r_mat.shape[-1], dtype=r_mat.dtype, device=r_mat.device)
    return torch.linalg.matrix_norm(r_mat.transpose(-1, -2) @ r_mat - eye)
