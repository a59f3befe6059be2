"""AdamW with PEFT-aware masking, functional over nested dicts of tensors.

Optimizer state exists ONLY for trainable leaves: the trainable and frozen
trees share the param tree's structure with ``None`` where a leaf belongs to
the other side, so PEFT fine-tuning keeps optimizer memory at
O(trainable).  Trees are those of :mod:`repro_torch.tree` (``None`` is an
empty subtree), and every update returns new tensors.  Not
``torch.optim``: the state is a plain
:class:`AdamWState` that checkpoints in the reference's format.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, NamedTuple, Tuple

import torch

from repro_torch.tree import tree_leaves, tree_map

PyTree = Any


class AdamWState(NamedTuple):
    step: torch.Tensor     # int32 scalar
    mu: PyTree
    nu: PyTree


def partition(params: PyTree, mask: PyTree) -> Tuple[PyTree, PyTree]:
    """Split params into (trainable, frozen) trees; absent leaves are None."""
    tr = tree_map(lambda p, m: p if m else None, params, mask)
    fr = tree_map(lambda p, m: None if m else p, params, mask)
    return tr, fr


def combine(tr: PyTree, fr: PyTree) -> PyTree:
    if tr is None:
        return fr
    if isinstance(tr, dict):
        return {k: combine(v, fr[k]) for k, v in tr.items()}
    if isinstance(tr, (list, tuple)):
        return type(tr)(combine(a, b) for a, b in zip(tr, fr))
    return tr


def global_norm(tree: PyTree) -> torch.Tensor:
    leaves = tree_leaves(tree)
    if not leaves:
        return torch.zeros((), dtype=torch.float32)
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in leaves))


def make_schedule(kind: str, base_lr: float, total_steps: int,
                  warmup_ratio: float = 0.1
                  ) -> Callable[[Any], torch.Tensor]:
    """Linear warmup, then cosine / linear decay or constant; fp32 on the
    step's device."""
    warmup = max(1, int(total_steps * warmup_ratio))

    def fn(step) -> torch.Tensor:
        step = torch.as_tensor(step).to(torch.float32)
        warm = step / warmup
        frac = torch.clamp((step - warmup) / max(1, total_steps - warmup),
                           0, 1)
        if kind == "cosine":
            decay = 0.5 * (1 + torch.cos(math.pi * frac))
        elif kind == "linear":
            decay = 1.0 - frac
        else:
            decay = torch.ones_like(step)
        return base_lr * torch.where(step < warmup, warm, decay)
    return fn


def adamw_init(trainable: PyTree) -> AdamWState:
    leaves = tree_leaves(trainable)
    device = leaves[0].device if leaves else torch.device("cpu")
    zeros = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                     trainable)
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device),
                      mu=zeros, nu=tree_map(torch.clone, zeros))


@torch.no_grad()
def adamw_update(grads: PyTree, state: AdamWState, trainable: PyTree,
                 lr, *, beta1=0.9, beta2=0.999, eps=1e-8,
                 weight_decay=0.0, grad_clip_norm: float = 0.0
                 ) -> Tuple[PyTree, AdamWState, Dict[str, torch.Tensor]]:
    """Returns (new_trainable, new_state, {"grad_norm"})."""
    gnorm = global_norm(grads)
    if grad_clip_norm and grad_clip_norm > 0:
        scale = torch.clamp(grad_clip_norm / (gnorm + 1e-9), max=1.0)
        grads = tree_map(lambda g: g.to(torch.float32) * scale, grads)

    step = state.step + 1
    b1c = 1 - beta1 ** step.to(torch.float32)
    b2c = 1 - beta2 ** step.to(torch.float32)

    def moment1(g, m):
        return beta1 * m + (1 - beta1) * g.to(torch.float32)

    def moment2(g, v):
        return beta2 * v + (1 - beta2) * torch.square(g.to(torch.float32))

    def upd(p, m, v):
        delta = (m / b1c) / (torch.sqrt(v / b2c) + eps)
        if weight_decay:
            delta = delta + weight_decay * p.to(torch.float32)
        return (p.to(torch.float32) - lr * delta).to(p.dtype)

    mu = tree_map(moment1, grads, state.mu)
    nu = tree_map(moment2, grads, state.nu)
    new_p = tree_map(upd, trainable, mu, nu)
    return new_p, AdamWState(step, mu, nu), {"grad_norm": gnorm}
