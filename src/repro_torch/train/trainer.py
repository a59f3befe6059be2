"""Training loop core: the PEFT-masked train step with gradient
accumulation and optional gradient compression.

Gradients and optimizer state exist only for the trainable leaves (for
PSOFT: q, alpha and beta of every wrapped linear).  The trainable/frozen
partition comes from :func:`repro_torch.models.model.trainable_mask`, which
resolves each linear's method through the PEFT registry.  Every PSOFT linear
of the forward runs through the ``psoft_matmul`` wrapper, every OFT-family
input rotation through ``blockdiag_rotate``, and every Cayley rotation
through ``cayley_neumann`` (their kernels on a GPU).

The state is the reference's: a :class:`TrainState` of (step, trainable,
frozen, AdamW state) with ``None`` where a leaf belongs to the other tree,
so it converts leaf by leaf (:func:`train_state_from_numpy`) and checkpoints in
the reference's format (:mod:`repro_torch.train.checkpoint`).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch import interop, resolve_device
from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.models import model as model_lib
from repro_torch.optim import adamw
from repro_torch.tree import tree_leaves, tree_map

PyTree = Any


class TrainState(NamedTuple):
    step: torch.Tensor         # int32 scalar
    trainable: PyTree          # PEFT params (None at frozen leaves)
    frozen: PyTree             # frozen base params (None at trainable leaves)
    opt: adamw.AdamWState


def train_state_from_params(params: PyTree, cfg: ModelConfig,
                            tc: TrainConfig) -> TrainState:
    """Partition ``params`` by the PEFT mask; the leaves are shared, not
    copied."""
    mask = model_lib.trainable_mask(cfg, params, tc.full_finetune)
    tr, fr = adamw.partition(params, mask)
    opt = adamw.adamw_init(tr)
    return TrainState(step=torch.zeros_like(opt.step), trainable=tr,
                      frozen=fr, opt=opt)


def init_train_state(cfg: ModelConfig, tc: TrainConfig, seed: int = 0,
                     device="cuda") -> TrainState:
    """Random params from ``seed`` (:func:`model.init_params`), split."""
    params = model_lib.init_params(cfg, seed=seed,
                                   device=resolve_device(device))
    return train_state_from_params(params, cfg, tc)


def train_state_from_numpy(state: Any, device="cuda") -> TrainState:
    """A train state with numpy leaves (fields ``step``, ``trainable``,
    ``frozen``, ``opt`` with ``step``, ``mu``, ``nu``, as the reference's)
    -> a :class:`TrainState` on ``device``."""
    def conv(tree):
        return interop.params_from_numpy(tree, device)
    opt = state.opt
    return TrainState(step=conv(state.step), trainable=conv(state.trainable),
                      frozen=conv(state.frozen),
                      opt=adamw.AdamWState(step=conv(opt.step),
                                           mu=conv(opt.mu), nu=conv(opt.nu)))


def adapter_params(state: TrainState) -> PyTree:
    """The full param tree of a train state (trained PEFT factors with the
    frozen base): what merging and serving consume."""
    return adamw.combine(state.trainable, state.frozen)


def _compress(grads: PyTree, dtype: str) -> PyTree:
    """Gradient compression hook: quantize what a cross-replica reduction
    would carry (dequantized at once).  bf16: a straight cast; int8: one
    symmetric scale per leaf, round half to even."""
    if not dtype:
        return grads
    if dtype == "bfloat16":
        return tree_map(
            lambda g: g.to(torch.bfloat16).to(g.dtype), grads)
    if dtype == "int8":
        def q(g):
            scale = torch.clamp(g.abs().max(), min=1e-12) / 127.0
            qi = torch.clamp(torch.round(g / scale), -127, 127).to(
                torch.int8)
            return (qi.to(torch.float32) * scale).to(g.dtype)
        return tree_map(q, grads)
    raise ValueError(dtype)


def _device_of(state: TrainState) -> torch.device:
    leaves = tree_leaves(state.trainable) or \
        tree_leaves(state.frozen)
    return leaves[0].device


def make_train_step(cfg: ModelConfig, tc: TrainConfig,
                    moe_impl: str = "capacity") -> Callable:
    """Returns ``train_step(state, batch) -> (state, metrics)``.  ``batch``
    holds ``tokens`` and ``labels`` (B, S) as numpy arrays or tensors; they
    move to the state's device.  Metrics are 0-d tensors (no host sync),
    the MoE aux loss under ``"aux"``; ``moe_impl`` is the MoE layers'
    dispatch ("capacity" or "dense")."""
    schedule = adamw.make_schedule(tc.schedule, tc.learning_rate, tc.steps,
                                   tc.warmup_ratio)

    def grad_of(state: TrainState, batch) -> Tuple[Dict, PyTree]:
        leaves = []

        def leaf(p):
            t = p.detach().requires_grad_(True)
            leaves.append(t)
            return t
        tr = tree_map(leaf, state.trainable)
        params = adamw.combine(tr, state.frozen)
        loss, metrics = model_lib.loss_fn(params, batch, cfg, moe_impl)
        grads = iter(torch.autograd.grad(loss, leaves, allow_unused=True))
        with torch.no_grad():
            out = tree_map(
                lambda t: _zero_if_none(next(grads), t), tr)
        return {k: v.detach() for k, v in metrics.items()}, out

    def train_step(state: TrainState, batch: Dict) -> Tuple[TrainState, Dict]:
        dev = _device_of(state)
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        if tc.microbatches > 1:
            mb = tc.microbatches
            gsum = tree_map(
                lambda p: torch.zeros_like(p, dtype=torch.float32),
                state.trainable)
            lsum = torch.zeros((), dtype=torch.float32, device=dev)
            for i in range(mb):
                micro = {k: v.reshape(mb, v.shape[0] // mb,
                                      *v.shape[1:])[i]
                         for k, v in batch.items()}
                m, g = grad_of(state, micro)
                gsum = tree_map(torch.add, gsum, g)
                lsum = lsum + m["loss"]
            grads = tree_map(lambda g: g / mb, gsum)
            metrics = {"loss": lsum / mb}
        else:
            metrics, grads = grad_of(state, batch)
        grads = _compress(grads, tc.grad_allreduce_dtype)
        lr = schedule(state.step)
        new_tr, new_opt, opt_metrics = adamw.adamw_update(
            grads, state.opt, state.trainable, lr,
            beta1=tc.beta1, beta2=tc.beta2, eps=tc.eps,
            weight_decay=tc.weight_decay, grad_clip_norm=tc.grad_clip_norm)
        metrics = {**metrics, **opt_metrics, "lr": lr,
                   "loss": metrics["loss"]}
        return TrainState(state.step + 1, new_tr, state.frozen, new_opt), \
            metrics

    return train_step


def log_step_metrics(tracker, step: int, metrics: Dict,
                     step_time: Optional[float] = None) -> None:
    """Report one train step through the :mod:`repro_torch.obs` Tracker,
    the surface the serving stack reports through: every scalar of
    ``metrics`` under ``train/`` (loss, grad_norm, lr, ...) against the
    optimizer step, plus ``train/step_time_s`` as a histogram when the
    caller hands in a measured wall-clock.  The ``float()`` casts read
    device values, so call it at the logging cadence, after the step."""
    scalars = {f"train/{k}": float(v) for k, v in metrics.items()
               if (v.ndim if torch.is_tensor(v) else np.ndim(v)) == 0}
    tracker.log(scalars, step=step)
    if step_time is not None:
        tracker.histogram("train/step_time_s", step_time, step=step)


def _zero_if_none(g, like: torch.Tensor) -> torch.Tensor:
    return torch.zeros_like(like) if g is None else g
