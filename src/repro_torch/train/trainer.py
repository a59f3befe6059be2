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

Sharded over a live mesh (:func:`state_shardings`, :func:`shard_state`),
each rank holds its block of every leaf the rules split, and
``make_train_step(..., mesh=, rules=)`` is the ZeRO-3 data-parallel step:
the global batch splits over the rules' ``batch`` axes, each layer's split
frozen leaves are all-gathered as the layer loop reaches them (inside the
layer's remat boundary, so the recompute gathers again), and the trainable
gradients are summed over the batch axes in ``grad_allreduce_dtype``, one
reduction set a step.  Over a ``model`` axis of several ranks the compute
splits (:mod:`repro_torch.distributed.tensor_parallel`): each rank
computes its heads, MLP columns, vocabulary slice and experts; no frozen
leaf is gathered over ``model`` where the split consumes its block (the
embedding and the head keep their vocabulary rows, the expert stacks
their experts), and the gradients that the split leaves partial are
summed over ``model`` as well.  The trainable leaves and their AdamW
moments stay placed as the rules place them (an expert stack's over
``model`` too) and are gathered whole for the update, one set a step.
What the split does not reach (the Mamba2 mixer, the hybrid's ``fuse``)
computes replicated across ``model`` ranks.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch import interop, resolve_device
from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.distributed import collectives, tensor_parallel
from repro_torch.models import model as model_lib
from repro_torch.optim import adamw
from repro_torch.sharding import (batch_axes, mesh_context, mesh_shape,
                                  placements)
from repro_torch.tree import (tree_leaves, tree_leaves_with_path, tree_map,
                              tree_map_with_path)

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


def _grads(loss_of: Callable, trainable: PyTree) -> Tuple[Dict, PyTree]:
    """(detached metrics, gradient tree) of ``loss_of(trainable leaves)``,
    which returns (loss, metrics); an unused leaf's gradient is zeros."""
    leaves = []

    def leaf(p):
        t = p.detach().requires_grad_(True)
        leaves.append(t)
        return t
    tr = tree_map(leaf, trainable)
    loss, metrics = loss_of(tr)
    grads = iter(torch.autograd.grad(loss, leaves, allow_unused=True))
    with torch.no_grad():
        out = tree_map(lambda t: _zero_if_none(next(grads), t), tr)
    return {k: v.detach() for k, v in metrics.items()}, out


def _accumulate(grad_of: Callable, trainable: PyTree, micros: int,
                micro: Callable) -> Tuple[Dict, PyTree]:
    """(metrics, gradients) of ``grad_of(micro(i))`` over ``micros``
    microbatches: their mean loss and mean fp32 gradients, or the one
    microbatch's metrics and gradients as they come."""
    if micros == 1:
        return grad_of(micro(0))
    gsum = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                    trainable)
    lsum = torch.zeros((), dtype=torch.float32,
                       device=tree_leaves(trainable)[0].device)
    for i in range(micros):
        m, g = grad_of(micro(i))
        gsum = tree_map(torch.add, gsum, g)
        lsum = lsum + m["loss"]
    return {"loss": lsum / micros}, tree_map(lambda g: g / micros, gsum)


def make_train_step(cfg: ModelConfig, tc: TrainConfig,
                    moe_impl: str = "capacity", mesh=None,
                    rules=None) -> Callable:
    """Returns ``train_step(state, batch) -> (state, metrics)``.  ``batch``
    holds ``tokens`` and ``labels`` (B, S) as numpy arrays or tensors; they
    move to the state's device.  Metrics are 0-d tensors (no host sync),
    the MoE aux loss under ``"aux"``; ``moe_impl`` is the MoE layers'
    dispatch ("capacity" or "dense").  With a live ``mesh`` and its
    ``rules`` it is the sharded step (module docstring): ``state`` is this
    rank's blocks (:func:`shard_state`), ``batch`` the global batch, of
    which this rank computes its rows, and the metrics are global."""
    schedule = adamw.make_schedule(tc.schedule, tc.learning_rate, tc.steps,
                                   tc.warmup_ratio)

    if mesh is not None:
        return _sharded_step(cfg, tc, moe_impl, mesh, rules, schedule)

    def grad_of(state: TrainState, batch) -> Tuple[Dict, PyTree]:
        return _grads(lambda tr: model_lib.loss_fn(
            adamw.combine(tr, state.frozen), batch, cfg, moe_impl),
            state.trainable)

    def train_step(state: TrainState, batch: Dict) -> Tuple[TrainState, Dict]:
        dev = _device_of(state)
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        mb = tc.microbatches
        metrics, grads = _accumulate(
            lambda micro: grad_of(state, micro), state.trainable, mb,
            lambda i: {k: v.reshape(mb, v.shape[0] // mb, *v.shape[1:])[i]
                       for k, v in batch.items()} if mb > 1 else batch)
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


# ---------------------------------------------------------------------------
# the sharded train state and step
# ---------------------------------------------------------------------------

def state_shardings(cfg: ModelConfig, tc: TrainConfig, mesh, rules,
                    seed: Optional[int] = None):
    """``(placements, abstract)``: a :class:`TrainState` of
    :class:`repro_torch.sharding.Placements` (one a leaf, from the logical
    param axes and the rules, divisibility fallback included) and the
    abstract state (meta tensors, full shapes), the reference's
    ``state_shardings``.  ``mesh`` may be a live mesh or a size mapping;
    ``seed`` only names the init (shapes do not depend on it)."""
    abstract = init_train_state(cfg, tc, seed=tc.seed if seed is None
                                else seed, device="meta")
    params_abs = adamw.combine(abstract.trainable, abstract.frozen)
    axes = model_lib.param_axes(cfg, params_abs)
    mask = model_lib.trainable_mask(cfg, params_abs, tc.full_finetune)
    tr_axes, fr_axes = adamw.partition(axes, mask)

    def mk(leaf, ax):
        return placements(mesh, rules, tuple(ax), leaf.shape)
    tr_sh = tree_map(mk, abstract.trainable, tr_axes)
    rep = placements(mesh, rules, ())
    opt_sh = adamw.AdamWState(step=rep,
                              mu=tree_map(mk, abstract.opt.mu, tr_axes),
                              nu=tree_map(mk, abstract.opt.nu, tr_axes))
    return TrainState(step=rep, trainable=tr_sh,
                      frozen=tree_map(mk, abstract.frozen, fr_axes),
                      opt=opt_sh), abstract


def shard_state(state: PyTree, shardings: PyTree, mesh) -> PyTree:
    """This rank's block of every leaf of ``state`` (full tensors) on the
    live ``mesh``; a leaf nothing splits stays the same tensor."""
    return tree_map(lambda t, pl: collectives.shard(t, pl, mesh), state,
                    shardings)


def gather_state(state: PyTree, shardings: PyTree, mesh) -> PyTree:
    """The full tensors of a sharded ``state`` (collective: every rank of
    the mesh calls it; its all-gathers are tagged ``"state"``)."""
    return tree_map(lambda t, pl: collectives.gather(t, pl, mesh,
                                                     tag="state"),
                    state, shardings)


def _rows(v: torch.Tensor, micro: int, micros: int, k: int,
          n: int) -> torch.Tensor:
    """This rank's rows (block ``k`` of ``n``) of microbatch ``micro`` of
    the global batch ``v``."""
    b = v.shape[0] // micros
    if b % n:
        raise ValueError(f"a microbatch of {b} rows does not split over "
                         f"{n} batch ranks")
    return v[micro * b:(micro + 1) * b][k * (b // n):(k + 1) * (b // n)]


def _reduce_grads(grads: PyTree, dtype: str, mesh,
                  axes: Tuple[str, ...], n: int) -> PyTree:
    """The gradients summed over the ranks of ``axes`` (``n`` of them),
    one flat all-reduce per dtype, in the wire dtype of
    ``grad_allreduce_dtype``.  ``"bfloat16"``: the bf16 casts cross the
    wire.  ``"int8"``: one all-reduce (max) of every leaf's largest
    magnitude first, then each rank sends ``round(g / s)`` with ``s = max
    / (127 // n)``, so the sum of n ranks stays within [-127, 127]; the
    sum times ``s`` comes back (at one rank, the unsharded step's
    ``_compress``).  Bytes a step: 2 (bf16), 1 (int8) or 4 (fp32) per
    trainable element, plus 4 per leaf for int8's maxima."""
    paths_leaves = tree_leaves_with_path(grads)
    if not paths_leaves:
        return grads
    leaves = [g for _, g in paths_leaves]
    if dtype == "int8":
        lim = 127 // n
        if lim < 1:
            raise ValueError(f"int8 gradients cannot sum over {n} ranks")
        peak = torch.stack([g.abs().max().float() for g in leaves])
        collectives.all_reduce(peak, mesh, axes,
                               torch.distributed.ReduceOp.MAX, tag="grads")
        scales = torch.clamp(peak, min=1e-12) / lim
        flat = torch.cat([torch.clamp(torch.round(g / s), -lim, lim).to(
            torch.int8).reshape(-1) for g, s in zip(leaves, scales)])
        collectives.all_reduce(flat, mesh, axes, tag="grads")
        parts = flat.split([g.numel() for g in leaves])
        out = [(q.to(torch.float32) * s).to(g.dtype).reshape(g.shape)
               for q, s, g in zip(parts, scales, leaves)]
    elif dtype in ("", "bfloat16"):
        out = [None] * len(leaves)
        by_dtype: Dict[torch.dtype, list] = {}
        for i, g in enumerate(leaves):
            by_dtype.setdefault(g.dtype, []).append(i)
        for gdt, idx in by_dtype.items():
            wire = torch.bfloat16 if dtype == "bfloat16" else gdt
            flat = torch.cat([leaves[i].to(wire).reshape(-1) for i in idx])
            collectives.all_reduce(flat, mesh, axes, tag="grads")
            for i, part in zip(idx, flat.split([leaves[i].numel()
                                                for i in idx])):
                out[i] = part.to(gdt).reshape(leaves[i].shape)
    else:
        raise ValueError(dtype)
    got = dict(zip((p for p, _ in paths_leaves), out))
    return tree_map_with_path(lambda p, _g: got[p], grads)


def _sum_grads(grads: PyTree, dtype: str, mesh, axes: Tuple[str, ...],
               n: int, tp) -> PyTree:
    """The gradients summed over the batch ``axes`` (``n`` ranks) and,
    where the compute split ``tp`` leaves a leaf's gradient partial on
    each rank (:meth:`TensorParallel.grad_summed`), over ``model`` too,
    in a second reduction set over ``axes`` and ``model`` (``n`` times
    the ``model`` size ranks, int8's headroom counted over all of
    them)."""
    if tp is None:
        return _reduce_grads(grads, dtype, mesh, axes, n)
    summed = tree_map_with_path(lambda p, _g: tp.grad_summed(p), grads)
    part, whole = adamw.partition(grads, summed)
    whole = _reduce_grads(whole, dtype, mesh, axes, n)
    part = _reduce_grads(part, dtype, mesh, axes + (tensor_parallel.AXIS,),
                         n * tp.size)
    return adamw.combine(part, whole)


def _sharded_step(cfg: ModelConfig, tc: TrainConfig, moe_impl: str, mesh,
                  rules, schedule) -> Callable:
    shardings, _ = state_shardings(cfg, tc, mesh, rules)
    split = {path: pl for path, pl in tree_leaves_with_path(shardings.frozen)
             if not pl.is_replicated}
    axes = batch_axes(mesh, rules)
    k, n = collectives.coordinate(mesh, tuple(
        (a, mesh_shape(mesh)[a]) for a in axes))
    aux_w = cfg.moe.aux_loss_weight if cfg.family == "moe" else 0.0
    tp = tensor_parallel.plan(cfg, mesh, rules, serving=False)

    def gather(tree, prefix):
        def one(path, t):
            pl = split.get(prefix + path)
            return t if pl is None else collectives.gather(
                t, pl, mesh, tensor_parallel.kept_axes(
                    tp is not None and tp.vocab, prefix + path,
                    tp is not None and tp.experts), tag="frozen")
        return tree_map_with_path(one, tree)

    def objective(tr, frozen, micro):
        """This rank's share of the global loss: its token sum over the
        global token count (and 1/n of the MoE aux loss, which every rank
        computes over the global batch), so that the gradients summed over
        the batch ranks are the global loss's."""
        cnt = (micro["labels"] >= 0).sum(dtype=torch.int32)
        total = collectives.all_reduce(cnt.clone(), mesh, axes)
        loss, m = model_lib.loss_fn(adamw.combine(tr, frozen), micro, cfg,
                                    moe_impl, gather, tp)
        share = cnt.to(torch.float32) / total.to(torch.float32)
        if aux_w:
            obj = (loss - aux_w * m["aux"]) * share + aux_w * m["aux"] / n
        else:
            obj = loss * share
        return obj, {"loss": obj, "aux": m["aux"], "tokens": total}

    def train_step(state: TrainState, batch: Dict) -> Tuple[TrainState, Dict]:
        dev = _device_of(state)
        batch = {k_: torch.as_tensor(v, device=dev) for k_, v in batch.items()}
        tr = gather_state(state.trainable, shardings.trainable, mesh)
        mb = tc.microbatches
        with mesh_context(mesh, rules):
            metrics, grads = _accumulate(
                lambda micro: _grads(
                    lambda t: objective(t, state.frozen, micro), tr),
                tr, mb,
                lambda i: {k_: _rows(v, i, mb, k, n)
                           for k_, v in batch.items()})
        metrics["loss"] = collectives.all_reduce(metrics["loss"].clone(),
                                                 mesh, axes)
        grads = _sum_grads(grads, tc.grad_allreduce_dtype, mesh, axes, n, tp)
        lr = schedule(state.step)
        opt = gather_state(state.opt, shardings.opt, mesh)
        new_tr, new_opt, opt_metrics = adamw.adamw_update(
            grads, opt, tr, lr,
            beta1=tc.beta1, beta2=tc.beta2, eps=tc.eps,
            weight_decay=tc.weight_decay, grad_clip_norm=tc.grad_clip_norm)
        metrics = {**metrics, **opt_metrics, "lr": lr,
                   "loss": metrics["loss"]}
        return TrainState(
            state.step + 1, shard_state(new_tr, shardings.trainable, mesh),
            state.frozen, shard_state(new_opt, shardings.opt, mesh)), metrics

    return train_step
