"""The dry-run of the port: every (arch x shape x production mesh) cell's
per-device bytes (params, optimizer state, cache), analytic FLOPs and the
bytes its collectives move, from the abstract trees (meta tensors: nothing
is allocated or run) and the sharding rules.

    PYTHONPATH=src python -m repro_torch.launch.dryrun [--arch A] \
        [--shape S] [--multi-pod] [--full-ft] [--out FILE]

The reference lowers and compiles each cell with XLA for TPU v5e and reads
its memory and cost analyses; the port has no such compiler, so a cell is
counted from its design instead:

- bytes: each leaf's block on one device (:class:`repro_torch.sharding.
  Placements`), params (trainable and frozen), AdamW's two moments of the
  trainable leaves, and a serving cell's decode cache;
- collectives, the sharded train step's (:mod:`repro_torch.train.trainer`):
  every split frozen leaf is all-gathered at its use, a layer's once in the
  forward and once more in its remat recompute, the rest once a step,
  except over ``model`` where the compute splits: the embedding and the
  head keep their vocabulary rows, the expert stacks their experts; the
  split trainable leaves and their moments are gathered once a step; the
  trainable gradients are all-reduced over the batch axes, and those the
  split leaves partial over ``model`` too.  The split itself
  (:func:`repro_torch.distributed.tensor_parallel.step_collectives`) sums
  each row-split o and down over ``model`` in the forward (o again in the
  recompute), each split block input's gradient in the backward, the
  vocab-parallel lookup and the head's input gradient, an MoE layer's
  expert outputs and its dispatch input's and gates' gradients, and
  three small reductions a loss chunk.  A serving cell (one prefill, or
  one decode step) gathers its frozen weights over the batch axes once
  (``fsdp``), keeps what the split consumes split over ``model``, and
  makes the split's own collectives
  (:func:`repro_torch.distributed.tensor_parallel.serve_collectives`):
  the o and down sums, the vocab-parallel lookup, the logits gather, the
  expert-parallel sums, each split Mamba2 layer's norm and out_proj
  sums and, over a cache split over its sequence, the decode's combine.  A ring all-gather brings each device ``(n - 1)``
  blocks per axis of ``n``, a ring all-reduce moves ``2 (n - 1) / n`` of
  the tensor;
- reads: the whole (gathered) weights once per pass over them (forward,
  remat recompute and backward in training); in a serving cell a device
  reads its slices of the linears the split divides and the others
  whole, plus its block of the cache in decode (``cache_axes`` under
  ``rules_for``'s layout: kv heads, or the sequence where they do not
  divide; the Mamba2 states in the layout the port holds, a rank's SSM
  heads and its ``[x_r, B_g, C_g]`` conv channels where a serving split
  splits the mixer, else whole);
- FLOPs per device: the batch splits over the batch axes (where it
  divides), and the products the compute split divides
  (:func:`split_share` of N_active: the ``"col"`` and ``"row"`` linears,
  the expert stacks when the experts split, the head when the vocabulary
  splits, a serving cell's Mamba2 ``in_proj`` columns that divide and
  ``out_proj``) over ``model`` as well; the rest (the training step's
  Mamba2 mixer, linears a fallback leaves replicated, the B and C columns
  every rank computes) computes replicated across ``model``.

:mod:`repro_torch.launch.roofline` turns a cell into H100 times.
"""
from __future__ import annotations

import argparse
import json
import math
from typing import Dict, List, Optional

import torch

from repro_torch.configs import (ASSIGNED_ARCHS, LM_SHAPES, TrainConfig,
                                 get_config, shape_applicable, torch_dtype)
from repro_torch.data.pipeline import make_input_specs
from repro_torch.distributed import tensor_parallel
from repro_torch.launch.mesh import make_production_mesh, rules_for
from repro_torch.models import model as model_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.optim import adamw
from repro_torch.sharding import (Placements, batch_axes, logical_spec,
                                  placements)
from repro_torch.train import trainer
from repro_torch.tree import tree_leaves_with_path, tree_map


def model_param_stats(arch: str) -> Dict[str, float]:
    """N (dense-equivalent) and N_active of the merged (serving) config,
    split by role: the reference's ``model_param_stats``."""
    cfg = get_config(arch)
    cfg = cfg.replace(peft=cfg.peft.replace(method="none"))
    embed = expert = backbone = 0
    for path, leaf in tree_leaves_with_path(model_lib.abstract_params(cfg)):
        n = leaf.numel()
        if "embed" in path or "lm_head" in path:
            embed += n
        elif "moe" in path and "shared" not in path and path[-2] in (
                "up", "down", "gate"):
            expert += n
        else:
            backbone += n
    e, k = cfg.moe.num_experts, cfg.moe.top_k
    active_expert = expert * (k / e) if e else 0
    return {"N_total": embed + expert + backbone,
            "N": backbone + expert + embed / 2,
            "N_active": backbone + active_expert + embed / 2}


def in_proj_share(cfg, n: int) -> float:
    """The share of a Mamba2 ``in_proj``'s columns that a split of its
    mixer over ``n`` ranks divides: its z, x and dt heads, and B and C
    where the groups divide (a rank computes ``(1 - f) + f / n`` of the
    columns for a share ``f``)."""
    whole = ssm_lib.ssm_dims(cfg)["in_proj_out"]
    local = ssm_lib.split_dims(cfg, 0, n)["in_proj_out"]
    return (1 - local / whole) * n / (n - 1)


def _split_fraction(kinds, vocab: bool, path, in_proj: float = 1.0
                    ) -> float:
    """The share of the leaf at ``path`` whose products the compute split
    divides over ``model`` under ``kinds`` and ``vocab``: all of a
    ``"col"`` or ``"row"`` linear's (``in_proj`` of a Mamba2 mixer: the
    share ``in_proj``), of a split expert stack's, of the embedding and the
    head where the vocabulary splits; none else."""
    if tuple(path[:1]) in (("embed",), ("lm_head",)):
        return 1.0 if vocab else 0.0
    module = tensor_parallel.reached_module(path)
    if kinds.get(module) not in ("col", "row", "split"):
        return 0.0
    return in_proj if module == "in_proj" else 1.0


def _in_proj(cfg, kinds, n: int) -> float:
    """:func:`in_proj_share` where ``kinds`` split the mixer, else 1."""
    return in_proj_share(cfg, n) if kinds.get("in_proj") == "col" else 1.0


def split_share(cfg, mesh, rules, n_active: float,
                serving: bool = False) -> float:
    """The share of ``n_active`` (:func:`model_param_stats`) whose products
    the compute split divides over ``model`` on ``mesh`` under ``rules``:
    the linears :func:`tensor_parallel.plan_linears` makes ``"col"`` or
    ``"row"`` (in a ``serving`` cell the Mamba2 mixer's too, ``in_proj``
    at :func:`in_proj_share`), the expert stacks (their active top-k of E)
    when the experts split, and the head when the vocabulary splits; 0 on
    a ``model`` axis of one rank."""
    n = mesh.get(tensor_parallel.AXIS, 1)
    if n == 1:
        return 0.0
    kinds, vocab = tensor_parallel.plan_linears(cfg, mesh, rules, serving)
    in_proj = _in_proj(cfg, kinds, n)
    merged = cfg.replace(peft=cfg.peft.replace(method="none"))
    active = cfg.moe.top_k / cfg.moe.num_experts if cfg.family == "moe" \
        else 1.0
    split = 0
    for path, leaf in tree_leaves_with_path(
            model_lib.abstract_params(merged)):
        share = _split_fraction(kinds, vocab, path, in_proj) * leaf.numel()
        if "embed" in path or "lm_head" in path:
            share /= 2
        elif tensor_parallel.reached_module(path) == "expert":
            share *= active
        split += share
    return split / n_active


def _block_bytes(t, pl: Placements) -> int:
    return math.prod(pl.local_shape(t.shape)) * t.element_size()


def _gather_bytes(t, pl: Placements, out: Dict[str, float],
                  times: int = 1, keep=()) -> None:
    """Add to ``out`` (per axis) the bytes a device receives putting ``t``
    together, ``times`` times: each axis's ring all-gather, innermost
    first, brings (n - 1) of the blocks it starts from; the axes in
    ``keep`` stay split."""
    block = _block_bytes(t, pl)
    for _, axes in sorted(pl.dim_axes().items()):
        for name, size in reversed(axes):
            if name in keep:
                continue
            out[name] = out.get(name, 0.0) + times * (size - 1) * block
            block *= size


#: the split's collectives that are all-gathers, and those in fp32
_GATHER_TAGS = ("gather_from", "logits", "seq_q")
_FP32_TAGS = ("ce_max", "ce_sum", "ce_gold", "seq_max", "seq_sum",
              "ssm_norm")


def _tag_bytes(tag: str, elements: int, n: int, act: int) -> float:
    """Bytes a device moves for one of the split's collectives over ``n``
    ranks: ``n - 1`` blocks of an all-gather, ``2 (n - 1) / n`` of an
    all-reduced tensor (fp32 or the compute dtype's ``act`` bytes)."""
    if tag in _GATHER_TAGS:
        return (n - 1) * elements * act
    return 2 * (n - 1) / n * elements * (4 if tag in _FP32_TAGS else act)


def _split_bytes(cfg, tc, mesh, rules, st, inputs, out: Dict[str, float],
                 wire: int) -> None:
    """Add to ``out["model"]`` the bytes a device moves over ``model`` for
    the compute split in one step: the split's all-reduces (ring, ``2 (n -
    1) / n`` of each (tokens, d_model) tensor in the compute dtype, of
    the cross-entropy's fp32 rows), its all-gathers (``n - 1`` blocks) and
    the sum of the gradients it leaves partial."""
    n = mesh.get(tensor_parallel.AXIS, 1)
    if n == 1:
        return
    kinds, vocab = tensor_parallel.plan_linears(cfg, mesh, rules)
    rows = inputs["tokens"][0] // math.prod(
        mesh[a] for a in batch_axes(mesh, rules))
    act = torch_dtype(cfg.dtype).itemsize
    total = 0.0
    for tag, elements in tensor_parallel.step_collectives(
            cfg, kinds, vocab, n, rows, inputs["tokens"][1],
            src_seq=inputs.get("src_embeds", (0, 0))[1],
            patches=inputs.get("patch_embeds", (0, 0))[1],
            full_finetune=tc.full_finetune):
        total += _tag_bytes(tag, elements, n, act)
    partial = sum(t.numel() for path, t in tree_leaves_with_path(
        st.trainable) if tensor_parallel.grad_summed(kinds, vocab, path))
    total += 2 * (n - 1) / n * partial * wire
    out[tensor_parallel.AXIS] = out.get(tensor_parallel.AXIS, 0.0) + total


def _cache_block_bytes(path, t, pl: Placements, states) -> int:
    """A device's bytes of the cache leaf ``t`` at ``path``: its block
    under ``pl``, except the Mamba2 states, whose batch rows follow ``pl``
    and whose heads and conv channels are the ones the port holds (the
    mixer dims ``states``: a rank's share, or the whole)."""
    shape = list(pl.local_shape(t.shape))
    if path[-1] == "conv_state":
        shape[-1] = states["conv_ch"]
    elif path[-1] == "ssm_state":
        shape[-3] = states["heads"]
    return math.prod(shape) * t.element_size()


def _tree_bytes(tree, shardings) -> int:
    return sum(_block_bytes(t, pl) for (_, t), (_, pl) in zip(
        tree_leaves_with_path(tree), tree_leaves_with_path(shardings)))


def _shardings(tree, axes, mesh, rules):
    return tree_map(lambda t, a: placements(mesh, rules, tuple(a), t.shape),
                    tree, axes)


def _train_cell(cfg, tc, mesh, rules, rec):
    sh, st = trainer.state_shardings(cfg, tc, mesh, rules)
    kinds, vocab = tensor_parallel.plan_linears(cfg, mesh, rules)
    split = mesh.get(tensor_parallel.AXIS, 1) > 1
    rec["param_bytes"] = _tree_bytes(st.trainable, sh.trainable) + \
        _tree_bytes(st.frozen, sh.frozen)
    rec["opt_bytes"] = _tree_bytes(st.opt.mu, sh.opt.mu) + \
        _tree_bytes(st.opt.nu, sh.opt.nu)
    rec["cache_bytes"] = 0
    coll: Dict[str, float] = {}
    layer_passes = 1 if cfg.remat_policy == "none" else 2
    for (path, t), (_, pl) in zip(tree_leaves_with_path(st.frozen),
                                  tree_leaves_with_path(sh.frozen)):
        _gather_bytes(t, pl, coll, layer_passes
                      if path[0] in model_lib.LAYER_TREES else 1,
                      tensor_parallel.kept_axes(
                          split and vocab, path,
                          split and kinds.get("expert") == "split"))
    for tree, shs in ((st.trainable, sh.trainable), (st.opt.mu, sh.opt.mu),
                      (st.opt.nu, sh.opt.nu)):
        for (_, t), (_, pl) in zip(tree_leaves_with_path(tree),
                                   tree_leaves_with_path(shs)):
            _gather_bytes(t, pl, coll)
    wire = {"": 4, "bfloat16": 2, "int8": 1}[tc.grad_allreduce_dtype]
    n_train = sum(t.numel() for _, t in tree_leaves_with_path(st.trainable))
    for a in batch_axes(mesh, rules):
        n = mesh[a]
        coll[a] = coll.get(a, 0.0) + 2 * (n - 1) / n * n_train * wire
    _split_bytes(cfg, tc, mesh, rules, st, rec["inputs"], coll, wire)
    rec["collective_bytes"] = coll
    full = sum(t.numel() * t.element_size() for _, t in tree_leaves_with_path(
        adamw.combine(st.trainable, st.frozen)))
    rec["read_bytes_per_device"] = full * (layer_passes + 1)


def _batch_rows(shape, mesh, rules) -> int:
    """The ranks the rules split ``shape``'s batch over (1 where the
    divisibility fallback replicates it)."""
    spec = logical_spec(mesh, rules, ("batch",), (shape.global_batch,))[0]
    axes = (spec,) if isinstance(spec, str) else tuple(spec or ())
    return math.prod(mesh[a] for a in axes)


def _serve_cell(cfg, shape, mesh, rules, rec):
    scfg = cfg.replace(peft=cfg.peft.replace(method="none"))
    params = model_lib.abstract_params(scfg)
    sh = _shardings(params, model_lib.param_axes(scfg, params), mesh, rules)
    rec["param_bytes"] = _tree_bytes(params, sh)
    rec["opt_bytes"] = 0
    n = mesh.get(tensor_parallel.AXIS, 1)
    kinds, vocab = tensor_parallel.plan_linears(scfg, mesh, rules, True)
    vocab, experts = n > 1 and vocab, n > 1 and kinds.get("expert") == "split"
    mixer = n > 1 and kinds.get("in_proj") == "col"
    in_proj = _in_proj(scfg, kinds, n) if n > 1 else 1.0
    coll: Dict[str, float] = {}
    read = 0.0
    for (path, t), (_, pl) in zip(tree_leaves_with_path(params),
                                  tree_leaves_with_path(sh)):
        _gather_bytes(t, pl, coll, keep=tensor_parallel.kept_axes(
            vocab, path, experts))
        frac = _split_fraction(kinds, vocab, path, in_proj) if n > 1 \
            else 0.0
        read += t.numel() * t.element_size() * (1 - frac + frac / n)
    decode = shape.kind == "decode"
    inputs = rec["inputs"]
    rows = shape.global_batch // _batch_rows(shape, mesh, rules)
    rec["cache_bytes"] = 0
    cache_kind = tensor_parallel.cache_layout(scfg, mesh, rules, kinds)
    if n > 1:
        act = torch_dtype(scfg.dtype).itemsize
        coll[tensor_parallel.AXIS] = coll.get(tensor_parallel.AXIS, 0.0) + sum(
            _tag_bytes(tag, elements, n, act) for tag, elements in
            tensor_parallel.serve_collectives(
                scfg, kinds, vocab, cache_kind, n, rows,
                1 if decode else inputs["tokens"][1], decode,
                src_seq=inputs.get("src_embeds", (0, 0))[1],
                patches=inputs.get("patch_embeds", (0, 0))[1]))
    rec["collective_bytes"] = coll
    if decode:
        b = shape.global_batch
        length = shape.seq_len // 2 if scfg.is_encoder_decoder \
            else shape.seq_len
        cache = model_lib.init_cache(scfg, b, length, device="meta")
        if scfg.family == "audio":
            # the cross K/V a prefill builds, one row of source a token
            cshape = (scfg.num_layers, b, length, scfg.num_kv_heads,
                      scfg.resolved_head_dim)
            cache = {"self": cache["self"], "cross": {
                k: torch.empty(cshape, dtype=torch_dtype(scfg.dtype),
                               device="meta") for k in ("k", "v")}}
        csh = _shardings(cache, model_lib.cache_axes(scfg, cache), mesh,
                         rules)
        states = None
        if scfg.family in tensor_parallel.MIXER_FAMILIES:
            states = ssm_lib.split_dims(scfg, 0, n) if mixer \
                else ssm_lib.ssm_dims(scfg)
        rec["cache_bytes"] = sum(
            _cache_block_bytes(path, t, pl, states) for (path, t), (_, pl)
            in zip(tree_leaves_with_path(cache), tree_leaves_with_path(csh)))
    rec["cache_split"] = cache_kind if n > 1 else None
    rec["read_bytes_per_device"] = read + rec["cache_bytes"]


def run_cell(arch: str, shape_name: str, multi_pod: bool = False,
             full_ft: bool = False, stats: Optional[Dict] = None) -> Dict:
    """One cell's counts (see the module docstring); ``stats`` caches
    :func:`model_param_stats` by arch."""
    shape = LM_SHAPES[shape_name]
    cfg = get_config(arch)
    mesh = make_production_mesh(multi_pod=multi_pod)
    rec: Dict = {"arch": arch, "shape": shape_name, "mesh": mesh,
                 "mesh_name": "x".join(str(v) for v in mesh.values()),
                 "full_ft": full_ft, "dtype": cfg.dtype}
    ok, reason = shape_applicable(cfg, shape)
    if not ok:
        rec["skipped"] = reason
        return rec
    rules = rules_for(cfg, mesh, shape.kind)
    rec["inputs"] = {k: list(v.shape)
                     for k, v in make_input_specs(cfg, shape).items()}
    if shape.kind == "train":
        _train_cell(cfg, TrainConfig(full_finetune=full_ft), mesh, rules, rec)
    else:
        _serve_cell(cfg, shape, mesh, rules, rec)
    rec["resident_bytes"] = rec["param_bytes"] + rec["opt_bytes"] + \
        rec["cache_bytes"]
    stats = {} if stats is None else stats
    if arch not in stats:
        stats[arch] = model_param_stats(arch)
    tokens = shape.global_batch * (1 if shape.kind == "decode"
                                   else shape.seq_len)
    mult = 6.0 if shape.kind == "train" else 2.0
    rec["model_flops"] = mult * stats[arch]["N_active"] * tokens
    # the batch splits over the batch axes (where it divides); the
    # products the compute split divides over "model" (split_share of
    # N_active) split there too, the rest computes replicated across its
    # ranks
    share = split_share(cfg, mesh, rules, stats[arch]["N_active"],
                        shape.kind != "train")
    rows = math.prod(mesh[a] for a in batch_axes(mesh, rules)) \
        if shape.kind == "train" else _batch_rows(shape, mesh, rules)
    rec["split_share"] = share
    rec["flops_per_device"] = rec["model_flops"] / rows * (
        share / mesh.get(tensor_parallel.AXIS, 1) + 1 - share)
    return rec


def all_cells(archs=ASSIGNED_ARCHS, shapes=tuple(LM_SHAPES),
              multi_pod: bool = False, full_ft: bool = False) -> List[Dict]:
    stats: Dict = {}
    return [run_cell(a, s, multi_pod, full_ft, stats)
            for a in archs for s in shapes]


def main(argv=None) -> int:
    from repro_torch.launch import roofline
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--full-ft", action="store_true")
    ap.add_argument("--out", default="", help="write the cells as JSON")
    args = ap.parse_args(argv)
    cells = all_cells([args.arch] if args.arch else ASSIGNED_ARCHS,
                      [args.shape] if args.shape else tuple(LM_SHAPES),
                      args.multi_pod, args.full_ft)
    for c in cells:
        if not c.get("skipped"):
            c["roofline"] = roofline.terms(c)
    for row in roofline.table(cells):
        print(row)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(cells, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
