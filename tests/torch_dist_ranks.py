"""The ranks of tests/test_torch_distributed.py, one process each:

    PYTHONPATH=src python tests/torch_dist_ranks.py GROUP RANK WORLD WORKDIR

joins a gloo process group of WORLD ranks through a file store in WORKDIR,
runs GROUP's scenarios on the CPU and writes this rank's results to
``WORKDIR/GROUP.RANK.pt``.  The test runs :func:`one` in its own process.
This file imports torch, numpy and the port only; the test holds the
results against the reference package and the port's unsharded step.
"""
import contextlib
import os
import sys
import time
from typing import Dict, List, NamedTuple

import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)

from repro_torch import interop  # noqa: E402
from repro_torch.configs import MeshConfig, TrainConfig, get_config  # noqa
from repro_torch.data import SyntheticLMDataset  # noqa: E402
from repro_torch.distributed import collectives  # noqa: E402
from repro_torch.distributed import tensor_parallel  # noqa: E402
from repro_torch.distributed import gpipe_spmd_pipeline  # noqa: E402
from repro_torch.launch.mesh import (  # noqa: E402
    init_distributed, make_local_mesh, make_mesh_from_config, rules_for)
from repro_torch.configs import base as config_base  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.sharding import mesh_context  # noqa: E402
from repro_torch.train import checkpoint, trainer  # noqa: E402
from repro_torch.tree import tree_leaves_with_path  # noqa: E402

#: the reference test's recipe: tiny, 3 steps of 8 x 32 tokens
STEPS, BATCH, SEQ = 3, 8, 32
#: reduced deepseek-moe-16b's sharded steps: 4 x 16 tokens
MOE_STEPS, MOE_BATCH, MOE_SEQ = 2, 4, 16
#: every PEFT method of the registry ("none" trains every leaf)
METHODS = ("none", "psoft", "lora", "pissa", "dora", "lora_xs", "oft",
           "boft", "goft", "qgoft")
REMAT = ("none", "minimal", "full")


def flat(tree):
    return {"/".join(p): t.detach().cpu().numpy()
            for p, t in tree_leaves_with_path(tree)}


def records():
    return [(c.kind, str(c.dtype), c.elements, c.group, c.tag)
            for c in collectives.RECORD]


@contextlib.contextmanager
def captured_grads():
    """Every gradient tree a step hands the optimizer, flattened, in order
    (the steps call ``adamw.adamw_update`` through the module)."""
    got: List[Dict[str, np.ndarray]] = []
    update = adamw.adamw_update

    def capture(grads, *args, **kwargs):
        got.append(flat(grads))
        return update(grads, *args, **kwargs)
    adamw.adamw_update = capture
    try:
        yield got
    finally:
        adamw.adamw_update = update


class Run(NamedTuple):
    losses: List[float]
    grad_norms: List[float]
    grads: Dict[str, np.ndarray]     # step 1's, after every reduction
    records: list
    full: object                     # the final state, whole
    shardings: object
    local: object                    # the final state, this rank's blocks


def tiny_init(work):
    """The reference's initial train state, once the test has saved it
    (the ranks start while the test computes it)."""
    cfg = get_config("tiny")
    tc = TrainConfig(steps=STEPS)
    template = trainer.init_train_state(cfg, tc, device="cpu")
    ckpt = os.path.join(work, "init")
    deadline = time.monotonic() + 120
    while checkpoint.latest_step(ckpt) is None:
        if time.monotonic() > deadline:
            raise TimeoutError(f"no initial state under {ckpt}")
        time.sleep(0.05)
    return cfg, tc, checkpoint.restore(template, ckpt)


def run_steps(step, state, batches):
    """(final state, losses, grad norms, step 1's gradients) of ``step``
    over ``batches``."""
    losses, norms = [], []
    with captured_grads() as grads:
        for b in batches:
            state, m = step(state, b)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
    return state, losses, norms, grads[0]


def run_sharded(cfg, tc, state, mesh, steps=STEPS, batch=BATCH, seq=SEQ,
                moe_impl="dense") -> Run:
    """``steps`` sharded steps from the full ``state``."""
    rules = rules_for(cfg, mesh, "train")
    sh, _ = trainer.state_shardings(cfg, tc, mesh, rules)
    local = trainer.shard_state(state, sh, mesh)
    step = trainer.make_train_step(cfg, tc, moe_impl, mesh=mesh, rules=rules)
    ds = SyntheticLMDataset(cfg, batch, seq)
    collectives.reset()
    local, losses, norms, grads = run_steps(
        step, local, [ds.batch_at(i) for i in range(steps)])
    rec = records()
    return Run(losses, norms, grads, rec, trainer.gather_state(local, sh, mesh),
               sh, local)


def against_unsharded(cfg, tc, state, mesh, steps=1, batch=BATCH, seq=SEQ,
                      moe_impl="dense") -> dict:
    """``steps`` sharded and unsharded steps from ``state``: the sharded
    and the unsharded losses, the largest step-1 gradient difference, the
    largest grad-norm difference, the largest final trainable difference,
    the sharded step-1 gradients (for the test to hold against the
    reference's), the sharded steps' collectives and the split's plan on
    ``mesh``."""
    got = run_sharded(cfg, tc, state, mesh, steps, batch, seq, moe_impl)
    ds = SyntheticLMDataset(cfg, batch, seq)
    plain, losses, norms, grads = run_steps(
        trainer.make_train_step(cfg, tc, moe_impl), state,
        [ds.batch_at(i) for i in range(steps)])
    a, b = flat(got.full.trainable), flat(plain.trainable)
    return dict(
        losses=got.losses, plain=losses,
        grad_diff=max(float(np.abs(got.grads[k] - grads[k]).max())
                      for k in grads),
        norm_diff=max(abs(x - y) for x, y in zip(got.grad_norms, norms)),
        diff=max(float(np.abs(a[k] - b[k]).max()) for k in b),
        grads=got.grads, records=got.records,
        plan=tensor_parallel.plan_linears(cfg, mesh,
                                          rules_for(cfg, mesh, "train")))


def summary(run: Run) -> dict:
    return dict(losses=run.losses, grad_norms=run.grad_norms,
                grads=run.grads, records=run.records,
                trainable=flat(run.full.trainable))


def four(rank, work):
    """(a) three meshes, the split's kv and vocab fallbacks on (1, 4) and
    its serving split's sequence cache and Mamba2 states there, (b) bf16
    and int8 gradients, (c) the elastic restore, (d) GPipe over 4
    stages."""
    cfg, tc, init = tiny_init(work)
    mesh = make_mesh_from_config(MeshConfig(data=2, model=2))
    out = {"mesh_from_config": (mesh.mesh_dim_names, tuple(mesh.shape))}
    meshes = {}
    for shape in ((2, 2), (4, 1), (1, 4)):
        mesh = meshes[shape] = make_local_mesh(*shape)
        run = run_sharded(cfg, tc, init, mesh)
        out[f"{shape[0]}x{shape[1]}"] = summary(run)
        if shape == (2, 2):
            ckpt = os.path.join(work, "ckpt")
            checkpoint.save(run.local, ckpt, STEPS, shardings=run.shardings,
                            mesh=mesh)
            saved = flat(run.full)
    out["fallbacks"] = fallbacks(meshes[(1, 4)])
    out["serve seq"] = serve_cases(meshes[(1, 4)], SERVE_FOUR_ARCHS)
    dist.barrier()
    mesh = meshes[(4, 1)]
    sh, _ = trainer.state_shardings(cfg, tc, mesh, rules_for(cfg, mesh))
    template = trainer.shard_state(init, sh, mesh)
    restored = checkpoint.restore(template, ckpt, shardings=sh, mesh=mesh)
    got = flat(trainer.gather_state(restored, sh, mesh))
    out["elastic"] = dict(
        saved=saved, equal=sorted(got) == sorted(saved) and all(
            got[k].dtype == saved[k].dtype
            and got[k].tobytes() == saved[k].tobytes() for k in saved),
        block_shapes={k: tuple(v.shape) for k, v in flat(restored).items()})
    for dtype in ("bfloat16", "int8"):
        tc_c = TrainConfig(steps=STEPS, grad_allreduce_dtype=dtype)
        out[dtype] = summary(run_sharded(cfg, tc_c, init, mesh))

    # (d) GPipe: stage i holds ws[i]
    z = np.load(os.path.join(work, "gpipe.npz"))
    stage = torch.distributed.device_mesh.init_device_mesh(
        "cpu", (4,), mesh_dim_names=("stage",))
    ws, x = torch.from_numpy(z["ws"]), torch.from_numpy(z["x"])
    w = ws[rank:rank + 1].clone().requires_grad_(True)
    pipe = gpipe_spmd_pipeline(lambda p, h: torch.tanh(h @ p), stage, "stage")
    y = pipe(w, x)
    y.sum().backward()
    grad = collectives.all_gather(w.grad, 0, stage, "stage")
    out["gpipe"] = dict(y=y.detach().numpy(), grad=grad.numpy())
    return out


def moe2(rank, work):
    """(e) reduced deepseek-moe-16b on a (2, 1) mesh: the capacity layer,
    each rank one dispatch group, and sharded train steps; the other
    families' sharded steps (:func:`families`); and on (1, 2) the split
    steps and every family's split serving (:func:`serve_cases`)."""
    cfg = get_config("deepseek-moe-16b").reduced()
    z = np.load(os.path.join(work, "moe.npz"))
    params = interop.params_from_numpy(
        _unflatten({k: z[k] for k in z.files if k != "x"}), device="cpu")
    x = torch.from_numpy(z["x"])
    mesh = make_local_mesh(2, 1)
    with mesh_context(mesh, rules_for(cfg, mesh)):
        y, aux = moe.moe_apply(params, x[rank:rank + 1], cfg, torch.float32,
                               "capacity")
    tc = TrainConfig(steps=MOE_STEPS, learning_rate=1e-2)
    state = trainer.init_train_state(cfg, tc, device="cpu")
    run = run_sharded(cfg, tc, state, mesh, MOE_STEPS, MOE_BATCH, MOE_SEQ,
                      "capacity")
    out = dict(y=y.numpy(), aux=float(aux), losses=run.losses,
               records=run.records, trainable=flat(run.full.trainable),
               families={"2x1": families(mesh, FAMILIES)})
    split = make_local_mesh(1, 2)
    out["1x2"] = summary(run_sharded(*tiny_init(work), split))
    out["families"]["1x2"] = families(split, FAMILIES + SPLIT_FAMILIES)
    out["methods"] = methods(split)
    out["serve"] = serve_cases(split, SERVE_ARCHS)
    return out


#: the families whose sharded steps the (2, 1) and (1, 2) meshes hold
FAMILIES = ("zamba2-1.2b", "seamless-m4t-medium", "internvl2-26b")
#: the families the split leaves replicated in part, on (1, 2) only
SPLIT_FAMILIES = ("deepseek-moe-16b", "mamba2-1.3b")


def family_case(arch):
    """(config, train config, steps, batch, seq, MoE dispatch) of a
    family's sharded step: ``arch`` reduced, one step of 4 x 32 tokens."""
    return (get_config(arch).reduced(),
            TrainConfig(steps=2, learning_rate=1e-2), 1, 4, 32, "capacity")


def method_case(case):
    """(config, train config, steps, batch, seq, MoE dispatch) of a
    :func:`methods` case: ``tiny`` under a PEFT method (one step;
    ``"none"`` fine-tunes every leaf, the embedding and the head
    included) or under ``"remat <policy>"`` (two steps)."""
    base = get_config("tiny")
    if case.startswith("remat "):
        return (base.replace(remat_policy=case.split()[1]),
                TrainConfig(steps=2), 2, BATCH, SEQ, "dense")
    return (base.replace(peft=base.peft.replace(method=case)),
            TrainConfig(steps=2, full_finetune=case == "none"), 1, BATCH,
            SEQ, "dense")


#: the cases of :func:`methods`
METHOD_CASES = METHODS + tuple(f"remat {p}" for p in REMAT)


def _against_unsharded(case, mesh):
    cfg, tc, steps, batch, seq, moe_impl = case
    state = trainer.init_train_state(cfg, tc, device="cpu")
    return against_unsharded(cfg, tc, state, mesh, steps, batch, seq,
                             moe_impl)


def families(mesh, archs):
    """One sharded step of the other families' layer trees (a hybrid's
    list of layers and its shared block, an encoder's and the cross
    block, a VLM's patches, an MoE's expert stacks, a Mamba2 stack) on
    ``mesh``, against the unsharded step on the whole batch, by arch."""
    return {arch: _against_unsharded(family_case(arch), mesh)
            for arch in archs}


def methods(mesh):
    """``tiny`` under every PEFT method and every remat policy
    (:func:`method_case`) on ``mesh``, against the unsharded step."""
    return {case: _against_unsharded(method_case(case), mesh)
            for case in METHOD_CASES}


#: the vocab fallback's vocabulary and pad multiple: every config pads its
#: vocabulary to a multiple of 256, which 4 divides, so the case lowers it
FALLBACK_VOCAB, FALLBACK_PAD = 1022, 2


def fallbacks(mesh):
    """The split's divisibility fallbacks on ``mesh`` (model 4), one step
    each against the unsharded step: ``tiny`` with 2 kv heads (k and v
    replicated, each rank's q head on its kv head), reduced
    seamless-m4t-medium (4 heads, 2 kv heads: the same fallback in its
    encoder, decoder and cross blocks), and ``tiny`` with a vocabulary of
    :data:`FALLBACK_VOCAB` rows padded to :data:`FALLBACK_PAD`
    (embedding and head replicated)."""
    out = {}
    for case in FALLBACKS:
        with fallback_case(case) as spec:
            out[case] = _against_unsharded(spec, mesh)
    return out


#: the cases of :func:`fallbacks`
FALLBACKS = ("kv", "seamless kv", "vocab")


@contextlib.contextmanager
def fallback_case(case):
    """(config, train config, steps, batch, seq, MoE dispatch) of a
    :func:`fallbacks` case, with the vocab case's pad multiple in force
    while the context lasts."""
    base = get_config("tiny")
    if case == "seamless kv":
        yield family_case("seamless-m4t-medium")
        return
    if case == "kv":
        yield (base.replace(num_kv_heads=2), TrainConfig(steps=2), 1, BATCH,
               SEQ, "dense")
        return
    pad = config_base.VOCAB_PAD_MULTIPLE
    config_base.VOCAB_PAD_MULTIPLE = FALLBACK_PAD
    try:
        yield (base.replace(vocab_size=FALLBACK_VOCAB), TrainConfig(steps=2),
               1, BATCH, SEQ, "dense")
    finally:
        config_base.VOCAB_PAD_MULTIPLE = pad


#: the split serving cases: every family on (1, 2), reduced; and reduced
#: llama32-3b on (1, 4), whose 2 kv heads fall back to the sequence cache,
#: and reduced mamba2-1.3b there (8 SSM heads, 2 a rank)
SERVE_ARCHS = ("llama32-3b", "deepseek-moe-16b", "internvl2-26b",
               "seamless-m4t-medium", "mamba2-1.3b", "zamba2-1.2b")
SERVE_SEQ_ARCH = "llama32-3b"
SERVE_FOUR_ARCHS = (SERVE_SEQ_ARCH, "mamba2-1.3b")
#: prompts, their padded length, the cache's length, decode steps
SERVE_BATCH, SERVE_PROMPT, SERVE_MAX_LEN, SERVE_STEPS = 2, 16, 32, 4


def serve_case(arch):
    """(config, params, prefill batch (numpy), lengths or None, decode
    tokens (steps, B, 1)) of a split serving case: ``arch`` reduced in
    fp32, its params from seed 1 with every PSOFT trainable moved off its
    init, a right-padded batch of :data:`SERVE_BATCH` prompts (the
    recurrent families' at full length), and fixed decode tokens the
    split and the unsharded runs (and the reference) are all fed."""
    from repro_torch.models import model
    cfg = get_config(arch).reduced()
    params = model.init_params(cfg, seed=1, device="cpu")
    rng = np.random.default_rng(7)
    for path, t in tree_leaves_with_path(params):
        if path[-1] in ("q", "alpha", "beta"):
            t.add_(torch.from_numpy(0.05 * rng.standard_normal(
                tuple(t.shape)).astype(np.float32)))
    batch = SyntheticLMDataset(cfg, SERVE_BATCH, SERVE_PROMPT).batch_at(3)
    batch.pop("labels")
    lengths = None
    if cfg.family not in ("ssm", "hybrid"):
        extra = batch["patch_embeds"].shape[1] if "patch_embeds" in batch \
            else 0
        lengths = np.array([SERVE_PROMPT, SERVE_PROMPT - 5]) + extra
    toks = rng.integers(0, cfg.vocab_size,
                        (SERVE_STEPS, SERVE_BATCH, 1)).astype(np.int32)
    return cfg, params, batch, lengths, toks


def serve_positions(batch, lengths, step):
    """Each row's decode position at ``step``."""
    if lengths is None:
        return np.full((SERVE_BATCH,), batch["tokens"].shape[1] + step)
    return np.asarray(lengths) + step


def state_leaves(cache) -> dict:
    """The Mamba2 decode states of a cache (the port's or the
    reference's) by name: ``conv_state`` and ``ssm_state`` of a stacked
    SSM cache, ``<layer>/conv_state`` and ``<layer>/ssm_state`` of a
    hybrid's per-layer list; none for an attention cache."""
    if isinstance(cache, dict):
        return {k: cache[k] for k in ("conv_state", "ssm_state")
                if k in cache}
    return {f"{i}/{k}": c[k] for i, c in enumerate(cache)
            if "conv_state" in c for k in ("conv_state", "ssm_state")}


def serve_run(cfg, params, batch, lengths, toks, tp=None):
    """(the prefill's and every decode step's logits (numpy), the cache's
    K/V buffer shapes, its final Mamba2 states (:func:`state_leaves`)) of
    a prefill and :data:`SERVE_STEPS` decode steps, under the serving
    split ``tp`` or unsharded."""
    from repro_torch.models import model
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    ln = None if lengths is None else torch.as_tensor(lengths)
    with torch.no_grad():
        logits, cache = model.prefill(params, tb, cfg, SERVE_MAX_LEN, ln,
                                      tp=tp)
        out = [logits.numpy()]
        for j in range(SERVE_STEPS):
            logits, cache = model.decode_step(
                params, {"tokens": torch.as_tensor(toks[j])}, cache,
                torch.as_tensor(serve_positions(batch, lengths, j)), cfg,
                tp=tp)
            out.append(logits.numpy())
    shapes = sorted({tuple(t.shape) for p, t in tree_leaves_with_path(cache)
                     if p[-1] in ("k", "v")})
    return np.stack(out), shapes, state_leaves(cache)


def serve_cases(mesh, archs):
    """Each arch's split prefill and decode steps on ``mesh`` against the
    unsharded run in this process: the largest logits difference, the
    split's logits (for the test to hold against the reference's pinned
    digests), its cache's K/V shapes, its collectives over ``model`` and
    the plan's cache layout; with Mamba2 layers also each state's shape
    on this rank and whole, the states gathered from every rank's blocks
    (``ssm.gather_state_blocks``, through ``all_gather_object``, which
    :data:`collectives.RECORD` does not see) and their largest difference
    from the unsharded run's, relative to its largest magnitude."""
    from repro_torch.models import ssm
    out = {}
    for arch in archs:
        cfg, params, batch, lengths, toks = serve_case(arch)
        rules = rules_for(cfg, mesh, "decode")
        tp = tensor_parallel.plan(cfg, mesh, rules)
        want, whole, want_states = serve_run(cfg, params, batch, lengths,
                                             toks)
        collectives.reset()
        got, shapes, states = serve_run(cfg, params, batch, lengths, toks,
                                        tp)
        out[arch] = dict(diff=float(np.abs(got - want).max()), logits=got,
                         shapes=shapes, whole_shapes=whole,
                         records=records(), cache=tp.cache,
                         kinds=dict(tp.kinds), vocab=tp.vocab)
        if not states:
            continue
        blocks = [None] * tp.size
        dist.all_gather_object(blocks, states)
        layers = sorted({k.rsplit("/", 1)[0] for k in states
                         if "/" in k}) or [None]
        gathered = {}
        for layer in layers:
            pre = "" if layer is None else layer + "/"
            gathered.update({pre + k: v for k, v in ssm.gather_state_blocks(
                cfg, [{k: b[pre + k] for k in ("conv_state", "ssm_state")}
                      for b in blocks]).items()})
        out[arch].update(
            state_shapes={k: tuple(v.shape) for k, v in states.items()},
            whole_state_shapes={k: tuple(v.shape)
                                for k, v in want_states.items()},
            states={k: v.numpy() for k, v in gathered.items()},
            state_diff=max(float((gathered[k] - v).abs().max()
                                 / v.abs().max())
                           for k, v in want_states.items()))
    return out


def one(rank, work):
    """(a, b) at one rank: the sharded step with every gradient dtype and
    with 2 microbatches, bit for bit against the unsharded step, in a
    group of one rank that
    ``init_distributed`` makes on an in-memory store (the card's path)."""
    init_distributed("cpu")
    cfg, _, init = tiny_init(work)
    mesh = make_local_mesh(1, 1)
    out = {}
    for dtype, micros in (("", 1), ("bfloat16", 1), ("int8", 1), ("", 2)):
        tc = TrainConfig(steps=STEPS, grad_allreduce_dtype=dtype,
                         microbatches=micros)
        run = run_sharded(cfg, tc, init, mesh)
        step = trainer.make_train_step(cfg, tc, "dense")
        ds = SyntheticLMDataset(cfg, BATCH, SEQ)
        state, want = init, []
        for i in range(STEPS):
            state, m = step(state, ds.batch_at(i))
            want.append(float(m["loss"]))
        a, b = flat(run.full.trainable), flat(state.trainable)
        out[(dtype or "float32") + (" x2" if micros > 1 else "")] = dict(
            losses=run.losses, want=want, records=run.records,
            equal=run.losses == want and all(
                a[k].tobytes() == b[k].tobytes() for k in b))
    return out


def _unflatten(flat_arrays):
    tree = {}
    for key, v in flat_arrays.items():
        node = tree
        *head, last = key.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return tree


GROUPS = {"four": four, "moe2": moe2}


def main(group, rank, world, work):
    store = dist.FileStore(os.path.join(work, f"{group}.store"), world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
    out = GROUPS[group](rank, work)
    torch.save(out, os.path.join(work, f"{group}.{rank}.pt"))
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
