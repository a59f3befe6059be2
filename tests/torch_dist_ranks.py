"""The ranks of tests/test_torch_distributed.py, one process each:

    PYTHONPATH=src python tests/torch_dist_ranks.py GROUP RANK WORLD WORKDIR

joins a gloo process group of WORLD ranks through a file store in WORKDIR,
runs GROUP's scenarios on the CPU and writes this rank's results to
``WORKDIR/GROUP.RANK.pt``.  The test runs :func:`one` in its own process.
This file imports torch, numpy and the port only; the test holds the
results against the reference package and the port's unsharded step.
"""
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)

from repro_torch import interop  # noqa: E402
from repro_torch.configs import MeshConfig, TrainConfig, get_config  # noqa
from repro_torch.data import SyntheticLMDataset  # noqa: E402
from repro_torch.distributed import collectives  # noqa: E402
from repro_torch.distributed import gpipe_spmd_pipeline  # noqa: E402
from repro_torch.launch.mesh import (  # noqa: E402
    init_distributed, make_local_mesh, make_mesh_from_config, rules_for)
from repro_torch.models import moe  # noqa: E402
from repro_torch.sharding import mesh_context  # noqa: E402
from repro_torch.train import checkpoint, trainer  # noqa: E402
from repro_torch.tree import tree_leaves_with_path  # noqa: E402

#: the reference test's recipe: tiny, 3 steps of 8 x 32 tokens
STEPS, BATCH, SEQ = 3, 8, 32
#: reduced deepseek-moe-16b's sharded steps: 4 x 16 tokens
MOE_STEPS, MOE_BATCH, MOE_SEQ = 2, 4, 16


def flat(tree):
    return {"/".join(p): t.detach().cpu().numpy()
            for p, t in tree_leaves_with_path(tree)}


def records():
    return [(c.kind, str(c.dtype), c.elements, c.group)
            for c in collectives.RECORD]


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


def run_sharded(cfg, tc, state, mesh, steps=STEPS, batch=BATCH, seq=SEQ,
                moe_impl="dense"):
    """``steps`` sharded steps from the full ``state``: (losses, records,
    the full final state, its shardings, the final blocks)."""
    rules = rules_for(cfg, mesh, "train")
    sh, _ = trainer.state_shardings(cfg, tc, mesh, rules)
    local = trainer.shard_state(state, sh, mesh)
    step = trainer.make_train_step(cfg, tc, moe_impl, mesh=mesh, rules=rules)
    ds = SyntheticLMDataset(cfg, batch, seq)
    losses = []
    collectives.reset()
    for i in range(steps):
        local, m = step(local, ds.batch_at(i))
        losses.append(float(m["loss"]))
    rec = records()
    return losses, rec, trainer.gather_state(local, sh, mesh), sh, local


def four(rank, work):
    """(a) three meshes, (b) bf16 and int8 gradients, (c) the elastic
    restore, (d) GPipe over 4 stages."""
    cfg, tc, init = tiny_init(work)
    mesh = make_mesh_from_config(MeshConfig(data=2, model=2))
    out = {"mesh_from_config": (mesh.mesh_dim_names, tuple(mesh.shape))}
    meshes = {}
    for shape in ((2, 2), (4, 1), (1, 4)):
        mesh = meshes[shape] = make_local_mesh(*shape)
        losses, rec, full, sh, local = run_sharded(cfg, tc, init, mesh)
        out[f"{shape[0]}x{shape[1]}"] = dict(
            losses=losses, records=rec, trainable=flat(full.trainable))
        if shape == (2, 2):
            ckpt = os.path.join(work, "ckpt")
            checkpoint.save(local, ckpt, STEPS, shardings=sh, mesh=mesh)
            saved = flat(full)
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
        losses, rec, full, _, _ = run_sharded(cfg, tc_c, init, mesh)
        out[dtype] = dict(losses=losses, records=rec,
                          trainable=flat(full.trainable))

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
    each rank one dispatch group, and sharded train steps; and the other
    families' sharded steps (:func:`families`)."""
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
    losses, rec, full, _, _ = run_sharded(cfg, tc, state, mesh, MOE_STEPS,
                                          MOE_BATCH, MOE_SEQ, "capacity")
    return dict(y=y.numpy(), aux=float(aux), losses=losses, records=rec,
                trainable=flat(full.trainable),
                families=families(mesh))


def families(mesh):
    """One sharded step of the other families' layer trees (a hybrid's
    list of layers and its shared block, an encoder's, a VLM's patches)
    on ``mesh``, against the unsharded step on the whole batch: (losses,
    largest trainable difference) by arch."""
    out = {}
    for arch in ("zamba2-1.2b", "seamless-m4t-medium", "internvl2-26b"):
        cfg = get_config(arch).reduced()
        tc = TrainConfig(steps=2, learning_rate=1e-2)
        state = trainer.init_train_state(cfg, tc, device="cpu")
        losses, _, full, _, _ = run_sharded(cfg, tc, state, mesh, 1, 4, 32)
        plain, m = trainer.make_train_step(cfg, tc)(
            state, SyntheticLMDataset(cfg, 4, 32).batch_at(0))
        a, b = flat(full.trainable), flat(plain.trainable)
        out[arch] = (losses[0], float(m["loss"]),
                     max(float(np.abs(a[k] - b[k]).max()) for k in b))
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
        losses, rec, full, _, _ = run_sharded(cfg, tc, init, mesh)
        step = trainer.make_train_step(cfg, tc, "dense")
        ds = SyntheticLMDataset(cfg, BATCH, SEQ)
        state, want = init, []
        for i in range(STEPS):
            state, m = step(state, ds.batch_at(i))
            want.append(float(m["loss"]))
        a, b = flat(full.trainable), flat(state.trainable)
        out[(dtype or "float32") + (" x2" if micros > 1 else "")] = dict(
            losses=losses, want=want, records=rec,
            equal=losses == want and all(
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
