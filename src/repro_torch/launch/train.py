"""End-to-end training launcher of the port.

    PYTHONPATH=src python -m repro_torch.launch.train --arch lm-100m \
        --steps 300 --peft psoft --rank 46 --batch 32 --seq 512 \
        --ckpt runs/psoft [--device cpu]
    PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 2 \
        -m repro_torch.launch.train --device cpu --reduced --data-mesh 2

The reference's launcher (its flags and printed lines): synthetic data
with a background prefetch, the PEFT-masked AdamW step with gradient
accumulation and compression, the straggler monitor, async atomic
checkpoints every ``--ckpt-every`` steps with auto-resume from the latest
one, and per-step metrics into a JSONL tracker.  The model runs in fp32,
as the reference's launcher forces.  Runs on the card unless ``--device
cpu``.

``--data-mesh N`` (or any run under ``torch.distributed.run``) trains on a
``(N, 1)`` ``("data", "model")`` mesh of the process group's ranks with
the sharded step (:func:`repro_torch.train.trainer.make_train_step` with
``mesh=``): ZeRO-3 frozen weights, the batch split over ``data``.  Every
rank draws the same global batches; rank 0 logs and writes the
checkpoints.  Without either, one device runs the unsharded step.
"""
from __future__ import annotations

import argparse
import os
import time

import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.configs import DataConfig, TrainConfig, get_config
from repro_torch.data import SyntheticLMDataset, prefetch_iterator
from repro_torch.launch.mesh import init_distributed, make_local_mesh, rules_for
from repro_torch.models import model as model_lib
from repro_torch.obs import NOOP, JsonlTracker
from repro_torch.optim import adamw
from repro_torch.train import checkpoint, straggler, trainer


def main(argv=None) -> float:
    """Train for ``--steps`` steps (from the latest checkpoint under
    ``--ckpt`` when there is one) and return the last step's loss."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="lm-100m")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--peft", default="psoft")
    ap.add_argument("--rank", type=int, default=46)
    ap.add_argument("--full-ft", action="store_true")
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--lr", type=float, default=4e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--grad-compress", default="",
                    choices=["", "bfloat16", "int8"])
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--data-mesh", type=int, default=0,
                    help="data axis size (0 = every rank of a "
                         "torch.distributed.run launch; one device "
                         "without it)")
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-test-sized config of the family")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--metrics-jsonl", default="",
                    help="write per-step metrics (loss/grad_norm/lr/step "
                         "time) as a repro_torch.obs JsonlTracker artifact")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    world = int(os.environ.get("WORLD_SIZE", 1))
    if args.data_mesh not in (0, world):
        raise ValueError(
            f"--data-mesh {args.data_mesh}: the data axis spans every rank "
            f"and this launch has {world}; start {args.data_mesh} ranks "
            f"with python -m torch.distributed.run --nproc-per-node "
            f"{args.data_mesh}")
    sharded = args.data_mesh > 0 or "WORLD_SIZE" in os.environ
    started = sharded and not dist.is_initialized()
    dev = init_distributed(args.device) if sharded else \
        resolve_device(args.device)
    rank = dist.get_rank() if sharded else 0

    def say(*a, **kw):
        if rank == 0:
            print(*a, **kw)
    tracker = (JsonlTracker(args.metrics_jsonl)
               if args.metrics_jsonl and rank == 0 else NOOP)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    cfg = cfg.replace(peft=cfg.peft.replace(method=args.peft,
                                            rank=args.rank),
                      dtype="float32", param_dtype="float32")
    tc = TrainConfig(learning_rate=args.lr, steps=args.steps,
                     microbatches=args.microbatches,
                     full_finetune=args.full_ft,
                     grad_allreduce_dtype=args.grad_compress,
                     seed=args.seed, checkpoint_dir=args.ckpt,
                     checkpoint_every=args.ckpt_every)
    mesh = rules = shardings = None
    if sharded:
        mesh = make_local_mesh(data=dist.get_world_size())
        rules = rules_for(cfg, mesh, "train")
        say(f"mesh: {dict(zip(mesh.mesh_dim_names, mesh.shape))}  "
            f"devices: {dist.get_world_size()}")
    else:
        print(f"mesh: {{'data': 1, 'model': 1}}  devices: 1 ({dev})")

    state = trainer.init_train_state(cfg, tc, seed=tc.seed, device=dev)
    params = adamw.combine(state.trainable, state.frozen)
    n_all = model_lib.count_params(params)
    n_tr = n_all if tc.full_finetune else \
        model_lib.count_trainable(cfg, params)
    del params
    say(f"params: {n_all:,} total, {n_tr:,} trainable "
        f"({100*n_tr/max(n_all,1):.3f}%) [{cfg.peft.method}]")
    if sharded:
        shardings, _ = trainer.state_shardings(cfg, tc, mesh, rules)
        state = trainer.shard_state(state, shardings, mesh)

    start = 0
    if tc.checkpoint_dir and \
            checkpoint.latest_step(tc.checkpoint_dir) is not None:
        state = checkpoint.restore(state, tc.checkpoint_dir,
                                   shardings=shardings, mesh=mesh)
        start = int(state.step)
        say(f"resumed from step {start}")

    step_fn = trainer.make_train_step(cfg, tc, moe_impl="dense", mesh=mesh,
                                      rules=rules)
    ds = SyntheticLMDataset(cfg, args.batch, args.seq,
                            DataConfig(seed=tc.seed))
    mon = straggler.StepTimeMonitor(
        on_anomaly=lambda s, t, m: say(
            f"  [straggler] step {s}: {t:.2f}s vs mean {m:.2f}s"))

    it = prefetch_iterator(
        ({k: torch.as_tensor(v) for k, v in ds.batch_at(i).items()}
         for i in range(start, tc.steps)))
    writers = []
    metrics = None
    t_start = time.time()
    try:
        for i, batch in zip(range(start, tc.steps), it):
            with straggler.Stopwatch() as sw:
                state, metrics = step_fn(state, batch)
                straggler.block_until_ready(metrics["loss"])
            mon.record(sw.seconds)
            if tracker is not NOOP:
                trainer.log_step_metrics(tracker, i + 1, metrics,
                                         step_time=sw.seconds)
            if (i + 1) % args.log_every == 0 or i == start:
                say(f"step {i+1:5d}  loss {float(metrics['loss']):.4f}  "
                    f"gnorm {float(metrics['grad_norm']):.3f}  "
                    f"lr {float(metrics['lr']):.2e}  {sw.seconds:.2f}s")
            if tc.checkpoint_dir and (i + 1) % tc.checkpoint_every == 0:
                writers.append(checkpoint.save(
                    state, tc.checkpoint_dir, i + 1, async_save=True,
                    shardings=shardings, mesh=mesh))
        if tc.checkpoint_dir:
            checkpoint.save(state, tc.checkpoint_dir, tc.steps,
                            shardings=shardings, mesh=mesh)
    finally:
        # a run that fails mid-way still commits the checkpoints it began
        for w in writers:
            if w is not None:
                w.join()
    tracker.finish()
    dt = time.time() - t_start
    say(f"done: {tc.steps - start} steps in {dt:.1f}s "
        f"({(tc.steps - start)/max(dt,1e-9):.2f} steps/s); "
        f"straggler flags: {len(mon.anomalies)}")
    if started:
        dist.destroy_process_group()
    return float("nan") if metrics is None else float(metrics["loss"])


if __name__ == "__main__":
    main()
