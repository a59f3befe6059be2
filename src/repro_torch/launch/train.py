"""End-to-end training launcher of the port, on one device.

    PYTHONPATH=src python -m repro_torch.launch.train --arch lm-100m \
        --steps 300 --peft psoft --rank 46 --batch 32 --seq 512 \
        --ckpt runs/psoft [--device cpu]

The reference's launcher (its flags and printed lines) at one device:
synthetic data with a background prefetch, the PEFT-masked AdamW step
with gradient accumulation and compression, the straggler monitor, async
atomic checkpoints every ``--ckpt-every`` steps with auto-resume from the
latest one, and per-step metrics into a JSONL tracker.  The model runs in
fp32, as the reference's launcher forces.  Runs on the card unless
``--device cpu``.  The card is one device: ``--data-mesh`` takes 0 or 1.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import resolve_device
from repro_torch.configs import DataConfig, TrainConfig, get_config
from repro_torch.data import SyntheticLMDataset, prefetch_iterator
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
                    help="data axis size (0 = all local devices: one)")
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-test-sized config of the family")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--metrics-jsonl", default="",
                    help="write per-step metrics (loss/grad_norm/lr/step "
                         "time) as a repro_torch.obs JsonlTracker artifact")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.data_mesh not in (0, 1):
        raise ValueError(
            f"--data-mesh {args.data_mesh}: the port trains on one device; "
            f"a data axis over several cards comes with the distributed "
            f"slice (sharding rules, mesh launch, pipeline)")
    dev = resolve_device(args.device)
    tracker = (JsonlTracker(args.metrics_jsonl) if args.metrics_jsonl
               else NOOP)

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
    print(f"mesh: {{'data': 1, 'model': 1}}  devices: 1 ({dev})")

    state = trainer.init_train_state(cfg, tc, seed=tc.seed, device=dev)
    params = adamw.combine(state.trainable, state.frozen)
    n_all = model_lib.count_params(params)
    n_tr = n_all if tc.full_finetune else \
        model_lib.count_trainable(cfg, params)
    del params
    print(f"params: {n_all:,} total, {n_tr:,} trainable "
          f"({100*n_tr/max(n_all,1):.3f}%) [{cfg.peft.method}]")

    start = 0
    if tc.checkpoint_dir and \
            checkpoint.latest_step(tc.checkpoint_dir) is not None:
        state = checkpoint.restore(state, tc.checkpoint_dir)
        start = int(state.step)
        print(f"resumed from step {start}")

    step_fn = trainer.make_train_step(cfg, tc, moe_impl="dense")
    ds = SyntheticLMDataset(cfg, args.batch, args.seq,
                            DataConfig(seed=tc.seed))
    mon = straggler.StepTimeMonitor(
        on_anomaly=lambda s, t, m: print(
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
                print(f"step {i+1:5d}  loss {float(metrics['loss']):.4f}  "
                      f"gnorm {float(metrics['grad_norm']):.3f}  "
                      f"lr {float(metrics['lr']):.2e}  {sw.seconds:.2f}s")
            if tc.checkpoint_dir and (i + 1) % tc.checkpoint_every == 0:
                writers.append(checkpoint.save(
                    state, tc.checkpoint_dir, i + 1, async_save=True))
        if tc.checkpoint_dir:
            checkpoint.save(state, tc.checkpoint_dir, tc.steps)
    finally:
        # a run that fails mid-way still commits the checkpoints it began
        for w in writers:
            w.join()
    tracker.finish()
    dt = time.time() - t_start
    print(f"done: {tc.steps - start} steps in {dt:.1f}s "
          f"({(tc.steps - start)/max(dt,1e-9):.2f} steps/s); "
          f"straggler flags: {len(mon.anomalies)}")
    return float("nan") if metrics is None else float(metrics["loss"])


if __name__ == "__main__":
    main()
