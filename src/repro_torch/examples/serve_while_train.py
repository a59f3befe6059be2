"""Serve-while-train in one process, on the port: a live engine streams
training checkpoints into its adapter bank without draining in-flight
requests.

    PYTHONPATH=src python -m repro_torch.examples.serve_while_train \
        [--device cpu] [--train-steps N]

A step hook runs one PSOFT fine-tune step every few engine steps and
checkpoints it with ``publish=feed.notify``; the attached
:class:`repro_torch.serve.AdapterFeed` restores each new checkpoint and
swaps it into the bank at the next step boundary.  Requests already
decoding keep their admission-pinned epoch (bit-identical tokens);
requests submitted afterwards serve the newest fine-tune snapshot.  Runs
on the card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import tempfile

import numpy as np

from repro_torch import resolve_device
from repro_torch.configs import TrainConfig, get_config
from repro_torch.data import SyntheticLMDataset
from repro_torch.obs import InMemoryTracker
from repro_torch.serve import AdapterFeed, Request, ServeEngine
from repro_torch.train import checkpoint, trainer


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--train-steps", type=int, default=12)
    ap.add_argument("--ckpt-dir", default="",
                    help="checkpoint directory (default: a fresh temporary "
                         "one)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_config("tiny")
    tc = TrainConfig(steps=args.train_steps, learning_rate=5e-3)

    state = trainer.init_train_state(cfg, tc, seed=0, device=dev)
    base = trainer.adapter_params(state)
    engine = ServeEngine(base, cfg, max_len=64, slots=2, device=dev)
    tracker = InMemoryTracker()
    engine.tracker = tracker
    train_step = trainer.make_train_step(cfg, tc)
    ds = SyntheticLMDataset(cfg, 4, 32)

    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(
        prefix="psoft_serve_while_train_")
    feed = AdapterFeed(engine, ckpt_dir, "live", state).attach()
    box = {"state": state, "i": 0}

    def train_hook(eng, step):
        """Every 3rd engine step: one optimizer step and a published
        checkpoint (the feed picks it up at the next step boundary)."""
        if step % 3 == 0 and box["i"] < tc.steps:
            box["state"], metrics = train_step(box["state"],
                                               ds.batch_at(box["i"]))
            box["i"] += 1
            checkpoint.save(box["state"], ckpt_dir, int(box["state"].step),
                            publish=feed.notify)
            print(f"  engine step {step}: trained and published checkpoint "
                  f"{int(box['state'].step)} (loss "
                  f"{float(metrics['loss']):.3f})")

    engine.add_step_hook(train_hook)

    prompt = (np.arange(8, dtype=np.int32) * 3 + 1) % cfg.vocab_size
    print("serving a long base request while training runs...")
    done = engine.run_stream(
        [(1, Request(uid=0, prompt=prompt, max_new_tokens=24))],
        max_steps=256)
    print(f"uid 0 finished on its pinned epoch: {done[0].generated}")
    print(f"checkpoints streamed into the bank: {feed.applied}")
    swaps = tracker.events_named("engine/bank/swap")
    print(f"bank swaps observed: "
          f"{[(e['op'], e['adapter'], e['version']) for e in swaps]}")
    print(f"current bank epoch: {tracker.gauges['engine/bank/epoch']:.0f}, "
          f"columns: {tracker.gauges['engine/bank/columns']:.0f}")

    box["i"] = tc.steps            # stop training: the hooks stay attached
    print("\nserving the newest fine-tune snapshot...")
    live = engine.run([Request(uid=1, prompt=prompt, max_new_tokens=8,
                               adapter="live")], max_steps=64)
    print(f"uid 1 (adapter 'live', checkpoint {feed.applied[-1]}): "
          f"{live[0].generated}")

    reclaimed = engine.compact_banks()
    print(f"compaction reclaimed {reclaimed} dead bank columns "
          f"({engine.lifecycle.bank_bytes() / 1024:.0f} KiB live)")
    return dict(inflight=done[0], live=live[0], applied=list(feed.applied),
                swaps=swaps, reclaimed=reclaimed, tracker=tracker,
                state=box["state"], base=base, cfg=cfg,
                bank_bytes=engine.lifecycle.bank_bytes())


if __name__ == "__main__":
    main()
