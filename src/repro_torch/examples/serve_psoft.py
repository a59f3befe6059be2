"""Serving example: fine-tune with PSOFT, MERGE, serve batched requests,
on the port.

    PYTHONPATH=src python -m repro_torch.examples.serve_psoft [--device cpu]

Shows the reparameterization-method deployment story: after merging, the
serving graph is the plain base model (zero adapter latency), running
paged prefill and decode through the continuous-batching engine.  The
generations follow the trained Markov chain far more often than chance.
Runs on the card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import TrainConfig, get_config
from repro_torch.data import SyntheticLMDataset
from repro_torch.optim import adamw
from repro_torch.serve import Request, ServeEngine
from repro_torch.train import trainer


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=150)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_config("tiny")
    print("training a tiny PSOFT model on the Markov task...")
    tc = TrainConfig(steps=args.steps, learning_rate=5e-3,
                     full_finetune=True)
    state = trainer.init_train_state(cfg, tc, seed=0, device=dev)
    step = trainer.make_train_step(cfg, tc)
    ds = SyntheticLMDataset(cfg, 16, 64)
    for i in range(args.steps):
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in ds.batch_at(i).items()}
        state, m = step(state, batch)
    print(f"train loss: {float(m['loss']):.3f}")
    params = adamw.combine(state.trainable, state.frozen)

    print("\nmerging PSOFT adapters + serving 6 requests on 2 slots...")
    engine = ServeEngine(params, cfg, max_len=64, slots=2, device=dev)
    rng = np.random.default_rng(0)
    reqs = [Request(uid=i, prompt=rng.integers(0, cfg.vocab_size, size=8,
                                               dtype=np.int32),
                    max_new_tokens=12) for i in range(6)]
    done = engine.run(reqs)
    for r in sorted(done, key=lambda r: r.uid):
        print(f"  req {r.uid}: prompt={list(r.prompt[:4])}... -> "
              f"generated {r.generated}")

    # generations follow the learned Markov chain more often than chance
    hits = total = 0
    for r in done:
        seq = list(r.prompt) + r.generated
        for a, b in zip(seq[:-1], seq[1:]):
            hits += b in ds.succ[a]
            total += 1
    chance = ds.dc.branching / cfg.vocab_size
    print(f"\nMarkov-successor rate of generations: {hits}/{total} "
          f"({hits / total:.0%}; chance would be {chance:.1%})")
    return {"rate": hits / total, "chance": chance,
            "loss": float(m["loss"])}


if __name__ == "__main__":
    main()
