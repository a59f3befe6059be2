"""Per-request sampling example on the port: one engine, mixed greedy /
creative / stop-token / logprobs traffic.

    PYTHONPATH=src python -m repro_torch.examples.serve_sampling [--device cpu]

Every request carries its own ``SamplingParams``; the sampler stacks them
per slot, so the mix below (greedy argmax next to seeded top-k/top-p
sampling next to stop-token early termination) shares one decode step.
Draws are counter-based (the reference's threefry stream): re-running
this script reproduces every sampled token, on the card or the CPU.
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.models import model as model_lib
from repro_torch.serve import Request, SamplingParams, ServeEngine


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_config("tiny")
    params = model_lib.init_params(cfg, seed=0, device=dev)
    engine = ServeEngine(params, cfg, max_len=64, slots=2, device=dev)

    rng = np.random.default_rng(0)

    def prompt(n):
        return rng.integers(0, cfg.vocab_size, size=n, dtype=np.int32)

    # a token the greedy continuation emits, to use as a stop id below
    probe = engine.run([Request(uid=100, prompt=np.arange(8, dtype=np.int32),
                                max_new_tokens=8)])[0]
    stop_id = probe.generated[3]

    creative = SamplingParams(temperature=0.9, top_k=50, top_p=0.95,
                              seed=1234)
    shared = prompt(6)
    reqs = [
        # deterministic: greedy argmax (the engine default)
        Request(uid=0, prompt=prompt(8), max_new_tokens=10),
        # creative: temperature + nucleus sampling, reproducible via seed
        Request(uid=1, prompt=shared.copy(), max_new_tokens=10,
                sampling=creative),
        # same params + seed + prompt as uid 1 -> identical tokens
        Request(uid=2, prompt=shared.copy(), max_new_tokens=10,
                sampling=creative),
        # early termination: stops the moment stop_id is emitted
        Request(uid=3, prompt=np.arange(8, dtype=np.int32),
                max_new_tokens=10,
                sampling=SamplingParams.greedy(stop_token_ids=(stop_id,))),
        # eval/distillation: greedy + per-token top-3 logprobs
        Request(uid=4, prompt=prompt(7), max_new_tokens=4,
                sampling=SamplingParams.greedy(logprobs=3)),
    ]
    done = {r.uid: r for r in engine.run(reqs)}
    for uid in range(5):
        r = done[uid]
        print(f"req {uid}: finish_reason={r.finish_reason!r:8} "
              f"generated={r.generated}")
    if done[1].generated != done[2].generated:
        raise AssertionError("seeded draws must reproduce")
    if not (done[3].finish_reason == "stop"
            and done[3].generated[-1] == stop_id):
        raise AssertionError("the stop request must end on its stop id")
    print(f"\nstop request finished after {len(done[3].generated)} of "
          f"{done[3].max_new_tokens} tokens (pages freed early)")
    print("\nper-token logprobs of req 4 (model distribution, top-3):")
    for step, lp in enumerate(done[4].logprobs):
        alts = ", ".join(f"{t}:{p:.2f}" for t, p in zip(lp.top_tokens,
                                                        lp.top_logprobs))
        print(f"  step {step}: chose {lp.token} ({lp.logprob:.2f})  "
              f"[{alts}]")
    return {uid: r for uid, r in done.items()}


if __name__ == "__main__":
    main()
