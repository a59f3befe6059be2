"""Observability example on the port: a mixed-adapter streaming run
captured by an ``InMemoryTracker``, summarized as a per-adapter
throughput / pool-pressure / SLO table.

    PYTHONPATH=src python -m repro_torch.examples.serve_metrics [--device cpu]

One tracker attached at engine construction sees every layer: engine
(tokens, queueing delay, SLO attainment, preemptions), scheduler (queue
depth, at-risk admissions), KV cache (pool pressure, prefix reuse) and
sampler (batch occupancy).  Swap ``InMemoryTracker`` for
``JsonlTracker("metrics.jsonl")`` (or compose both with
``CompositeTracker``) to persist the same stream; the reference package
reads the file.
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.models import model as model_lib
from repro_torch.obs import InMemoryTracker
from repro_torch.serve import Request, ServeEngine


def nudge_psoft(tree, eps):
    """Fine-tune stand-in: shift every PSOFT trainable off identity (new
    tensors; every other leaf is shared)."""
    if isinstance(tree, dict):
        return {k: (v + eps if k in ("q", "alpha", "beta")
                    and not isinstance(v, dict) else nudge_psoft(v, eps))
                for k, v in tree.items()}
    return tree


def main(argv=None) -> InMemoryTracker:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_config("tiny")
    params = model_lib.init_params(cfg, seed=0, device=dev)

    tracker = InMemoryTracker()
    # a tight page pool (6 usable pages) so high-priority deadlined bursts
    # preempt the long low-priority request
    engine = ServeEngine(params, cfg, max_len=56, slots=2, page_size=8,
                         num_pages=7, tracker=tracker, device=dev)
    engine.register_adapter("tuned", nudge_psoft(params, 0.05))

    rng = np.random.default_rng(0)
    big = Request(uid=0, prompt=rng.integers(0, cfg.vocab_size, 24,
                                             np.int32),
                  max_new_tokens=20, adapter="base", priority=0)
    bursts = [Request(uid=1 + i,
                      prompt=rng.integers(0, cfg.vocab_size, 6, np.int32),
                      max_new_tokens=4, adapter="tuned", priority=1,
                      deadline=12.0)
              for i in range(4)]
    trace = [(1, big)] + [(3 + 2 * i, r) for i, r in enumerate(bursts)]
    done = engine.run_stream(trace, max_steps=200)
    if not all(r.done for r in done):
        raise AssertionError("every request must finish")

    # -- per-adapter throughput -----------------------------------------
    wall = sum(tracker.values("engine/decode_step_s")) \
        + sum(tracker.values("engine/prefill_s"))
    print(f"{'adapter':10} {'tokens':>7} {'tok/s':>8} {'requests':>9}")
    reqs_by = {}
    for r in done:
        reqs_by[r.adapter] = reqs_by.get(r.adapter, 0) + 1
    for adapter, toks in sorted(
            tracker.counters_under("engine/tokens/").items()):
        print(f"{adapter:10} {int(toks):7d} {toks / wall:8.1f} "
              f"{reqs_by[adapter]:9d}")

    # -- pool pressure & prefix reuse -------------------------------------
    print(f"\npool pressure (last): "
          f"{tracker.gauges['kv/pool_pressure']:.2f}, "
          f"{tracker.gauges['kv/pages_retained']:.0f} pages retained")
    hits = tracker.counter("kv/prefix_hit_tokens")
    miss = tracker.counter("kv/prefix_miss_tokens")
    print(f"prefix reuse: {int(hits)} hit / {int(miss)} miss tokens")
    print(f"suspends/resumes: {int(tracker.counter('kv/suspends'))}/"
          f"{int(tracker.counter('kv/resumes'))} "
          f"(preemptions: {int(tracker.counter('engine/preemptions'))})")

    # -- SLO & queueing ---------------------------------------------------
    met = int(tracker.counter("engine/slo_met"))
    missed = int(tracker.counter("engine/slo_missed"))
    print(f"\nSLO attainment: {met}/{met + missed} deadlined requests "
          f"({100 * met / max(met + missed, 1):.0f}%)")
    print(f"queueing delay p50/p99: "
          f"{tracker.quantile('engine/queueing_delay', 0.5):.0f}/"
          f"{tracker.quantile('engine/queueing_delay', 0.99):.0f} steps")
    occ = tracker.values("sampler/batch_occupancy")
    print(f"sampler batch occupancy mean: {np.mean(occ):.2f}")
    finishes = {k: int(v) for k, v in
                tracker.counters_under("engine/finish/").items()}
    print(f"finish reasons: {finishes}")
    return tracker


if __name__ == "__main__":
    main()
