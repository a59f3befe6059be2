"""Paper-style method comparison at miniature scale (Tables 2/4 flavour),
on the port.

    PYTHONPATH=src python -m repro_torch.examples.peft_comparison \
        [--device cpu] [--pretrain-steps 80] [--steps 50]

Pretrains one base model (``tiny``, full fine-tuning), then fine-tunes the
SAME base on a shifted task with PSOFT / LoRA / PiSSA / DoRA / LoRA-XS /
OFT, reporting trainable params, steps/s, final loss and, on the card,
peak memory in one table.  Runs on the card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import resolve_device
from repro_torch.configs import DataConfig, TrainConfig, get_config
from repro_torch.core import peft
from repro_torch.data import SyntheticLMDataset
from repro_torch.models import model as model_lib
from repro_torch.train import straggler, trainer

#: (method, rank) of each fine-tune, the reference example's
ROWS = (("psoft", 46), ("lora", 4), ("pissa", 4), ("dora", 4),
        ("lora_xs", 16), ("oft", 8))


def pretrain(cfg, steps: int, dev: torch.device):
    """The shared base: ``steps`` full fine-tuning steps from a seed."""
    tc = TrainConfig(steps=steps, learning_rate=3e-3, full_finetune=True)
    state = trainer.init_train_state(cfg, tc, seed=0, device=dev)
    step = trainer.make_train_step(cfg, tc, "dense")
    ds = SyntheticLMDataset(cfg, 16, 64)
    m = None
    for i in range(steps):
        state, m = step(state, ds.batch_at(i))
    return trainer.adapter_params(state), float(m["loss"])


def finetune(cfg, base, method: str, rank: int, steps: int,
             dev: torch.device) -> dict:
    """One method on the merged base: ``steps`` steps on a shifted task
    (another data seed); steps/s over the steps after the first two."""
    pcfg = cfg.replace(peft=cfg.peft.replace(method=method, rank=rank,
                                             oft_block_size=16))
    params = model_lib.rewrap_peft(peft.merge_tree(base, cfg.peft), pcfg)
    ftc = TrainConfig(steps=steps, learning_rate=5e-3)
    state = trainer.train_state_from_params(params, pcfg, ftc)
    fstep = trainer.make_train_step(pcfg, ftc, "dense")
    fds = SyntheticLMDataset(pcfg, 16, 64, DataConfig(seed=777))
    n_tr = model_lib.count_params(state.trainable)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0, last = None, None
    for i in range(steps):
        state, mm = fstep(state, fds.batch_at(i))
        if i == 1:
            straggler.block_until_ready(mm["loss"])
            t0 = time.perf_counter()
        last = float(mm["loss"])
    timed = steps - 2
    dt = (time.perf_counter() - t0) / timed if timed > 0 else float("nan")
    peak = torch.cuda.max_memory_allocated(dev) / 2**20 \
        if dev.type == "cuda" else None
    return {"method": method, "trainable": n_tr, "steps_per_s": 1 / dt,
            "final_loss": last, "peak_mib": peak}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--pretrain-steps", type=int, default=80)
    ap.add_argument("--steps", type=int, default=50)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_config("tiny")
    print("pretraining base model...")
    base, base_loss = pretrain(cfg, args.pretrain_steps, dev)
    print(f"base loss {base_loss:.3f}\n")
    print(f"{'method':10s} {'#params':>9s} {'steps/s':>8s} "
          f"{'final loss':>10s} {'peak MiB':>9s}")
    rows = []
    for method, rank in ROWS:
        row = finetune(cfg, base, method, rank, args.steps, dev)
        rows.append(row)
        peak = "-" if row["peak_mib"] is None else f"{row['peak_mib']:.1f}"
        print(f"{method:10s} {row['trainable']:9d} "
              f"{row['steps_per_s']:8.1f} {row['final_loss']:10.3f} "
              f"{peak:>9s}")
    print("\n(The paper's finding at scale: PSOFT matches LoRA-family quality "
          "at ~1/18th the parameters and avoids the OFT-family memory blowup "
          "— see benchmarks/ for the asserted orderings.)")
    return {"base_loss": base_loss, "rows": rows}


if __name__ == "__main__":
    main()
