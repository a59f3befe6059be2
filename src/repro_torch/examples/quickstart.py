"""Quickstart: PSOFT on one linear layer, then a tiny LM fine-tuned with
PSOFT and merged, on the port.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

Walks the paper end to end at miniature scale:
  1. SVD split  W_pre = A'B' + W_res  (Eq. 6)
  2. Theorem 4.1: the rotated subspace preserves angles and norms
  3. fine-tune only (q, α, β) on a shifted task; merge back to a plain
     weight, which serves with no adapter overhead
Runs on the card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import DataConfig, TrainConfig, get_config
from repro_torch.core import peft, psoft
from repro_torch.data import SyntheticLMDataset
from repro_torch.models import model as model_lib
from repro_torch.optim import adamw
from repro_torch.train import trainer
from repro_torch.tree import tree_leaves


def _cosmat(w: np.ndarray) -> np.ndarray:
    n = np.linalg.norm(w, axis=0)
    return (w.T @ w) / np.outer(n, n)


def one_linear(dev: torch.device) -> dict:
    gen = torch.Generator(device=dev).manual_seed(0)
    w_pre = torch.randn((256, 192), generator=gen, device=dev) * 0.2
    r = 32
    params = psoft.psoft_init(w_pre, r, relax_vectors=True,
                              param_dtype=torch.float32,
                              peft_dtype=torch.float32)
    n_train = sum(params[k].numel() for k in ("q", "alpha", "beta"))
    print(f"d_in=256 d_out=192 rank={r}")
    print(f"trainable params: {n_train}  (= r(r-1)/2 + 2r = "
          f"{r * (r - 1) // 2 + 2 * r})")
    print(f"vs LoRA r={r}: {(256 + 192) * r}  "
          f"({(256 + 192) * r / n_train:.1f}x more)")
    params["q"] = 0.1 * torch.randn(params["q"].shape, generator=gen,
                                    device=dev)
    rot = psoft.psoft_rotation(params, exact=True)
    w_pri = (params["A"] @ params["B"]).double().cpu().numpy()
    w_rot = (params["A"] @ rot @ params["B"]).double().cpu().numpy()
    angle = float(np.max(np.abs(_cosmat(w_rot) - _cosmat(w_pri))))
    norm = float(np.max(np.abs(np.linalg.norm(w_rot, axis=0)
                               - np.linalg.norm(w_pri, axis=0))))
    print(f"max |Δcos(angle)| after rotation: {angle:.2e}  (Theorem 4.1)")
    print(f"max |Δ column norm|: {norm:.2e}")
    return {"angle_dev": angle, "norm_dev": norm}


def _batch(ds, i, dev):
    return {k: torch.from_numpy(v).to(dev) for k, v in ds.batch_at(i).items()}


def tiny_lm(dev: torch.device, pretrain_steps: int, steps: int) -> dict:
    cfg = get_config("tiny")      # psoft rank 8 on all linears
    tc = TrainConfig(steps=2 * pretrain_steps, learning_rate=5e-3,
                     full_finetune=True)
    state = trainer.init_train_state(cfg, tc, seed=1, device=dev)
    step = trainer.make_train_step(cfg, tc)
    ds = SyntheticLMDataset(cfg, 16, 64)
    for i in range(pretrain_steps):        # brief "pretraining"
        state, m = step(state, _batch(ds, i, dev))
    print(f"pretrained base, loss={float(m['loss']):.3f}")

    tc2 = TrainConfig(steps=steps, learning_rate=5e-3)   # PSOFT only
    base = adamw.combine(state.trainable, state.frozen)
    params_psoft = model_lib.rewrap_peft(peft.merge_tree(base, cfg.peft),
                                         cfg)
    state2 = trainer.train_state_from_params(params_psoft, cfg, tc2)
    step2 = trainer.make_train_step(cfg, tc2)
    ds2 = SyntheticLMDataset(cfg, 16, 64, DataConfig(seed=777))  # shifted
    n_tr = sum(x.numel() for x in tree_leaves(state2.trainable))
    n_all = n_tr + sum(x.numel() for x in tree_leaves(state2.frozen))
    print(f"PSOFT fine-tune: {n_tr}/{n_all} params "
          f"({100 * n_tr / n_all:.2f}%) trainable")
    losses = []
    for i in range(steps):
        state2, m = step2(state2, _batch(ds2, i, dev))
        losses.append(float(m["loss"]))
    print(f"shifted-task loss: {losses[0]:.3f} -> {losses[-1]:.3f}")

    print("\n=== 3. merge for zero-latency serving ===")
    tuned = adamw.combine(state2.trainable, state2.frozen)
    merged = peft.merge_tree(tuned, cfg.peft)
    toks = (torch.arange(8, device=dev) % cfg.vocab_size)[None, :]
    with torch.no_grad():
        l1 = model_lib.forward_logits(tuned, {"tokens": toks}, cfg)
        scfg = cfg.replace(peft=cfg.peft.replace(method="none"))
        l2 = model_lib.forward_logits(merged, {"tokens": toks}, scfg)
    merge_dev = float((l1 - l2).abs().max())
    print(f"merged-vs-unmerged max |Δlogit| = {merge_dev:.2e}  "
          f"(reparameterization: no inference overhead)")
    return {"losses": losses, "merge_dev": merge_dev}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--pretrain-steps", type=int, default=40)
    ap.add_argument("--steps", type=int, default=60)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    print("=== 1. one linear layer ===")
    out = one_linear(dev)
    print("\n=== 2. fine-tune a tiny LM with PSOFT ===")
    out.update(tiny_lm(dev, args.pretrain_steps, args.steps))
    print("done.")
    return out


if __name__ == "__main__":
    main()
