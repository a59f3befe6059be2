"""End-to-end training launcher example on the port.

Full setting: a ~100M-parameter LM fine-tuned with PSOFT for a few hundred
steps through the launcher (data pipeline with prefetch, the PEFT-masked
step, checkpoints, the straggler monitor, resume):

    PYTHONPATH=src python -m repro_torch.examples.train_psoft_lm --full

Quick demo (default): the same launcher on the reduced config, then a
second call that resumes from its checkpoint and runs ``--resume-steps``
more.  Runs on the card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import os
import tempfile

from repro_torch.launch import train as train_mod


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--full", action="store_true",
                    help="lm-100m x 300 steps (minutes on the card)")
    ap.add_argument("--steps", type=int, default=120,
                    help="steps of the quick demo's first call")
    ap.add_argument("--resume-steps", type=int, default=20,
                    help="steps the resumed call adds")
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "psoft_lm_ckpt"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.full:
        argv = ["--arch", "lm-100m", "--steps", "300", "--batch", "32",
                "--seq", "512", "--peft", "psoft", "--rank", "46",
                "--lr", "4e-4", "--microbatches", "4",
                "--ckpt", args.ckpt, "--ckpt-every", "100"]
    else:
        argv = ["--arch", "lm-100m", "--reduced", "--steps",
                str(args.steps), "--batch", "16", "--seq", "128", "--peft",
                "psoft", "--rank", "16", "--lr", "2e-3", "--ckpt", args.ckpt,
                "--ckpt-every", str(max(1, args.steps // 2))]
    argv += ["--device", args.device]
    loss = train_mod.main(argv)
    print(f"final loss: {loss:.4f}")
    print("resume check: rerunning picks up from the checkpoint...")
    argv2 = list(argv)
    i = argv2.index("--steps") + 1
    argv2[i] = str(int(argv2[i]) + args.resume_steps)
    resumed = train_mod.main(argv2)
    return {"loss": loss, "resumed_loss": resumed,
            "steps": int(argv2[i])}


if __name__ == "__main__":
    main()
