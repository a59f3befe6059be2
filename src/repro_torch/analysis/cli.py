"""Command line entry: ``python -m repro_torch.analysis [paths...]``.

Exit codes: 0 clean (or everything baselined/suppressed), 1 findings,
2 usage error.  ``--baseline`` defaults to
``<root>/analysis-baseline-torch.json`` when that file exists (the
reference checker's ``analysis-baseline.json`` is its own);
``--write-baseline`` snapshots the current findings into it
(grandfathering them) instead of failing.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import List, Optional

from . import baseline as baseline_mod
from .config import default_config
from .core import RULES, run_analysis
from .report import render_json, render_text

DEFAULT_BASELINE = "analysis-baseline-torch.json"


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="The port's static checker: hot-path sync, RNG "
                    "discipline, obs gating, kernel contracts, "
                    "deprecation coverage.")
    p.add_argument("paths", nargs="*", default=["src/repro_torch"],
                   help="files/directories to report on (default: "
                        "src/repro_torch)")
    p.add_argument("--root", default=".",
                   help="repo root the index and config are relative to")
    p.add_argument("--format", choices=("text", "json"), default="text")
    p.add_argument("--baseline", default=None,
                   help=f"baseline file (default: <root>/{DEFAULT_BASELINE} "
                        f"if present)")
    p.add_argument("--no-baseline", action="store_true",
                   help="ignore any baseline file")
    p.add_argument("--write-baseline", action="store_true",
                   help="snapshot current findings into the baseline and "
                        "exit 0")
    p.add_argument("--output", default=None,
                   help="also write the report to this file")
    p.add_argument("--list-rules", action="store_true")
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = _build_parser().parse_args(argv)
    if args.list_rules:
        for spec in sorted(RULES.values(), key=lambda s: s.id):
            head = spec.doc.splitlines()[0] if spec.doc else ""
            print(f"{spec.id:16s} [{spec.scope}] {head}")
        return 0

    root = Path(args.root).resolve()
    if not root.is_dir():
        print(f"error: --root {args.root} is not a directory",
              file=sys.stderr)
        return 2
    cfg = default_config(str(root))
    result = run_analysis(cfg, args.paths)

    baseline_path = Path(args.baseline) if args.baseline \
        else root / DEFAULT_BASELINE
    if args.write_baseline:
        baseline_mod.write(baseline_path, result.findings)
        print(f"wrote {len(result.findings)} finding(s) to {baseline_path}")
        return 0
    known = set()
    if not args.no_baseline and baseline_path.exists():
        known = baseline_mod.load(baseline_path)
    new, grandfathered = baseline_mod.partition(result.findings, known)

    render = render_json if args.format == "json" else render_text
    report = render(result, new, grandfathered)
    if args.output:
        Path(args.output).write_text(report + "\n")
    print(report)
    return 1 if new else 0
