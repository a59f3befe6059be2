"""Baseline file: grandfathered findings, matched by fingerprint.

``analysis-baseline-torch.json`` at the repo root, when it exists, names
findings that predate a rule (or are justified and annotated there); the
CLI fails only on NON-baselined findings.  The port's tree keeps none: it
is clean with nothing grandfathered.  Fingerprints hash rule + path +
enclosing symbol + offending-line text, so entries survive unrelated line
drift but die with the code they describe — a stale entry is harmless (it
matches nothing) and ``--write-baseline`` prunes it.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Iterable, List, Set, Tuple

from .core import Finding

VERSION = 1

Key = Tuple[str, str, str]          # (rule, path, fingerprint)


def load(path) -> Set[Key]:
    data = json.loads(Path(path).read_text())
    if data.get("version") != VERSION:
        raise ValueError(
            f"baseline {path}: unsupported version {data.get('version')!r}")
    return {(f["rule"], f["path"], f["fingerprint"])
            for f in data.get("findings", ())}


def write(path, findings: Iterable[Finding]) -> None:
    data = {
        "version": VERSION,
        "findings": [
            {"rule": f.rule, "path": f.path, "symbol": f.symbol,
             "fingerprint": f.fingerprint, "message": f.message}
            for f in sorted(findings,
                            key=lambda f: (f.path, f.rule, f.fingerprint))],
    }
    Path(path).write_text(json.dumps(data, indent=2) + "\n")


def partition(findings: Iterable[Finding],
              baseline: Set[Key]) -> Tuple[List[Finding], List[Finding]]:
    """Split into (new, grandfathered)."""
    new: List[Finding] = []
    old: List[Finding] = []
    for f in findings:
        (old if (f.rule, f.path, f.fingerprint) in baseline
         else new).append(f)
    return new, old
