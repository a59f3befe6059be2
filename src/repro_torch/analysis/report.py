"""Text and JSON reporters for analysis results."""
from __future__ import annotations

import json
from typing import List

from .core import AnalysisResult, Finding


def render_text(result: AnalysisResult, new: List[Finding],
                grandfathered: List[Finding]) -> str:
    lines: List[str] = []
    for f in new:
        lines.append(f"{f.path}:{f.line}:{f.col}: {f.rule}: {f.message}  "
                     f"[{f.fingerprint}]")
    summary = (f"{len(new)} finding(s) in {result.files_checked} file(s)"
               f" ({result.suppressed} suppressed"
               f", {len(grandfathered)} baselined)")
    lines.append(summary if new else f"clean: {summary}")
    return "\n".join(lines)


def render_json(result: AnalysisResult, new: List[Finding],
                grandfathered: List[Finding]) -> str:
    return json.dumps({
        "version": 1,
        "files_checked": result.files_checked,
        "suppressed": result.suppressed,
        "baselined": len(grandfathered),
        "findings": [f.as_dict() for f in new],
    }, indent=2)
