"""OBS-GATE — tracker calls on the decode hot path must be gated.

The reference's rule, unchanged in logic, over the port's hot set.
Serving under ``NoopTracker`` pays ZERO tracker calls per decode step.
Inside the configured hot functions (the per-decode-step call graph:
``run_stream``'s loop body, ``_decode_live``, ``_spec_step``,
``_spec_group``, ``_sample_rows``, page growth, suspension and finish
paths, the scheduler's ``push`` and ``window``), every tracker method call
must sit under an ``if self._obs:`` / ``if not tracker.is_noop:`` guard —
as an enclosing ``if``, a ternary (``tracker.time_block(...) if self._obs
else NULL_SPAN``), or a function-level early return (``if not self._obs:
return``).

Sink helpers that self-gate (``_observe_decode``, ``_observe_truncated``,
``sampling.record_occupancy``) satisfy the rule through that early-return
form or are called under a gate, so calling THEM is fine — the tracker
work never runs.
"""
from __future__ import annotations

import ast
from typing import Iterator

from ..core import FileContext, Finding, match_any, rule

_TRACKER_METHODS = {"count", "gauge", "histogram", "event", "log",
                    "time_block"}


def _is_tracker_call(node: ast.AST) -> bool:
    if not (isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr in _TRACKER_METHODS):
        return False
    try:
        recv = ast.unparse(node.func.value)
    except Exception:                                    # pragma: no cover
        return False
    return "tracker" in recv or recv in ("tr", "self.tr")


def _gate_test(test: ast.AST) -> bool:
    try:
        text = ast.unparse(test)
    except Exception:                                    # pragma: no cover
        return False
    return "_obs" in text or "is_noop" in text


def _guard_returns(fn: ast.FunctionDef) -> bool:
    """Function-level gate: a top-level ``if <not obs>: return`` clause."""
    for stmt in fn.body:
        if isinstance(stmt, ast.If) and _gate_test(stmt.test) and \
                any(isinstance(s, (ast.Return, ast.Raise))
                    for s in stmt.body):
            return True
    return False


def _gated(ctx: FileContext, node: ast.AST) -> bool:
    for anc in ctx.ancestors(node):
        if isinstance(anc, (ast.If, ast.IfExp)) and _gate_test(anc.test):
            return True
        if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return _guard_returns(anc)
    return False                                         # pragma: no cover


@rule("OBS-GATE")
def check_obsgate(ctx: FileContext, cfg) -> Iterator[Finding]:
    """Ungated tracker method calls in decode-hot-path functions."""
    hot_globs = cfg.obsgate_hot.get(ctx.path, ())
    if not hot_globs:
        return
    for fn in ctx.functions():
        if not match_any(ctx.qualname(fn), hot_globs):
            continue
        for node in ast.walk(fn):
            if _is_tracker_call(node) and not _gated(ctx, node):
                yield ctx.finding(
                    "OBS-GATE", node,
                    f"ungated tracker.{node.func.attr}() in hot-path "
                    f"function '{ctx.qualname(node)}': gate behind "
                    f"'if self._obs:' / 'is_noop' so NoopTracker serving "
                    f"pays zero per-decode-step calls")
