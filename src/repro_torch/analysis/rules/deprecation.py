"""DEPRECATION — every shim warns, and every warning is test-covered.

Two directions:

1. Every ``warnings.warn(..., DeprecationWarning)`` site in library code
   must be exercised by a test (some test file mentions the shim's symbol
   AND catches a DeprecationWarning) — otherwise the shim can silently
   stop warning, or stop working, and nobody notices until a consumer
   breaks.
2. Every function whose docstring declares it DEPRECATED must actually
   emit a ``DeprecationWarning`` — prose-only deprecation gives callers
   no migration signal.

The covering symbol is the nearest non-dunder enclosing name: a warn in
``Request.__post_init__`` is covered by a test mentioning ``Request``;
one in a plain ``csv_row`` def needs ``csv_row`` in a test.

The reference's rule over the port's files (``src/repro_torch/**`` and
``chip_smoke.py``) and tests (``tests/test_torch_*.py``).  The port
carries no shims, so on its tree the rule finds nothing: it is there to
catch the next one.  A file whose text has neither ``DeprecationWarning``
nor "deprecated" cannot hold a finding and is not parsed.
"""
from __future__ import annotations

import ast
from typing import Iterator, List, Optional

from ..core import FileContext, Finding, ProjectContext, rule


def _is_deprecation_warn(node: ast.Call) -> bool:
    try:
        callee = ast.unparse(node.func)
    except Exception:                                    # pragma: no cover
        return False
    if callee not in ("warnings.warn", "warn"):
        return False
    exprs = list(node.args) + [k.value for k in node.keywords]
    return any("DeprecationWarning" in ast.unparse(e) for e in exprs)


def _symbol_for(ctx: FileContext, node: ast.AST) -> str:
    """Nearest non-dunder enclosing def name; a dunder falls through to its
    class (warning in ``__init__`` is covered by tests naming the class)."""
    chain: List[str] = []
    cur: Optional[ast.AST] = node
    while cur is not None:
        if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef,
                            ast.ClassDef)):
            chain.append(cur.name)
        cur = ctx.parent(cur)
    for name in chain:
        if not (name.startswith("__") and name.endswith("__")):
            return name
    return ""


def _declares_deprecated(fn: ast.FunctionDef) -> bool:
    doc = ast.get_docstring(fn) or ""
    return doc.strip().lower().startswith("deprecated")


@rule("DEPRECATION", scope="project")
def check_deprecation(project: ProjectContext, cfg) -> Iterator[Finding]:
    """Warn sites without test coverage; DEPRECATED docstrings without a
    warn."""
    test_sources = [c.source for c in project.iter_matching(cfg.test_globs)]

    def covered(symbol: str) -> bool:
        return any(symbol in t
                   and ("DeprecationWarning" in t or "deprecated_call" in t)
                   for t in test_sources)

    for ctx in project.iter_matching(cfg.deprecation_scope):
        if "DeprecationWarning" not in ctx.source and \
                "deprecated" not in ctx.source.lower():
            continue
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Call) and _is_deprecation_warn(node):
                symbol = _symbol_for(ctx, node)
                if not symbol:
                    continue         # module-level warn: nothing to anchor
                if not covered(symbol):
                    yield ctx.finding(
                        "DEPRECATION", node,
                        f"deprecated shim '{symbol}' warns but no test "
                        f"exercises the DeprecationWarning (add a "
                        f"pytest.warns covering '{symbol}')")
        for fn in ctx.functions():
            if _declares_deprecated(fn) and not any(
                    isinstance(n, ast.Call) and _is_deprecation_warn(n)
                    for n in ast.walk(fn)):
                yield ctx.finding(
                    "DEPRECATION", fn,
                    f"'{ctx.qualname(fn)}' documents itself as DEPRECATED "
                    f"but never issues a DeprecationWarning")
