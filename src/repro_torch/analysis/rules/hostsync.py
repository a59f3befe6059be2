"""HOSTSYNC — no device->host synchronization inside the serving hot path.

``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``, ``.to("cpu")``,
``torch.equal``, ``torch.cuda.synchronize`` and a stream's or event's
``.synchronize()`` each wait for the card: one stray call in the decode
loop serializes every step behind it, and it would break the capture of a
decode step into one CUDA graph.  ``np.asarray`` / ``np.array`` are
flagged as the reference flags them (on a tensor they are a transfer).

The hot functions come from ``cfg.hostsync_hot``.  The port's sanctioned
boundary — ONE packed ``.cpu()`` after the sampler, in
``sampling.to_host`` — is allowlisted per ``(path, qualname, call)`` in
``cfg.hostsync_allow``.  ``.numpy()``, ``.tolist()`` or ``.item()`` on
the result of a ``.cpu()`` / ``.to("cpu")`` is part of that one transfer
and is not flagged again.  A call inside a ``raise`` statement is not flagged: the
step ends there.

An AST rule cannot tell a tensor from a numpy array.  A flagged call on a
host array is a false positive to suppress with a reasoned
``# repro-lint: disable=HOSTSYNC`` comment, never to baseline.
:mod:`repro_torch.analysis.dispatch_tools` is the runtime complement that
sees a sync three calls deep.
"""
from __future__ import annotations

import ast
import fnmatch
from typing import Iterator

from ..core import FileContext, Finding, match_any, rule

#: host-transfer and wait calls, by unparsed callee
_SYNC_CALLS = {
    "np.asarray", "np.array", "numpy.asarray", "numpy.array",
    "torch.equal", "torch.cuda.synchronize",
}
#: tensor methods that copy to the host (or wait for the card), called
#: with no positional arguments
_SYNC_METHODS = {"item", "tolist", "cpu", "numpy", "synchronize"}
#: methods whose result is already on the host when called on a ``.cpu()``
_HOST_CHAIN = {"numpy", "tolist", "item"}


def _unparse(node: ast.AST) -> str:
    try:
        return ast.unparse(node)
    except Exception:                                    # pragma: no cover
        return ""


def _to_cpu(node: ast.Call) -> bool:
    """``x.to("cpu")``, ``x.to(device="cpu")`` or ``x.to(torch.device(
    "cpu"))``."""
    if not (isinstance(node.func, ast.Attribute) and node.func.attr == "to"):
        return False
    values = list(node.args[:1]) + [k.value for k in node.keywords
                                     if k.arg == "device"]
    return any(_unparse(v) in ("'cpu'", "torch.device('cpu')")
               for v in values)


def _call_key(node: ast.Call) -> str:
    """Canonical key for a flagged call: the unparsed callee, ``.<method>``
    for a method-style pull, ``.to('cpu')`` for a move to the host; ""
    for anything else."""
    name = _unparse(node.func)
    if name in _SYNC_CALLS:
        return name
    if _to_cpu(node):
        return ".to('cpu')"
    if isinstance(node.func, ast.Attribute) and \
            node.func.attr in _SYNC_METHODS and not node.args:
        recv = node.func.value
        if node.func.attr in _HOST_CHAIN and isinstance(recv, ast.Call) \
                and _call_key(recv) in (".cpu", ".to('cpu')"):
            return ""
        return f".{node.func.attr}"
    return ""


def _in_raise(ctx: FileContext, node: ast.AST) -> bool:
    for anc in ctx.ancestors(node):
        if isinstance(anc, ast.Raise):
            return True
        if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return False
    return False                                         # pragma: no cover


@rule("HOSTSYNC")
def check_hostsync(ctx: FileContext, cfg) -> Iterator[Finding]:
    """Device->host sync calls in the configured hot-path functions."""
    hot_globs = cfg.hostsync_hot.get(ctx.path, ())
    if not hot_globs:
        return
    for fn in ctx.functions():
        if not match_any(ctx.qualname(fn), hot_globs):
            continue
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            key = _call_key(node)
            if not key or _in_raise(ctx, node):
                continue
            call_qn = ctx.qualname(node)
            if any(fnmatch.fnmatch(ctx.path, pg)
                   and fnmatch.fnmatch(call_qn, qg) and key == k
                   for (pg, qg, k) in cfg.hostsync_allow):
                continue
            yield ctx.finding(
                "HOSTSYNC", node,
                f"'{key}' in hot-path function '{call_qn}' forces a "
                f"device->host sync; keep the step loop async (batch "
                f"transfers through the allowlisted boundary)")
