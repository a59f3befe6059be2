"""Dispatch-level host-sync checks that complement the AST rules.

The runtime counterpart of the reference's ``jaxpr_tools``: HOSTSYNC reads
the source of the hot functions, but a ``.item()`` three calls deep, in a
helper the rule does not list, is invisible to it.  Here ``fn`` runs under
a :class:`torch.utils._python_dispatch.TorchDispatchMode` that sees every
aten op and records those that make the host wait for the card:

- ``aten._local_scalar_dense`` (``.item()``, and ``int()``, ``float()``
  and ``bool()`` of a tensor), ``aten.equal``, ``aten.is_nonzero``;
- ops whose output shape depends on the data: ``aten.nonzero``,
  ``aten.masked_select``, the ``aten.unique*`` ops, and ``aten.index`` /
  ``aten.index_put`` with a boolean index;
- a blocking copy from a CUDA tensor to the host (``aten._to_copy`` /
  ``aten.copy_``).

Each is reported with the innermost frame of the ``repro_torch`` package
that issued it (else the innermost frame outside torch).  On the CPU,
``.cpu()`` and ``.tolist()`` dispatch nothing, so only the card and the
AST rule see those two; on a CUDA tensor :func:`assert_no_host_syncs` also
runs ``fn`` under ``torch.cuda.set_sync_debug_mode("error")``, which
raises at any synchronizing CUDA call.

Ops issued under ``kernels/ref.py`` (the plain versions, which run only
for CPU tensors and never on the card's main path) are outside the check
by default: the ``exclude`` parameter names the files.

torch is imported lazily so the rest of :mod:`repro_torch.analysis` stays
stdlib-only.
"""
from __future__ import annotations

import dataclasses
import sys
from pathlib import Path
from typing import Iterable, List, Sequence

#: the repro_torch package, whose frames the reports name
PACKAGE_DIR = Path(__file__).resolve().parents[1]
#: aten ops that always wait for the card
SYNC_OPS = frozenset({
    "aten._local_scalar_dense.default", "aten.equal.default",
    "aten.is_nonzero.default", "aten.nonzero.default",
    "aten.masked_select.default", "aten._unique.default",
    "aten._unique2.default", "aten.unique_dim.default",
    "aten.unique_consecutive.default",
})
#: indexing ops that wait for the card when an index is boolean
BOOL_INDEX_OPS = frozenset({
    "aten.index.Tensor", "aten.index_put.default",
    "aten.index_put_.default", "aten._index_put_impl_.default",
})
#: files (relative to the package) whose ops the check leaves out
DEFAULT_EXCLUDE = ("kernels/ref.py",)
_SYNC_MESSAGE = "synchronizing CUDA operation"


@dataclasses.dataclass(frozen=True)
class HostSync:
    """One synchronizing op and where it was issued."""
    op: str
    frame: str

    def __str__(self) -> str:
        return f"{self.op} at {self.frame}"


def _cuda_to_host(torch, name: str, args, kwargs) -> bool:
    """A blocking copy from a CUDA tensor into host memory."""
    if name == "aten._to_copy.default":
        dev = kwargs.get("device")
        return args[0].is_cuda and dev is not None and \
            torch.device(dev).type == "cpu" and \
            not kwargs.get("non_blocking", False)
    if name == "aten.copy_.default":
        non_blocking = args[2] if len(args) > 2 else \
            kwargs.get("non_blocking", False)
        return args[0].device.type == "cpu" and args[1].is_cuda and \
            not non_blocking
    return False


def _syncs(torch, name: str, args, kwargs) -> bool:
    if name in SYNC_OPS:
        return True
    if name in BOOL_INDEX_OPS:
        return any(t is not None and t.dtype in (torch.bool, torch.uint8)
                   for t in args[1])
    return _cuda_to_host(torch, name, args, kwargs)


def _frame(exclude: Sequence[Path]):
    """``path:line (function)`` of the innermost repro_torch frame on the
    stack (else the innermost frame outside torch and this module), or
    None when any frame lies in an excluded file."""
    import torch
    torch_dir = Path(torch.__file__).resolve().parent
    here = Path(__file__).resolve()
    own = other = None
    f = sys._getframe(1)
    while f is not None:
        path = Path(f.f_code.co_filename).resolve()
        if path in exclude:
            return None
        if path != here and path.name != "contextlib.py" and \
                not path.is_relative_to(torch_dir):
            where = f"{path}:{f.f_lineno} ({f.f_code.co_name})"
            if own is None and path.is_relative_to(PACKAGE_DIR):
                own = where.replace(f"{PACKAGE_DIR.parent}/", "", 1)
            other = other or where
        f = f.f_back
    return own or other or "<unknown>"


def _run(fn, args, kwargs, exclude: Iterable[str],
         found: List[HostSync]):
    """``fn``'s result; the host syncs it issues are appended to
    ``found`` as they happen."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    skip = [(PACKAGE_DIR / e).resolve() for e in exclude]

    class Recorder(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            name = str(func)
            if _syncs(torch, name, args, kwargs):
                where = _frame(skip)
                if where is not None:
                    found.append(HostSync(name, where))
            return func(*args, **kwargs)

    with Recorder():
        return fn(*args, **kwargs)


def host_sync_ops(fn, *args, exclude: Iterable[str] = DEFAULT_EXCLUDE,
                  **kwargs) -> List[HostSync]:
    """The synchronizing aten ops ``fn(*args, **kwargs)`` issues (it runs
    once), each with the frame that issued it; ops issued under the files
    ``exclude`` names (relative to the package) are left out."""
    found: List[HostSync] = []
    _run(fn, args, kwargs, exclude, found)
    return found


def _on_cuda(torch, args, kwargs) -> bool:
    leaves = torch.utils._pytree.tree_leaves((args, kwargs))
    return any(isinstance(t, torch.Tensor) and t.is_cuda for t in leaves)


def assert_no_host_syncs(fn, *args, allow: Iterable[str] = (),
                         exclude: Iterable[str] = DEFAULT_EXCLUDE, **kwargs):
    """Run ``fn(*args, **kwargs)`` once and return its result; raise
    AssertionError if it issued a synchronizing op (other than the op
    names in ``allow``).  With a CUDA tensor among the arguments the call
    also runs under ``torch.cuda.set_sync_debug_mode("error")``, so any
    synchronizing CUDA call raises (``allow`` does not reach that mode)."""
    import torch
    allowed = set(allow)
    found: List[HostSync] = []
    cuda = _on_cuda(torch, args, kwargs)
    prev = torch.cuda.get_sync_debug_mode() if cuda else 0
    try:
        if cuda:
            torch.cuda.set_sync_debug_mode("error")
        out = _run(fn, args, kwargs, exclude, found)
    except RuntimeError as e:
        if _SYNC_MESSAGE not in str(e):
            raise
        raise AssertionError(
            f"a synchronizing CUDA operation inside a function expected to "
            f"stay on the device ({'; '.join(map(str, found)) or e})"
        ) from e
    finally:
        if cuda:
            torch.cuda.set_sync_debug_mode(prev)
    bad = [s for s in found if s.op not in allowed]
    if bad:
        raise AssertionError(
            "host sync(s) inside a function expected to stay on the "
            "device: " + "; ".join(map(str, bad)))
    return out
