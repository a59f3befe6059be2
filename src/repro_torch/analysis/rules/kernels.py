"""KERNEL-CONTRACT — every CUDA kernel ships with a C interface that its
three Python views agree on, its oracle, its wrapper, a test and the
on-card check; and no wrapper falls back to its plain version on the card.

The port's counterpart of the reference's PALLAS-CONTRACT.  The C interface
of a kernel is written out by hand in three places that nothing else
cross-checks, and ctypes passes a wrong argument list without complaint:

- the ``extern "C" int <name>_launch(...)`` prototype in
  ``csrc/<name>.cu``;
- the ctypes argtype list ``build.ENTRY_POINTS[<name>]``;
- the ``_launch("<name>", ...)`` calls in ``ops.py``.

For every ``csrc/<name>.cu`` that defines ``<name>_launch``:

(a) ``<name>`` is in ``build.SOURCES`` and ``build.ENTRY_POINTS[<name>]``
    names ``<name>_launch`` (and every name in ``SOURCES`` has its
    source);
(b) the prototype and the argtype list agree in length and kind: pointer
    parameters against ``_P`` (``ctypes.c_void_p``), ``int`` against
    ``_I`` (``ctypes.c_int``); the list is read by evaluating its literal
    ``[_I] + [_P] * 8 + ...`` expression on the syntax tree, never by
    importing ``build``;
(c) every ``_launch("<name>", ...)`` call in ``ops.py`` without starred
    arguments passes as many arguments as that list holds;
(d) ``ref.py`` defines the plain version ``<name>``;
(e) ``ops.py`` defines the public wrapper ``<name>`` and ``ops.LAUNCHES``
    has the key;
(f) no fallback: every call into ``ref.`` in ``ops.py`` sits under a
    CPU-device test (``if _on_cpu(...)``) and never in an ``except``
    handler — on the card a kernel runs or raises (the inversion of the
    reference's ``interpret=`` escape hatch);
(g) some test mentions both the oracle ``ref.<name>`` and the wrapper
    (``ops.<name>`` or a bare ``<name>(`` call);
(h) ``chip_smoke.py`` mentions both, because that is where the kernel is
    held against its plain version on the card;

and the library exports ``repro_cuda_error_string`` (defined in the
source or a header it includes from ``csrc/``), which ``build.library``
binds for every kernel.

Findings about a kernel anchor on its ``build.py`` entry (an
``ENTRY_POINTS`` key, else ``SOURCES``); (c) and (f) anchor on the call in
``ops.py``.
"""
from __future__ import annotations

import ast
import posixpath
import re
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Tuple

from ..core import FileContext, Finding, ProjectContext, rule

_ID = "KERNEL-CONTRACT"
_CTYPES_KIND = {"ctypes.c_void_p": "ptr", "ctypes.c_int": "int"}
_COMMENT_RE = re.compile(r"//[^\n]*|/\*.*?\*/", re.S)
_INCLUDE_RE = re.compile(r'#\s*include\s+"([^"]+)"')
_ERROR_STRING_RE = re.compile(
    r'extern\s+"C"[^;{(]*\brepro_cuda_error_string\s*\([^)]*\)\s*\{')


def _launch_re(name: str):
    return re.compile(r'extern\s+"C"\s+int\s+' + re.escape(name)
                      + r"_launch\s*\(([^)]*)\)")


def _c_kinds(params: str) -> List[Tuple[str, str]]:
    """(kind, text) per parameter of a C prototype: ``"ptr"`` for a
    pointer, ``"int"`` for a plain ``int``, ``"other"`` else."""
    out = []
    for p in params.split(","):
        text = " ".join(p.split())
        if not text or text == "void":
            continue
        if "*" in text:
            out.append(("ptr", text))
        elif text.split()[:-1] in (["int"], ["const", "int"]):
            out.append(("int", text))
        else:
            out.append(("other", text))
    return out


def _module_assigns(ctx: FileContext) -> Dict[str, ast.AST]:
    out: Dict[str, ast.AST] = {}
    for stmt in ctx.tree.body:
        if isinstance(stmt, ast.Assign):
            for t in stmt.targets:
                if isinstance(t, ast.Name):
                    out[t.id] = stmt.value
        elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None \
                and isinstance(stmt.target, ast.Name):
            out[stmt.target.id] = stmt.value
    return out


def _kinds_of(expr: ast.AST, names: Dict[str, str]) -> Optional[List[str]]:
    """The argtype list literal ``expr`` as kinds, or None when it is not a
    sum of lists of known ctypes names and integer repeats."""
    if isinstance(expr, ast.List):
        out = []
        for elt in expr.elts:
            kind = names.get(ast.unparse(elt))
            if kind is None:
                return None
            out.append(kind)
        return out
    if isinstance(expr, ast.BinOp) and isinstance(expr.op, ast.Add):
        left, right = _kinds_of(expr.left, names), _kinds_of(expr.right,
                                                             names)
        return None if left is None or right is None else left + right
    if isinstance(expr, ast.BinOp) and isinstance(expr.op, ast.Mult):
        for seq, count in ((expr.left, expr.right), (expr.right, expr.left)):
            if isinstance(count, ast.Constant) and \
                    isinstance(count.value, int):
                kinds = _kinds_of(seq, names)
                return None if kinds is None else kinds * count.value
    return None


class _Build:
    """What ``build.py`` declares: SOURCES, and ENTRY_POINTS as
    ``name -> (key node, entry point name, kinds or None)``."""

    def __init__(self, ctx: FileContext):
        self.ctx = ctx
        self.sources: Dict[str, ast.AST] = {}
        self.sources_node: Optional[ast.AST] = None
        self.entries: Dict[str, Tuple[ast.AST, Optional[str],
                                      Optional[List[str]]]] = {}
        assigns = _module_assigns(ctx)
        names = dict(_CTYPES_KIND)
        for var, value in assigns.items():
            kind = _CTYPES_KIND.get(ast.unparse(value))
            if kind:
                names[var] = kind
        src = assigns.get("SOURCES")
        if isinstance(src, (ast.Tuple, ast.List)):
            self.sources_node = src
            for elt in src.elts:
                if isinstance(elt, ast.Constant) and \
                        isinstance(elt.value, str):
                    self.sources[elt.value] = elt
        entries = assigns.get("ENTRY_POINTS")
        if isinstance(entries, ast.Dict):
            for key, value in zip(entries.keys, entries.values):
                if not (isinstance(key, ast.Constant)
                        and isinstance(key.value, str)):
                    continue
                fn, kinds = None, None
                if isinstance(value, ast.Tuple) and len(value.elts) == 2:
                    first = value.elts[0]
                    if isinstance(first, ast.Constant):
                        fn = first.value
                    kinds = _kinds_of(value.elts[1], names)
                self.entries[key.value] = (key, fn, kinds)

    def anchor(self, name: str) -> ast.AST:
        if name in self.entries:
            return self.entries[name][0]
        return self.sources.get(name) or self.sources_node or self.ctx.tree


def _includes_error_string(csrc: Path, path: Path, seen=None) -> bool:
    seen = set() if seen is None else seen
    if path in seen or not path.is_file():
        return False
    seen.add(path)
    text = _COMMENT_RE.sub("", path.read_text())
    if _ERROR_STRING_RE.search(text):
        return True
    return any(_includes_error_string(csrc, csrc / inc, seen)
               for inc in _INCLUDE_RE.findall(text))


def _ref_aliases(ctx: FileContext) -> set:
    out = {"ref"}
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.ImportFrom):
            for a in node.names:
                if a.name == "ref":
                    out.add(a.asname or "ref")
        elif isinstance(node, ast.Import):
            for a in node.names:
                if a.name.endswith(".ref") and a.asname:
                    out.add(a.asname)
    return out


def _under_cpu_test(ctx: FileContext, node: ast.AST) -> bool:
    """``node`` lies in the taken branch of an ``if _on_cpu(...)`` (or of
    such a conditional expression)."""
    child = node
    for anc in ctx.ancestors(node):
        if isinstance(anc, (ast.If, ast.IfExp)) and \
                "_on_cpu(" in ast.unparse(anc.test):
            body = anc.body if isinstance(anc.body, list) else [anc.body]
            if any(child is b for b in body):
                return True
        child = anc
    return False


def _check_ops(ops: FileContext, build: _Build) -> Iterator[Finding]:
    """(c) and (f) over every call in ``ops.py``."""
    refs = _ref_aliases(ops)
    for node in ast.walk(ops.tree):
        if not isinstance(node, ast.Call):
            continue
        callee = ast.unparse(node.func)
        if callee.rsplit(".", 1)[-1] == "_launch" and node.args and \
                isinstance(node.args[0], ast.Constant) and \
                isinstance(node.args[0].value, str):
            name = node.args[0].value
            kinds = build.entries.get(name, (None, None, None))[2]
            if kinds is not None and \
                    not any(isinstance(a, ast.Starred) for a in node.args):
                got = len(node.args) - 1
                if got != len(kinds):
                    yield ops.finding(
                        _ID, node,
                        f"_launch('{name}', ...) passes {got} argument(s) "
                        f"but build.ENTRY_POINTS['{name}'] declares "
                        f"{len(kinds)}")
        if isinstance(node.func, ast.Attribute) and \
                isinstance(node.func.value, ast.Name) and \
                node.func.value.id in refs:
            if any(isinstance(a, ast.ExceptHandler)
                   for a in ops.ancestors(node)):
                yield ops.finding(
                    _ID, node,
                    f"'{callee}' in an except handler is a fallback to the "
                    f"plain version: on the card a kernel runs or raises")
            elif not _under_cpu_test(ops, node):
                yield ops.finding(
                    _ID, node,
                    f"'{callee}' outside an 'if _on_cpu(...)' branch: the "
                    f"plain version runs only for tensors on the CPU")


def _mentions(text: str, name: str) -> bool:
    oracle = re.search(rf"\bref\.{name}\b", text)
    wrapper = re.search(rf"\bops\.{name}\b|(?<![.\w]){name}\(", text)
    return bool(oracle and wrapper)


@rule(_ID, scope="project")
def check_kernels(project: ProjectContext, cfg) -> Iterator[Finding]:
    """CUDA kernels must agree with their ctypes argtypes and launch calls,
    pair with an oracle, a wrapper, a test and the on-card check, and never
    fall back to the plain version on the card."""
    kdir = cfg.kernels_dir.rstrip("/")
    build_ctx = project.files.get(posixpath.join(kdir, "build.py"))
    ops_ctx = project.files.get(posixpath.join(kdir, "ops.py"))
    ref_ctx = project.files.get(posixpath.join(kdir, "ref.py"))
    csrc = Path(cfg.root).resolve() / kdir / "csrc"
    if build_ctx is None or not csrc.is_dir():
        return
    build = _Build(build_ctx)
    kernels: Dict[str, Tuple[str, List[Tuple[str, str]]]] = {}
    for cu in sorted(csrc.glob("*.cu")):
        text = _COMMENT_RE.sub("", cu.read_text())
        m = _launch_re(cu.stem).search(text)
        if m:
            kernels[cu.stem] = (cu.name, _c_kinds(m.group(1)))
    for name in build.sources:
        if name not in kernels:
            yield build_ctx.finding(
                _ID, build.sources[name],
                f"build.SOURCES names '{name}' but csrc/{name}.cu defines "
                f"no 'extern \"C\" int {name}_launch('")
    ops_defs = {n.name for n in ops_ctx.tree.body
                if isinstance(n, ast.FunctionDef)} if ops_ctx else set()
    ref_defs = {n.name for n in ref_ctx.tree.body
                if isinstance(n, ast.FunctionDef)} if ref_ctx else set()
    launches = set()
    if ops_ctx is not None:
        counts = _module_assigns(ops_ctx).get("LAUNCHES")
        if isinstance(counts, ast.Dict):
            launches = {k.value for k in counts.keys
                        if isinstance(k, ast.Constant)}
    tests = [c.source for c in project.iter_matching(cfg.test_globs)]
    smoke = project.files.get(cfg.smoke_path)
    for name, (cu_name, c_kinds) in sorted(kernels.items()):
        def finding(message: str, name=name) -> Finding:
            return build_ctx.finding(_ID, build.anchor(name),
                                     f"kernel '{name}': {message}")

        if name not in build.sources:
            yield finding(f"csrc/{cu_name} is not in build.SOURCES")
        entry = build.entries.get(name)
        if entry is None:
            yield finding("build.ENTRY_POINTS has no entry")
        else:
            _key, fn, kinds = entry
            if fn != f"{name}_launch":
                yield finding(f"build.ENTRY_POINTS names {fn!r}, not "
                              f"'{name}_launch'")
            if kinds is None:
                yield finding("build.ENTRY_POINTS' argtypes are not a "
                              "literal list of _P / _I")
            else:
                want = [k for k, _ in c_kinds]
                if len(kinds) != len(want):
                    yield finding(
                        f"the C prototype in csrc/{cu_name} takes "
                        f"{len(want)} parameter(s) but build.ENTRY_POINTS "
                        f"declares {len(kinds)} argtypes")
                else:
                    for i, ((kind, text), got) in enumerate(
                            zip(c_kinds, kinds)):
                        if kind != got:
                            yield finding(
                                f"parameter {i} of {name}_launch "
                                f"('{text}') is {kind} but its argtype is "
                                f"{got}")
        if not _includes_error_string(csrc, csrc / cu_name):
            yield finding(f"csrc/{cu_name} does not export "
                          f"'repro_cuda_error_string', which build.library "
                          f"binds")
        if name not in ref_defs:
            yield finding(f"no plain version '{name}' in {kdir}/ref.py")
        if name not in ops_defs:
            yield finding(f"no public wrapper '{name}' in {kdir}/ops.py")
        if name not in launches:
            yield finding("ops.LAUNCHES has no count for it")
        if not any(_mentions(t, name) for t in tests):
            yield finding(f"no test mentions both 'ref.{name}' and the "
                          f"'{name}' wrapper")
        if smoke is None or not _mentions(smoke.source, name):
            yield finding(f"{cfg.smoke_path} does not hold it against its "
                          f"plain version (no mention of both 'ref.{name}' "
                          f"and 'ops.{name}')")
    if ops_ctx is not None:
        yield from _check_ops(ops_ctx, build)
