"""Rule engine of the port's static checker.

Pure stdlib (``ast`` + ``fnmatch``), like the reference checker's engine,
of which this is the port's own copy: it runs where nothing is installed,
so nothing here imports torch, numpy or any module it checks.  Rules
register themselves in :data:`RULES` via the :func:`rule` decorator;
:func:`run_analysis` walks a :class:`ProjectContext` (every indexed file)
and applies file-scoped rules to each target file and project-scoped rules
to the whole index.

Findings are suppressed inline with ``# repro-lint: disable=RULE`` on the
offending line (``disable=all`` silences every rule; a module-level
``# repro-lint: disable-file=RULE`` comment silences a whole file) and
grandfathered via a baseline (see :mod:`repro_torch.analysis.baseline`).
Fingerprints hash the rule, path, enclosing symbol, and the stripped text
of the offending line — not the line *number* — so baselines survive
unrelated edits above a finding.

A file is parsed, and its parent links built, the first time a rule asks
for them: a rule that only reads source text (the test and ``chip_smoke``
mentions of a kernel) pays for no syntax tree.  Target files are parsed
up front so that a syntax error in one is a ``PARSE`` finding.
"""
from __future__ import annotations

import ast
import dataclasses
import fnmatch
import hashlib
import re
from pathlib import Path
from typing import Callable, Dict, Iterable, Iterator, List, Optional, Set, Tuple

__all__ = [
    "Finding", "FileContext", "ProjectContext", "AnalysisResult",
    "RuleSpec", "RULES", "rule", "run_analysis", "match_any",
]

_SUPPRESS_RE = re.compile(r"#\s*repro-lint:\s*disable=([A-Za-z0-9_\-, ]+)")
_SUPPRESS_FILE_RE = re.compile(
    r"#\s*repro-lint:\s*disable-file=([A-Za-z0-9_\-, ]+)")


def match_any(name: str, globs: Iterable[str]) -> bool:
    """fnmatch ``name`` against any of ``globs``."""
    return any(fnmatch.fnmatch(name, g) for g in globs)


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation, anchored to a file position.

    ``symbol`` is the dotted name of the enclosing function/class (stable
    across reformats); ``fingerprint`` is filled by the runner and is the
    baseline-matching key."""
    rule: str
    path: str
    line: int
    col: int
    message: str
    symbol: str = ""
    fingerprint: str = ""

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class FileContext:
    """One source file plus the derived maps every rule needs: its syntax
    tree, parent links, dotted qualnames, and inline-suppression lines
    (each built on first use)."""

    def __init__(self, root: str, path: str, source: str):
        self.root = root
        self.path = path                      # root-relative, posix
        self.source = source
        self.lines = source.splitlines()
        self._tree: Optional[ast.Module] = None
        self._parents: Optional[Dict[ast.AST, ast.AST]] = None
        self._suppress: Optional[Dict[int, Set[str]]] = None
        self._suppress_file: Set[str] = set()

    @property
    def tree(self) -> ast.Module:
        """The parsed module; an empty one for a file that does not parse
        (a target that does not parse is a ``PARSE`` finding instead)."""
        if self._tree is None:
            try:
                self._tree = ast.parse(self.source, filename=self.path)
            except SyntaxError:
                self._tree = ast.Module(body=[], type_ignores=[])
        return self._tree

    # -- tree navigation ---------------------------------------------------
    def _parent_map(self) -> Dict[ast.AST, ast.AST]:
        if self._parents is None:
            self._parents = {}
            for parent in ast.walk(self.tree):
                for child in ast.iter_child_nodes(parent):
                    self._parents[child] = parent
        return self._parents

    def parent(self, node: ast.AST) -> Optional[ast.AST]:
        return self._parent_map().get(node)

    def ancestors(self, node: ast.AST) -> Iterator[ast.AST]:
        parents = self._parent_map()
        cur = parents.get(node)
        while cur is not None:
            yield cur
            cur = parents.get(cur)

    def qualname(self, node: ast.AST) -> str:
        """Dotted name of the innermost def/class scope holding ``node``
        (including ``node`` itself when it is a def/class); ``<module>``
        at top level."""
        parents = self._parent_map()
        parts: List[str] = []
        cur: Optional[ast.AST] = node
        while cur is not None:
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef,
                                ast.ClassDef)):
                parts.append(cur.name)
            cur = parents.get(cur)
        return ".".join(reversed(parts)) or "<module>"

    def functions(self) -> Iterator[ast.FunctionDef]:
        for node in ast.walk(self.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                yield node

    # -- suppression -------------------------------------------------------
    def _suppressions(self) -> Dict[int, Set[str]]:
        if self._suppress is None:
            self._suppress = {}
            for i, text in enumerate(self.lines, start=1):
                m = _SUPPRESS_RE.search(text)
                if m:
                    self._suppress[i] = {
                        r.strip() for r in m.group(1).split(",")
                        if r.strip()}
                m = _SUPPRESS_FILE_RE.search(text)
                if m:
                    self._suppress_file |= {
                        r.strip() for r in m.group(1).split(",")
                        if r.strip()}
        return self._suppress

    def suppressed(self, rule_id: str, line: int) -> bool:
        active = self._suppressions().get(line, ())
        if self._suppress_file & {rule_id, "all"}:
            return True
        return rule_id in active or "all" in active

    def finding(self, rule_id: str, node: ast.AST, message: str) -> Finding:
        return Finding(rule=rule_id, path=self.path,
                       line=getattr(node, "lineno", 1),
                       col=getattr(node, "col_offset", 0),
                       message=message, symbol=self.qualname(node))


class ProjectContext:
    """Every indexed file, plus which of them are report targets."""

    def __init__(self, cfg):
        self.cfg = cfg
        self.files: Dict[str, FileContext] = {}
        self.targets: List[str] = []
        self.parse_errors: List[Finding] = []

    def iter_matching(self, globs: Iterable[str]) -> Iterator[FileContext]:
        for path in sorted(self.files):
            if match_any(path, globs):
                yield self.files[path]


@dataclasses.dataclass
class AnalysisResult:
    findings: List[Finding]
    suppressed: int
    files_checked: int


@dataclasses.dataclass(frozen=True)
class RuleSpec:
    id: str
    scope: str                      # "file" | "project"
    fn: Callable[..., Iterator[Finding]]
    doc: str


#: the registry — importing :mod:`repro_torch.analysis.rules` populates it
RULES: Dict[str, RuleSpec] = {}


def rule(rule_id: str, scope: str = "file"):
    """Register a rule.  ``scope='file'`` rules get ``(FileContext, cfg)``
    per target file; ``scope='project'`` rules get ``(ProjectContext, cfg)``
    once and may anchor findings on any indexed file (the runner drops
    findings outside the target set)."""
    assert scope in ("file", "project"), scope

    def deco(fn):
        RULES[rule_id] = RuleSpec(rule_id, scope, fn,
                                  (fn.__doc__ or "").strip())
        return fn
    return deco


def _relpath(root: Path, p: Path) -> str:
    return p.relative_to(root).as_posix()


def build_project(cfg, target_paths: Iterable[str]) -> ProjectContext:
    """Index ``cfg.index_globs`` under ``cfg.root``; mark everything under
    ``target_paths`` (files or directories, root-relative or absolute) as
    report targets."""
    root = Path(cfg.root).resolve()
    project = ProjectContext(cfg)
    for glob in cfg.index_globs:
        for p in sorted(root.glob(glob)):
            if not p.is_file():
                continue
            rel = _relpath(root, p)
            if rel not in project.files:
                project.files[rel] = FileContext(str(root), rel,
                                                 p.read_text())
    target_rels: Set[str] = set()
    for raw in target_paths:
        p = Path(raw)
        p = p if p.is_absolute() else root / p
        p = p.resolve()
        if p.is_file():
            rel = _relpath(root, p)
            if rel not in project.files and p.suffix == ".py":
                project.files[rel] = FileContext(str(root), rel,
                                                 p.read_text())
            target_rels.add(rel)
        else:
            prefix = _relpath(root, p) if p != root else ""
            for rel in project.files:
                if not prefix or rel == prefix or \
                        rel.startswith(prefix + "/"):
                    target_rels.add(rel)
    for rel in sorted(target_rels & set(project.files)):
        ctx = project.files[rel]
        try:
            ctx._tree = ast.parse(ctx.source, filename=rel)
        except SyntaxError as e:
            del project.files[rel]
            project.parse_errors.append(Finding(
                rule="PARSE", path=rel, line=e.lineno or 1, col=0,
                message=f"syntax error: {e.msg}"))
            continue
        project.targets.append(rel)
    return project


def _fingerprint(ctx: Optional[FileContext], f: Finding, salt: int) -> str:
    text = ""
    if ctx is not None and 1 <= f.line <= len(ctx.lines):
        text = ctx.lines[f.line - 1].strip()
    key = f"{f.rule}|{f.path}|{f.symbol}|{text}|{salt}"
    return hashlib.sha256(key.encode()).hexdigest()[:16]


def run_analysis(cfg, target_paths: Iterable[str]) -> AnalysisResult:
    """Run every registered rule; return deduped, fingerprinted findings on
    target files (inline suppressions already removed)."""
    project = build_project(cfg, target_paths)
    target_set = set(project.targets) | \
        {f.path for f in project.parse_errors}
    raw: List[Finding] = list(project.parse_errors)
    for spec in RULES.values():
        if spec.scope == "file":
            for rel in project.targets:
                raw.extend(spec.fn(project.files[rel], cfg))
        else:
            raw.extend(spec.fn(project, cfg))
    raw = [f for f in raw if f.path in target_set]
    # dedup (nested hot scopes can visit one call twice)
    uniq: Dict[Tuple, Finding] = {}
    for f in raw:
        uniq.setdefault((f.rule, f.path, f.line, f.col, f.message), f)
    kept: List[Finding] = []
    n_suppressed = 0
    for f in sorted(uniq.values(),
                    key=lambda f: (f.path, f.line, f.col, f.rule)):
        ctx = project.files.get(f.path)
        if ctx is not None and ctx.suppressed(f.rule, f.line):
            n_suppressed += 1
            continue
        kept.append(f)
    # fingerprint, salting repeats of an identical (rule, symbol, text) key
    counts: Dict[str, int] = {}
    final: List[Finding] = []
    for f in kept:
        ctx = project.files.get(f.path)
        base = _fingerprint(ctx, f, 0)
        salt = counts.get(base, 0)
        counts[base] = salt + 1
        fp = base if salt == 0 else _fingerprint(ctx, f, salt)
        final.append(dataclasses.replace(f, fingerprint=fp))
    return AnalysisResult(findings=final, suppressed=n_suppressed,
                          files_checked=len(project.targets))
