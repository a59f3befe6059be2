"""RNG-DISCIPLINE — the counter scheme stays the only source of sampling
entropy.

Speculative decoding's bit-identity (spec on/off give the same tokens) and
the port's token parity with the reference hold ONLY because every
sampling draw derives its key as ``fold_in(PRNGKey(seed), n_generated)``
through the threefry counter scheme of ``serve/sampling.py``: draws never
consume stateful generator state, so preemption, resume, and draft/verify
re-ordering cannot shift later draws.  So, in library code outside the
allowlist, the rule flags:

- the scheme's key constructors ``fold_in``, ``threefry2x32``,
  ``derive_seed`` and ``branch_seed``, whatever module they come through;
- seeding: ``torch.Generator(...)``, any ``.manual_seed()`` /
  ``.manual_seed_all()``, and ``seed`` / ``set_rng_state`` / ``fork_rng``
  through ``torch``, ``torch.random`` or ``torch.cuda``;
- a draw on torch's global generator: ``torch.rand`` / ``randn`` /
  ``randint`` / ``randperm`` / ``normal`` / ``poisson`` / ``multinomial``
  / ``bernoulli`` and the ``*_like`` forms, and the tensor methods
  ``normal_`` / ``uniform_`` / ``bernoulli_`` / ``random_`` /
  ``exponential_`` / ``cauchy_`` / ``log_normal_`` / ``geometric_`` /
  ``multinomial`` / ``bernoulli``, each without ``generator=``;
- numpy's entropy: any ``np.random.*`` call (``default_rng`` included).

A draw that passes ``generator=`` consumes a generator someone seeded, and
the seeding is what the rule flags.  Init trees, the launch path, the data
pipeline and the examples are allowlisted in ``cfg.rng_allow``.
"""
from __future__ import annotations

import ast
import fnmatch
import re
from typing import Iterator

from ..core import FileContext, Finding, match_any, rule

_KEY_FNS = {"fold_in", "threefry2x32", "derive_seed", "branch_seed"}
_SEEDERS = {"seed", "seed_all", "manual_seed", "manual_seed_all",
            "set_rng_state", "set_rng_state_all", "fork_rng"}
_SEED_MODULES = ("torch", "torch.random", "torch.cuda", "torch.cuda.random")
_GLOBAL_DRAWS = {"rand", "randn", "randint", "randperm", "normal", "poisson",
                 "multinomial", "bernoulli", "rand_like", "randn_like",
                 "randint_like"}
_TENSOR_DRAWS = {"normal_", "uniform_", "bernoulli_", "random_",
                 "exponential_", "cauchy_", "log_normal_", "geometric_",
                 "multinomial", "bernoulli"}
#: every callee name the rule can flag, and a regex of them: a file whose
#: text matches none holds no finding and is not walked
_NAMES = _KEY_FNS | _SEEDERS | _GLOBAL_DRAWS | _TENSOR_DRAWS | {"Generator"}
_TEXT_RE = re.compile("|".join(sorted(_NAMES | {"random"})))


def _unparse(node: ast.AST) -> str:
    try:
        return ast.unparse(node)
    except Exception:                                    # pragma: no cover
        return ""


def _flagged(node: ast.Call) -> bool:
    func = node.func
    last = func.attr if isinstance(func, ast.Attribute) else \
        getattr(func, "id", "")
    if last not in _NAMES and not (isinstance(func, ast.Attribute)
                                   and "random" in ast.unparse(func.value)):
        return False
    name = _unparse(func)
    if last in _KEY_FNS or name == "torch.Generator":
        return True
    if last in ("manual_seed", "manual_seed_all"):
        return True
    head = name.rsplit(".", 1)[0] if "." in name else ""
    if last in _SEEDERS and head in _SEED_MODULES:
        return True
    if name.startswith(("np.random.", "numpy.random.")):
        return True
    if any(k.arg == "generator" for k in node.keywords):
        return False
    if head == "torch" and last in _GLOBAL_DRAWS:
        return True
    return isinstance(func, ast.Attribute) and head != "torch" and \
        last in _TENSOR_DRAWS


@rule("RNG-DISCIPLINE")
def check_rng(ctx: FileContext, cfg) -> Iterator[Finding]:
    """Seeding or drawing entropy outside the sampling counter scheme and
    the allowlisted init paths."""
    if not match_any(ctx.path, cfg.rng_scope) or \
            not _TEXT_RE.search(ctx.source):
        return
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call) or not _flagged(node):
            continue
        qn = ctx.qualname(node)
        if any(fnmatch.fnmatch(ctx.path, pg) and fnmatch.fnmatch(qn, qg)
               for (pg, qg) in cfg.rng_allow):
            continue
        name = _unparse(node.func)
        yield ctx.finding(
            "RNG-DISCIPLINE", node,
            f"'{name}' in '{qn}': entropy outside the sampling counter "
            f"scheme breaks spec-decode bit-identity; derive draws from "
            f"fold_in(PRNGKey(seed), n_generated) in serve/sampling.py "
            f"or allowlist a genuine init path")
