"""repro_torch.analysis — the port's static checker.

The counterpart of the reference's ``repro.analysis``
(``docs/static_analysis.md`` describes the shared engine: suppressions,
baselines, fingerprints, reports), with AST rules over the port's own
contracts:

- HOSTSYNC          device->host syncs on the serving decode hot path
- RNG-DISCIPLINE    seeding or drawing entropy outside the counter scheme
- OBS-GATE          ungated tracker calls on the decode hot path
- KERNEL-CONTRACT   CUDA entry point <-> ctypes argtypes <-> launch call,
                    oracle, wrapper, test and on-card check per kernel
- DEPRECATION       shims must warn, warnings must be test-covered

Run ``python -m repro_torch.analysis`` (default target
``src/repro_torch``); suppress a line with ``# repro-lint: disable=RULE``.
Stdlib-only; :mod:`repro_torch.analysis.dispatch_tools` imports torch
lazily for the dispatch-level host-sync check tests and the on-card check
use.
"""
from . import rules  # noqa: F401  (populates the registry)
from .config import AnalysisConfig, default_config
from .core import (RULES, AnalysisResult, FileContext, Finding,
                   ProjectContext, rule, run_analysis)

__all__ = [
    "AnalysisConfig", "default_config", "AnalysisResult", "FileContext",
    "Finding", "ProjectContext", "RULES", "rule", "run_analysis",
]
