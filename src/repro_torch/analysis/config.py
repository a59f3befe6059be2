"""Checker configuration: which files are hot paths, which host-boundary
calls are blessed, where the RNG discipline applies, where the kernels and
their contract live.

:func:`default_config` encodes the port's invariants — the serving decode
loop, the counter-RNG scheme, the kernels' C interface.  Tests build ad-hoc
configs pointing at fixture trees, so nothing in
:mod:`repro_torch.analysis.core` or the rules may assume the defaults.  The
fields the reference checker also has mean the same there.

Qualname globs match the dotted names :meth:`FileContext.qualname` builds
(``ServeEngine._sample_rows``, ``lora_init``); path globs match
root-relative posix paths.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

__all__ = ["AnalysisConfig", "default_config"]

PathGlobs = Tuple[str, ...]


@dataclasses.dataclass(frozen=True)
class AnalysisConfig:
    #: repo root every path is relative to
    root: str
    #: files read into the project index (targets must fall inside)
    index_globs: PathGlobs = ("src/repro_torch/**/*.py",
                              "tests/test_torch_*.py", "chip_smoke.py")

    # -- HOSTSYNC ----------------------------------------------------------
    #: path -> qualname globs of host-side functions on the decode hot path
    hostsync_hot: Dict[str, PathGlobs] = dataclasses.field(
        default_factory=dict)
    #: (path glob, qualname glob, call key) triples naming the blessed
    #: host-boundary transfers, e.g. the sampler's packed ``.cpu()``
    hostsync_allow: Tuple[Tuple[str, str, str], ...] = ()

    # -- RNG-DISCIPLINE ----------------------------------------------------
    #: where the discipline applies at all (library code, not tests)
    rng_scope: PathGlobs = ()
    #: (path glob, qualname glob) pairs allowed to seed or draw entropy
    rng_allow: Tuple[Tuple[str, str], ...] = ()

    # -- OBS-GATE ----------------------------------------------------------
    #: path -> qualname globs of functions whose tracker calls must be
    #: gated behind ``_obs`` / ``is_noop`` checks
    obsgate_hot: Dict[str, PathGlobs] = dataclasses.field(
        default_factory=dict)

    # -- KERNEL-CONTRACT ---------------------------------------------------
    #: directory of the kernel package: ``build.py``, ``ops.py``,
    #: ``ref.py`` and the CUDA sources under ``csrc/``
    kernels_dir: str = "src/repro_torch/kernels"
    #: the on-card check that holds every kernel against its plain version
    smoke_path: str = "chip_smoke.py"
    #: where tests live, for the oracle/wrapper pairing check
    test_globs: PathGlobs = ("tests/test_torch_*.py",)

    # -- DEPRECATION -------------------------------------------------------
    #: files whose DeprecationWarning shims must be test-covered
    deprecation_scope: PathGlobs = ("src/repro_torch/**", "chip_smoke.py")


_PKG = "src/repro_torch"
_ENGINE = f"{_PKG}/serve/engine.py"
_SAMPLING = f"{_PKG}/serve/sampling.py"


def default_config(root: str) -> AnalysisConfig:
    """The port's own invariant map.

    Each set stands for a runtime pin on the card, which the CPU tests
    skip:

    - the HOSTSYNC hot set is the host side of one decode step, from
      ``_decode_live`` through the sampler call (``_draw``) to its one
      transfer (``sampling.to_host``), plus the spec path's
      ``_spec_step`` / ``_spec_group``: the functions whose syncs
      ``tests/test_torch_cuda.py``'s
      ``test_serving_wrappers_never_sync_with_the_host`` and
      ``test_spec_decode_syncs_once_per_draft_pass_and_accept`` count
      under ``set_sync_debug_mode("warn")``, and that ``chip_smoke.py``'s
      phase 32 holds to one sync a step;
    - the HOSTSYNC allowlist is that one transfer: the packed ``.cpu()``
      in ``sampling.to_host``, the counterpart of the reference's batched
      ``jax.device_get``;
    - the RNG allowlist is what ``tests/test_torch_sampling.py`` (the
      threefry keys and bits exact against jax), the ``n > 1`` branch
      seeds of ``tests/test_torch_spec.py`` and the init and data parity
      tests pin: the counter scheme, the engine's two seed derivations,
      init trees, the launch path, the seeded data pipeline and the
      examples;
    - the OBS-GATE list is the per-decode-step call graph of
      ``run_stream``, whose tracker metrics ``tests/test_torch_obs.py``
      holds to the reference's (admission and prefill span timers run once
      per request and stay caller-discretion)."""
    return AnalysisConfig(
        root=root,
        hostsync_hot={
            _ENGINE: ("*._sample_rows", "*._spec_group", "*._spec_step",
                      "*._decode_live", "*._draw"),
            _SAMPLING: ("to_host",),
        },
        hostsync_allow=(
            # the one device-to-host transfer a sampler call makes
            (_SAMPLING, "to_host", ".cpu"),
        ),
        rng_scope=(f"{_PKG}/**",),
        rng_allow=(
            # the counter scheme itself: every sampling draw is
            # fold_in(PRNGKey(seed), n_generated) in serve/sampling.py
            (_SAMPLING, "*"),
            # the engine's per-request seed and its n > 1 branch seeds
            (_ENGINE, "*._seed_for"),
            (_ENGINE, "*._submit_fanout"),
            # parameter init trees (one generator, seeded once, before any
            # serving)
            (f"{_PKG}/models/*.py", "*init*"),
            (f"{_PKG}/core/*.py", "*init*"),
            # the launch path seeds the run from its config
            (f"{_PKG}/launch/*.py", "*"),
            # the synthetic data pipeline's seeded numpy generators
            (f"{_PKG}/data/pipeline.py", "*.__init__"),
            (f"{_PKG}/data/pipeline.py", "*.batch_at"),
            # runnable examples make their own data
            (f"{_PKG}/examples/**", "*"),
        ),
        obsgate_hot={
            _ENGINE: ("*.run_stream", "*._decode_live", "*._spec_step",
                      "*._spec_group", "*._sample_rows",
                      "*._ensure_decode_pages", "*._suspend",
                      "*._finish_slot"),
            f"{_PKG}/serve/scheduler.py": ("*.push", "*.window"),
        },
    )
