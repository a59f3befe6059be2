"""Shared by the port's lifecycle test files: a scenario runs through the
reference's engine and the port's on ``tiny`` (fp32) with shared weights,
and the outcomes are held equal (tokens, lifecycle events, tracker swap /
retire events and gauges, admissions, kv stats; sampled logprobs within
1e-5)."""
import dataclasses

import jax
import numpy as np

import repro.serve as jserve
from repro.configs import get_config as jget_config
from repro.models import model as jmodel
from repro.obs import InMemoryTracker as JTracker
import repro_torch.serve as tserve
from repro_torch import interop
from repro_torch.configs import get_config

LOGPROB_TOL = 1e-5
#: sampled rows: the spec tests' traffic (top-k keeps the nucleus exact)
SAMPLED = dict(temperature=0.8, top_k=40, seed=7, logprobs=2)
BANK_GAUGES = ("engine/bank/epoch", "engine/bank/columns",
               "engine/bank/live_epochs")


def host(tree):
    """A reference tree as the port's tensors on the CPU."""
    return interop.params_from_numpy(jax.tree.map(np.asarray, tree),
                                     device="cpu")


#: the reference engine's jitted step functions, by max_len: they close
#: over the engine's serving config and max_len only, so every reference
#: engine of one max_len reuses the first one's compiled executables
_JITS = {}
_JIT_FNS = ("_decode", "_prefill", "_prefill_paged", "_verify_paged",
            "_draft_scan")


def _share_jits(eng):
    fns = _JITS.setdefault(eng.max_len, {f: getattr(eng, f)
                                         for f in _JIT_FNS})
    for f, fn in fns.items():
        setattr(eng, f, fn)


class Side:
    """One package's view of a scenario: its serve namespace, tracker,
    config and params, and its copy of each adapter."""

    def __init__(self, ns, tracker, cfg, params, convert):
        self.ns, self.tracker, self.cfg = ns, tracker, cfg
        self.params, self.convert = params, convert
        self.is_port = ns is tserve

    def engine(self, base=None, **kw):
        kw = dict(dict(max_len=48, slots=2), **kw)
        if self.is_port:
            kw["device"] = "cpu"
        eng = self.ns.ServeEngine(self.params if base is None else base,
                                  self.cfg, **kw)
        if not self.is_port:
            _share_jits(eng)
        return eng

    def adapter(self, jtree):
        return self.convert(jtree)

    def request(self, uid, prompt, max_new_tokens=16, adapter="base",
                sampled=False):
        sp = None
        if sampled:
            sp = self.ns.SamplingParams(**{**SAMPLED, "seed": 7 + uid})
        return self.ns.Request(uid=uid, prompt=prompt.copy(),
                               max_new_tokens=max_new_tokens,
                               adapter=adapter, sampling=sp)


def make_sides():
    """``(reference, port)`` over the reference's ``tiny`` params from
    seed 0."""
    jcfg = jget_config("tiny")
    params = jax.jit(lambda k: jmodel.init_params(k, jcfg))(
        jax.random.PRNGKey(0))
    ref = Side(jserve, JTracker, jcfg, params, lambda t: t)
    port = Side(tserve, tserve.InMemoryTracker, get_config("tiny"),
                host(params), host)
    return ref, port


def prompt(n, off, vocab):
    return ((np.arange(n, dtype=np.int32) * 3 + 1 + off)
            % vocab).astype(np.int32)


def once_at(step, fn):
    """A step hook firing exactly once, at engine step ``step``."""
    fired = []

    def hook(engine, s):
        if s == step and not fired:
            fired.append(s)
            fn(engine, s)
    return hook


def tokens(done):
    return {r.uid: list(r.generated) for r in done}


def outcome(eng, done):
    """What the two packages' runs of one scenario must share."""
    tr = eng.tracker
    return dict(
        tokens=tokens(done),
        reasons={r.uid: r.finish_reason for r in done},
        events=[dataclasses.astuple(e) for e in eng.lifecycle.events],
        admissions=[dataclasses.astuple(e) for e in eng.admission_events],
        kv=dict(eng.kv.stats),
        swaps=tr.events_named("engine/bank/swap"),
        retired=tr.events_named("engine/bank/epoch_retired"),
        failed=[{k: v for k, v in e.items() if k != "error"}
                for e in tr.events_named("engine/bank/swap_failed")],
        gauges={g: tr.gauges.get(g) for g in BANK_GAUGES},
        swap_failed=tr.counter("engine/warnings/swap_failed"))


def _logprobs(done):
    return {r.uid: [(lp.token, lp.logprob, lp.top_tokens, lp.top_logprobs)
                    for lp in r.logprobs] for r in done}


def same(want_run, got_run):
    """The port's ``(engine, done)`` against the reference's."""
    want, got = outcome(*want_run), outcome(*got_run)
    for key in want:
        assert got[key] == want[key], key
    want_lp, got_lp = _logprobs(want_run[1]), _logprobs(got_run[1])
    assert got_lp.keys() == want_lp.keys()
    for uid in want_lp:
        assert len(got_lp[uid]) == len(want_lp[uid])
        for (t, lp, tt, tl), (wt, wlp, wtt, wtl) in zip(got_lp[uid],
                                                       want_lp[uid]):
            assert (t, tt) == (wt, wtt)
            assert abs(lp - wlp) <= LOGPROB_TOL
            assert np.allclose(tl, wtl, rtol=0, atol=LOGPROB_TOL)


def both(sides, scenario):
    """Run ``scenario(side) -> (engine, done)`` on the reference and on
    the port; assert identical outcomes; return the port's run."""
    ref, port = sides
    want = scenario(ref)
    got = scenario(port)
    same(want, got)
    return got
