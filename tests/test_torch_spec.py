"""The port's speculative decoding and ``n > 1`` fan-out against the
reference's on ``tiny`` (fp32) with shared weights: ``SpecConfig`` and
``accepted_prefix`` on seeded draft/target pairs, the cost model's draft
and verify costs, ``truncate_slot`` in lockstep with the reference
allocator, ``paged_prefill(all_logits=True)`` over prefixes that are not
page-aligned, greedy spec decode on both draft policies (identical tokens,
steps, ``engine/spec/*`` metrics, admissions and kv stats), the port's
spec against its plain decode for k in {1, 2, 3, 5}, the reference test's
own sampled traffic, preemption with spec on, the window clamp, fan-out
with and without spec, and validation.  One reference engine, a fresh
allocator and tracker swapped in per run, so its jitted functions compile
once per shape; a 7-page allocator runs over that engine's 13-page pool
arrays (it never hands out a page past its own count)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny tensors: one intra-op thread, so the suite's parallel workers do not
# contend with idle-spinning thread pools
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.serve as jserve  # noqa: E402
from benchmarks.common import nudge_psoft  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.obs import InMemoryTracker  # noqa: E402
from repro.serve import kv_cache as jkv, spec as jspec  # noqa: E402
import repro_torch.serve as tserve  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.serve import kv_cache as tkv, spec as tspec  # noqa: E402
import ssm_pairs as sp  # noqa: E402

#: the reference test's engine: slots of 48 tokens in pages of 8
ENGINE = dict(max_len=48, slots=2, page_size=8)
ROOMY, TIGHT = 13, 7
LOGPROB_TOL = 1e-5
#: the reference test's sampled traffic (seeds 7 + uid)
SAMPLED = dict(temperature=0.8, top_k=40, seed=7, logprobs=2)


@pytest.fixture(scope="module", autouse=True)
def _compiled_rotations():
    with sp.compiled_reference_rotations():
        yield


@pytest.fixture(scope="module")
def setup():
    """The reference's ``tiny`` params from seed 0 and the port's copy,
    with the ``tuned`` adapter (``nudge_psoft(params, 1e-4)``) on both
    sides, and the reference engine."""
    jcfg = jget_config("tiny")
    params = jax.jit(lambda k: jmodel.init_params(k, jcfg))(
        jax.random.PRNGKey(0))
    tuned = nudge_psoft(params, 1e-4)
    host = lambda t: interop.params_from_numpy(  # noqa: E731
        jax.tree.map(np.asarray, t), device="cpu")
    eng = jserve.ServeEngine(params, jcfg, cache_mode="paged",
                             num_pages=ROOMY, **ENGINE)
    eng.register_adapter("tuned", tuned, jcfg.peft)
    return jcfg, params, host(params), host(tuned), eng


def _reference(setup, num_pages=ROOMY, spec=None):
    eng = setup[4]
    eng.kv = jkv.PagedKVCache(eng.cfg, ENGINE["slots"], ENGINE["max_len"],
                              page_size=ENGINE["page_size"],
                              num_pages=num_pages)
    eng.kv.pools = jmodel.init_cache(eng.cfg, ENGINE["slots"],
                                     ENGINE["max_len"],
                                     page_size=ENGINE["page_size"],
                                     num_pages=ROOMY)
    eng.tracker = InMemoryTracker()
    eng.admission_events, eng.preemption_events = [], []
    eng.default_spec = None if spec is None else jspec.SpecConfig(
        k=spec.k, draft_adapter=spec.draft_adapter)
    return eng


def _port(setup, num_pages=ROOMY, spec=None):
    eng = tserve.ServeEngine(setup[2], get_config("tiny"), device="cpu",
                             num_pages=num_pages, spec=spec,
                             tracker=tserve.InMemoryTracker(), **ENGINE)
    eng.register_adapter("tuned", setup[3])
    return eng


def _requests(ns, vocab, n=3, max_new=10, adapter="base", sampling=None,
              spec=None):
    """The reference test's traffic, built from package ``ns``."""
    return [ns.Request(uid=u, prompt=(np.arange(6) * 5 + 13 * u + 1)
                       % vocab, max_new_tokens=max_new, adapter=adapter,
                       sampling=None if sampling is None
                       else ns.SamplingParams(**{**sampling, "seed": 7 + u}),
                       spec=spec)
            for u in range(n)]


def _spec_metrics(tr):
    return {name: (tr.counter(name) if "tokens" in name
                   else list(tr.values(name)))
            for name in ("engine/spec/draft_tokens",
                         "engine/spec/accepted_tokens",
                         "engine/spec/accepted_len",
                         "engine/spec/accept_rate")}


def _summary(eng, done, steps):
    return dict(
        tokens={r.uid: list(r.generated) for r in done},
        reasons={r.uid: r.finish_reason for r in done},
        steps=steps,
        spec=_spec_metrics(eng.tracker),
        ghost_rows=eng.tracker.counter("sampler/ghost_rows"),
        admissions=[dataclasses.astuple(e) for e in eng.admission_events],
        preemptions=[dataclasses.astuple(e)
                     for e in eng.preemption_events],
        kv=dict(eng.kv.stats))


def _logprobs(done):
    return {r.uid: [(lp.token, lp.logprob, lp.top_tokens, lp.top_logprobs)
                    for lp in r.logprobs] for r in done}


def _both(setup, workload, spec=None, num_pages=ROOMY, stream=False):
    """Serve ``workload(ns)`` on the reference and on the port with the
    engine-wide ``spec``; assert identical outcomes (logprobs within
    :data:`LOGPROB_TOL`) and return the port's engine and results."""
    out = []
    for ns, make in ((jserve, _reference), (tserve, _port)):
        sc = None if spec is None else ns.SpecConfig(**spec)
        eng = make(setup, num_pages, sc)
        work = workload(ns)
        done = (eng.run_stream(work, max_steps=400) if stream
                else eng.run(work, max_steps=400))
        assert all(r.done for r in done), [(r.uid, r.done) for r in done]
        assert eng.kv.pages_in_use() == 0, "run leaked pages"
        steps = eng.last_run_steps if ns is jserve \
            else eng.last_run_stats["steps"]
        out.append((eng, done, steps))
    (jeng, jdone, jsteps), (teng, tdone, tsteps) = out
    want, got = _summary(jeng, jdone, jsteps), _summary(teng, tdone, tsteps)
    for key in want:
        assert got[key] == want[key], key
    want_lp, got_lp = _logprobs(jdone), _logprobs(tdone)
    assert got_lp.keys() == want_lp.keys()
    for uid in want_lp:
        assert len(got_lp[uid]) == len(want_lp[uid])
        for (t, lp, tt, tl), (wt, wlp, wtt, wtl) in zip(got_lp[uid],
                                                       want_lp[uid]):
            assert (t, tt) == (wt, wtt)
            assert abs(lp - wlp) <= LOGPROB_TOL
            assert np.allclose(tl, wtl, rtol=0, atol=LOGPROB_TOL)
    return teng, tdone


def _tokens(done):
    return {r.uid: list(r.generated) for r in done}


# -- the acceptance rule, the cost model and rollback ------------------------

def test_accepted_prefix_and_spec_config_match_reference():
    rng = np.random.default_rng(0)
    for _ in range(300):
        k = int(rng.integers(0, 6))
        target = rng.integers(0, 3, size=k + 1)
        draft = np.where(rng.random(k) < 0.7, target[:k],
                         rng.integers(0, 3, size=k))
        got = tspec.accepted_prefix(draft, target)
        assert got == jspec.accepted_prefix(draft, target)
        assert 1 <= len(got) <= k + 1
    assert tspec.SpecConfig() == tspec.SpecConfig(k=4, draft_adapter="base")
    assert (tspec.SpecConfig().k, tspec.SpecConfig().draft_adapter) == \
        (jspec.SpecConfig().k, jspec.SpecConfig().draft_adapter)
    assert tspec.BASE_DRAFT == jspec.BASE_DRAFT
    for ns in (tspec, jspec):
        with pytest.raises(ValueError, match=r"spec k must be >= 0 \(0 = "
                                             r"off\), got -1"):
            ns.SpecConfig(k=-1)
        with pytest.raises(dataclasses.FrozenInstanceError):
            ns.SpecConfig().k = 2


@pytest.mark.parametrize("kw", [{}, dict(decode_step_cost=2.0,
                                         prefill_token_cost=0.25),
                                dict(draft_step_cost=0.3,
                                     prefill_token_cost=0.1)])
def test_cost_model_draft_and_verify_costs_match_reference(kw):
    t, j = tserve.TokenCostModel(**kw), jserve.TokenCostModel(**kw)
    for n in (0, 1, 3, 7):
        assert t.draft_cost(n) == j.draft_cost(n)
        assert t.verify_cost(4 * n) == j.verify_cost(4 * n)
    for ns in (tserve, jserve):
        with pytest.raises(ValueError, match="draft_step_cost must be > 0"):
            ns.TokenCostModel(draft_step_cost=0.0)


def test_truncate_slot_in_lockstep_with_reference():
    """Grow, truncate, alias and free in the same order on both
    allocators: identical tables, page counts, refcounts and free lists;
    an aliased prefix page a truncation releases stays resident for its
    other owner."""
    jcfg = jget_config("tiny")
    caches = (jkv.PagedKVCache(jcfg, 3, 48, page_size=8, num_pages=16),
              tkv.PagedKVCache(get_config("tiny"), 3, 48, page_size=8,
                               num_pages=16, device="cpu"))
    prompt = np.arange(20, dtype=np.int32)

    def state(c):
        return (c.tables.tolist(), c.n_pages.tolist(), c.refcount.tolist(),
                sorted(c._free), [list(o) for o in c._owned])

    rng = np.random.default_rng(3)
    oom = (jkv.OutOfPages, tkv.OutOfPages)
    for c in caches:
        c.admit(0, prompt, "base#1")
        c.commit_prompt(0, prompt, "base#1")
        c.admit(1, prompt, "base#1")          # aliases two full pages
        c.ensure_position(1, 40)
        c.truncate_slot(1, 4)
        c.truncate_slot(1, 4)                 # no-op
        c.ensure_position(0, 31)
        c.truncate_slot(0, 3)
    assert state(caches[0]) == state(caches[1])
    for _ in range(20):
        slot = int(rng.integers(0, 3))
        pos = int(rng.integers(0, 48))
        keep = int(rng.integers(1, 7))
        raised = []
        for c in caches:
            if c.n_pages[slot] == 0:
                c.admit(slot, prompt[:5], "base#1")
            try:
                c.ensure_position(slot, pos)
                raised.append(False)
            except oom:
                raised.append(True)
            c.truncate_slot(slot, keep)
        assert raised[0] == raised[1]
        assert state(caches[0]) == state(caches[1])
    for c in caches:
        c.truncate_slot(1, 1)
        for s in range(3):
            c.free_slot(s)
    assert state(caches[0]) == state(caches[1])
    assert caches[1].pages_in_use() == 0
    with pytest.raises(ValueError, match="must keep >= 1 page"):
        caches[1].truncate_slot(0, 0)


def test_paged_prefill_all_logits_matches_reference(setup):
    """Verify-shaped prefill (S = 4 window positions) over prefixes of 9,
    16 and 21 tokens (mid-page, page-aligned, mid-page), the prefix pages
    written by an earlier prefill: every real window position's logits
    within 1e-4 of the reference's, and the last one equal to the
    last-token logits of ``all_logits=False``."""
    jcfg, params, tparams = setup[0], setup[1], setup[2]
    tcfg = get_config("tiny")
    rng = np.random.default_rng(1)
    maxp, pg, b, s = 6, 8, 3, 4
    prefix = np.asarray([9, 16, 21], np.int32)
    table = (rng.permutation(b * maxp) + 1).reshape(b, maxp).astype(
        np.int32)
    seqs = rng.integers(0, jcfg.vocab_size, size=(b, 21 + s)).astype(
        np.int32)
    lens = np.full((b,), s, np.int32)
    window = np.stack([seqs[i, prefix[i]:prefix[i] + s] for i in range(b)])
    jpools = jmodel.init_cache(jcfg, b, maxp * pg, page_size=pg,
                               num_pages=1 + b * maxp)
    _, jpools = jax.jit(lambda *a: jmodel.paged_prefill(*a[:3], jcfg, *a[3:]))(
        params, {"tokens": jnp.asarray(seqs[:, :21])},
        {**jpools, "page_table": jnp.asarray(table),
         "prefix_table": jnp.asarray(table[:, :0])}, jnp.asarray(prefix),
        jnp.zeros((b,), jnp.int32))
    jl, _ = jax.jit(lambda *a: jmodel.paged_prefill(*a[:3], jcfg, *a[3:],
                                                    all_logits=True))(
        params, {"tokens": jnp.asarray(window)},
        {**jpools, "page_table": jnp.asarray(table),
         "prefix_table": jnp.asarray(table)}, jnp.asarray(lens),
        jnp.asarray(prefix))
    put = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    tpools = {k: put(v) for k, v in jpools.items()}
    cache = {**tpools, "page_table": put(table), "prefix_table": put(table)}
    tl, _ = tmodel.paged_prefill(tparams, {"tokens": put(window)}, cache,
                                 tcfg, put(lens), put(prefix),
                                 all_logits=True)
    assert tl.shape == (b, s, tcfg.vocab_size)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                               rtol=1e-4)
    cache = {k: v.clone() if k in ("k", "v") else v for k, v in cache.items()}
    last, _ = tmodel.paged_prefill(tparams, {"tokens": put(window)}, cache,
                                   tcfg, put(lens), put(prefix))
    torch.testing.assert_close(last[:, 0], tl[:, -1], rtol=0, atol=1e-5)


# -- greedy spec decode -------------------------------------------------------

@pytest.mark.parametrize("draft", ["base", "tuned"])
@pytest.mark.parametrize("k", [1, 3])
def test_greedy_spec_matches_reference(setup, draft, k):
    """Tuned-adapter requests drafting on either policy: identical tokens,
    steps, ``engine/spec/*`` counters and histogram values, admission
    events and kv stats; fewer steps than plain decode."""
    vocab = setup[0].vocab_size
    eng, done = _both(setup, lambda ns: _requests(ns, vocab, adapter="tuned"),
                      spec=dict(k=k, draft_adapter=draft))
    assert eng.tracker.counter("engine/spec/accepted_tokens") > \
        eng.last_run_stats["verify_calls"]
    plain = _port(setup)
    want = _tokens(plain.run(_requests(tserve, vocab, adapter="tuned")))
    assert _tokens(done) == want
    assert eng.last_run_stats["steps"] < plain.last_run_stats["steps"]


def test_greedy_spec_matches_plain_decode_across_k(setup):
    """The port alone: greedy spec decode gives plain decode's tokens for
    every draft length, in strictly fewer steps, one verify call per
    draft pass."""
    vocab = setup[0].vocab_size
    plain = _port(setup)
    want = _tokens(plain.run(_requests(tserve, vocab)))
    for k in (1, 2, 3, 5):
        eng = _port(setup, spec=tserve.SpecConfig(k=k))
        assert _tokens(eng.run(_requests(tserve, vocab))) == want, k
        st = eng.last_run_stats
        assert st["steps"] < plain.last_run_stats["steps"], k
        assert st["verify_calls"] == st["draft_passes"] > 0
        assert eng.kv.pages_in_use() == 0


# -- sampled spec decode ------------------------------------------------------

def test_sampled_spec_on_the_reference_tests_traffic(setup):
    """The reference test's sampled traffic: at k = 3 the port's spec
    equals the reference's spec (tokens, logprobs within 1e-5).  Against
    the port's plain decode, spec at k in {1, 2, 3} is identical up to a
    request's first divergence.  Where one exists (request 1, index 8, at
    k = 1 and 2 on the CPU) the two runs drew different tokens from the
    same context with logprobs within 1e-5 of each other, and the two
    runs' top logprobs at that index agree within 1e-5: a candidate-rank
    near tie, as in the reference."""
    vocab = setup[0].vocab_size
    _both(setup, lambda ns: _requests(ns, vocab, sampling=SAMPLED),
          spec=dict(k=3))

    def serve(spec):
        eng = _port(setup, spec=spec)
        return {r.uid: r for r in eng.run(_requests(tserve, vocab,
                                                    sampling=SAMPLED))}

    plain = serve(None)
    for k in (1, 2, 3):
        spec = serve(tserve.SpecConfig(k=k))
        for uid, r in spec.items():
            p = plain[uid]
            t = next((i for i, (a, b) in enumerate(zip(p.generated,
                                                       r.generated))
                      if a != b), None)
            if t is None:
                assert r.generated == p.generated
                continue
            a, b = p.logprobs[t], r.logprobs[t]
            assert (a.token, b.token) == (p.generated[t], r.generated[t])
            assert abs(a.logprob - b.logprob) < LOGPROB_TOL, (k, uid, t)
            assert a.top_tokens == b.top_tokens
            assert np.allclose(a.top_logprobs, b.top_logprobs, rtol=0,
                               atol=LOGPROB_TOL)


# -- preemption, clamp, stop --------------------------------------------------

def test_spec_under_preemption_matches_reference(setup):
    """``run_stream`` on a 7-page pool with spec on: a long low-priority
    request, then short deadlined high-priority ones that preempt it.
    Identical tokens and preemption events, no page in use at the end, and
    the plain run's tokens."""
    vocab = setup[0].vocab_size

    def build(ns):
        big = ns.Request(uid=0, prompt=(np.arange(6) * 3 + 1) % vocab,
                         max_new_tokens=36)
        smalls = [ns.Request(uid=1 + i, prompt=(np.arange(6) + 11 * i)
                             % vocab, max_new_tokens=8, priority=1,
                             deadline=10.0) for i in range(3)]
        return [(1, big)] + [(6 + 3 * i, r) for i, r in enumerate(smalls)]

    eng, done = _both(setup, build, spec=dict(k=3), num_pages=TIGHT,
                      stream=True)
    assert eng.last_run_preemptions >= 1
    assert not eng.kv._pins
    plain = _port(setup, num_pages=TIGHT)
    assert _tokens(plain.run_stream(build(tserve), max_steps=400)) == \
        _tokens(done)


def test_window_clamp_and_stop_mid_window(setup):
    """No request overshoots ``max_new_tokens`` whatever its pairing with
    k; a stop id accepted mid-window ends the request on it."""
    vocab = setup[0].vocab_size
    for max_new in (1, 2, 5, 7):
        eng = _port(setup, spec=tserve.SpecConfig(k=3))
        done = eng.run(_requests(tserve, vocab, max_new=max_new))
        assert all(len(r.generated) == max_new
                   and r.finish_reason == "length" for r in done)
        assert eng.kv.pages_in_use() == 0
    probe = _port(setup).run(_requests(tserve, vocab, n=1))[0].generated
    stop = int(probe[3])
    greedy_stop = dict(temperature=0.0, stop_token_ids=(stop,))

    def build(ns):
        return _requests(ns, vocab, n=1, sampling=greedy_stop)

    eng, done = _both(setup, build, spec=dict(k=3))
    (r,) = done
    assert r.finish_reason == "stop" and r.generated[-1] == stop
    assert r.generated == probe[:len(r.generated)]


# -- n > 1 --------------------------------------------------------------------

@pytest.mark.parametrize("spec", [None, dict(k=3)])
def test_fanout_matches_reference(setup, spec):
    """``n = 3`` sampled and ``n = 2`` greedy parents beside a plain
    request: per-branch tokens, seeds and prefix hits equal the
    reference's; each parent comes back once, with ``finish_reason
    "branches"`` and its own ``generated`` empty; greedy branches equal
    the single request; with spec on, the same tokens."""
    vocab = setup[0].vocab_size

    def build(ns):
        return [ns.Request(uid=100, prompt=np.arange(20) % vocab,
                           max_new_tokens=8, n=3,
                           sampling=ns.SamplingParams(temperature=0.9,
                                                      top_k=50, seed=11)),
                ns.Request(uid=5, prompt=np.arange(8) % vocab,
                           max_new_tokens=8),
                ns.Request(uid=6, prompt=np.arange(8) % vocab,
                           max_new_tokens=8, n=2,
                           sampling=ns.SamplingParams.greedy())]

    jeng = _reference(setup, spec=None if spec is None
                      else jspec.SpecConfig(**spec))
    jdone = jeng.run(build(jserve), max_steps=400)
    teng = _port(setup, spec=None if spec is None
                 else tserve.SpecConfig(**spec))
    tdone = teng.run(build(tserve), max_steps=400)
    assert [r.uid for r in tdone] == [r.uid for r in jdone]
    assert teng.kv.stats == dict(jeng.kv.stats)
    assert teng.kv.stats["prefix_hits"] > 0 and teng.kv.pages_in_use() == 0
    for tr, jr in zip(tdone, jdone):
        assert (tr.done, tr.finish_reason, tr.generated, tr.admit_step,
                tr.finish_step) == (jr.done, jr.finish_reason,
                                    list(jr.generated), jr.admit_step,
                                    jr.finish_step)
        assert [(b.uid, b.sampling.seed, b.generated, b.finish_reason)
                for b in tr.branches] == \
            [(b.uid, b.sampling.seed, list(b.generated), b.finish_reason)
             for b in jr.branches]
    by_uid = {r.uid: r for r in tdone}
    par = by_uid[100]
    assert par.finish_reason == "branches" and not par.generated
    assert len({tuple(b.generated) for b in par.branches}) == 3
    for b in by_uid[6].branches:
        assert b.generated == by_uid[5].generated
    if spec is not None:
        plain = _port(setup).run(build(tserve), max_steps=400)
        assert _tokens([b for r in tdone for b in (r.branches or [r])]) == \
            _tokens([b for r in plain for b in (r.branches or [r])])


def test_fanout_truncation_and_tuple_uids_in_jsonl(setup, tmp_path):
    """A truncated run returns the parent once (truncated, not done) and
    leaves nothing in flight; a fan-out's events carry the branches'
    tuple uids through a JSONL tracker and back."""
    eng = _port(setup)
    par = tserve.Request(uid=9, prompt=np.arange(8), max_new_tokens=12, n=3)
    with pytest.warns(UserWarning, match="max_steps"):
        done = eng.run([par], max_steps=3)
    assert done == [par]
    assert par.truncated and not par.done and par.finish_reason is None
    assert eng.kv.pages_in_use() == 0 and not eng._inflight
    path = tmp_path / "fanout.jsonl"
    with tserve.JsonlTracker(str(path)) as tracker:
        eng.tracker = tracker
        par = tserve.Request(uid=9, prompt=np.arange(8), max_new_tokens=3,
                             n=2)
        assert eng.run([par])[0].finish_reason == "branches"
    uids = {tuple(r["data"]["uid"]) for r in tserve.read_jsonl(str(path))
            if r.get("kind") == "event" and r["name"] == "engine/finish"}
    assert uids == {(9, 0), (9, 1)}


# -- validation ---------------------------------------------------------------

def test_spec_validation(setup):
    eng = _port(setup)
    with pytest.raises(ValueError, match="n must be >= 1, got 0"):
        eng.run([tserve.Request(uid=0, prompt=np.arange(4), n=0)])
    with pytest.raises(KeyError, match="unknown adapter 'nope'"):
        eng.run([tserve.Request(
            uid=0, prompt=np.arange(4),
            spec=tserve.SpecConfig(k=2, draft_adapter="nope"))])
    eng = _port(setup, spec=tserve.SpecConfig(k=2, draft_adapter="nope"))
    with pytest.raises(KeyError, match="unknown adapter 'nope'"):
        eng.submit(tserve.Request(uid=0, prompt=np.arange(4)))
    # the k = 0 opt-out never names a draft adapter
    eng.submit(tserve.Request(uid=1, prompt=np.arange(4), max_new_tokens=2,
                              spec=tserve.SpecConfig(k=0)))
    assert eng.run_stream(max_steps=10)[0].done
