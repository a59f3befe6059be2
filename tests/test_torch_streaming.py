"""The port's streaming engine against the reference's ``run_stream`` on
``tiny`` (fp32) with shared weights: mid-run arrivals, lookahead past an
infeasible head, priority preemption in a tight pool and resume
re-aliasing, decode-time page pressure, chunked prefill at random chunk
sizes (mid-page chunk boundaries) and under a step budget, mid-prefill
preemption, and stop tokens, logprobs and seeded sampling under preemption
and shuffled admission.  Each run gives identical tokens, finish reasons,
request stamps, admission and preemption events and kv stats, and
logprobs within 1e-4.  Then the allocator's own units: suspend/resume
round trip, a shared pin, the eviction order, the feasibility probes and
seeded refcount conservation, in lockstep with the reference allocator."""
import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny tensors: one intra-op thread, so the suite's parallel workers do not
# contend with idle-spinning thread pools
torch.set_num_threads(1)

import jax  # noqa: E402

import repro.serve as jserve  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.serve import kv_cache as jkv  # noqa: E402
import repro_torch.serve as tserve  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.serve import kv_cache as tkv  # noqa: E402
import ssm_pairs as sp  # noqa: E402

#: slots of 56 tokens in pages of 8: a tight pool (6 usable pages) where
#: admission waits and decode preempts, and a roomy one (12)
TIGHT, ROOMY = 7, 13
ENGINE = dict(max_len=56, slots=2, page_size=8)
LOGPROB_TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _compiled_rotations():
    with sp.compiled_reference_rotations():
        yield


@pytest.fixture(scope="module")
def setup():
    """Reference params and the port's copy, and one reference engine per
    pool size: each run swaps in a fresh allocator (the jitted functions
    take the pools as arguments, so nothing recompiles)."""
    jcfg = jget_config("tiny")
    params = jax.jit(lambda k: jmodel.init_params(k, jcfg))(
        jax.random.PRNGKey(0))
    tparams = interop.params_from_numpy(jax.tree.map(np.asarray, params),
                                        device="cpu")
    engines = {n: jserve.ServeEngine(params, jcfg, num_pages=n, **ENGINE)
               for n in (TIGHT, ROOMY)}
    return jcfg, tparams, engines


def _reference(setup, num_pages, chunk=None, cost_model=None):
    jcfg, _, engines = setup
    eng = engines[num_pages]
    eng.kv = jkv.PagedKVCache(eng.cfg, ENGINE["slots"], ENGINE["max_len"],
                              page_size=ENGINE["page_size"],
                              num_pages=num_pages)
    eng.kv.set_tracker(eng.tracker)
    eng.admission_events, eng.preemption_events = [], []
    eng.prefill_chunk_tokens = chunk
    eng.cost_model = eng.scheduler.cost_model = (
        cost_model if cost_model is not None else jserve.TokenCostModel())
    return eng


def _port(setup, num_pages, chunk=None, cost_model=None):
    cm = None if cost_model is None else tserve.TokenCostModel(
        **{f.name: getattr(cost_model, f.name)
           for f in dataclasses.fields(tserve.TokenCostModel)})
    return tserve.ServeEngine(setup[1], get_config("tiny"), device="cpu",
                              num_pages=num_pages, prefill_chunk_tokens=chunk,
                              cost_model=cm, **ENGINE)


def _summary(eng, done):
    return dict(
        tokens={r.uid: list(r.generated) for r in done},
        stamps={r.uid: (r.done, r.truncated, r.finish_reason, r.admit_step,
                        r.finish_step, r.preemptions, r.slo_met)
                for r in done},
        admissions=[dataclasses.astuple(e) for e in eng.admission_events],
        preemptions=[dataclasses.astuple(e)
                     for e in eng.preemption_events],
        kv=dict(eng.kv.stats))


def _logprobs(done):
    return {r.uid: [(lp.token, lp.logprob, lp.top_tokens, lp.top_logprobs)
                    for lp in r.logprobs] for r in done}


def _assert_logprobs_close(got, want):
    assert got.keys() == want.keys()
    for uid in want:
        assert len(got[uid]) == len(want[uid])
        for (t, lp, tt, tl), (wt, wlp, wtt, wtl) in zip(got[uid], want[uid]):
            assert (t, tt) == (wt, wtt)
            assert abs(lp - wlp) <= LOGPROB_TOL
            assert np.allclose(tl, wtl, rtol=0, atol=LOGPROB_TOL)


def _both(setup, workload, num_pages, run="stream", chunk=None,
          cost_model=None, **kw):
    """Serve ``workload(ns)`` on the reference and on the port (``ns`` is
    the package whose Request / SamplingParams it builds); assert
    identical outcomes and return the port's engine and requests."""
    out = []
    for ns, make in ((jserve, _reference), (tserve, _port)):
        eng = make(setup, num_pages, chunk, cost_model)
        work = workload(ns)
        if run == "stream":
            done = eng.run_stream(work, max_steps=400, **kw)
        else:
            done = eng.run(work, max_steps=400)
        assert all(r.done for r in done), [(r.uid, r.done) for r in done]
        assert eng.kv.pages_in_use() == 0, "run leaked pages"
        out.append((eng, done))
    (jeng, jdone), (teng, tdone) = out
    assert _summary(teng, tdone) == _summary(jeng, jdone)
    _assert_logprobs_close(_logprobs(tdone), _logprobs(jdone))
    return teng, {r.uid: r for r in tdone}


# -- workloads (built from either package) -----------------------------------

def _pressure(vocab, sampled=False):
    """One big low-priority request, then small high-priority deadlined
    ones: the head-of-line / preemption scenario."""
    def build(ns):
        def sp(seed, **kw):
            return ns.SamplingParams(temperature=0.9, top_k=64, top_p=0.95,
                                     seed=seed, **kw) if sampled else None
        big = ns.Request(uid=0, prompt=(np.arange(24, dtype=np.int32) * 3
                                        + 1) % vocab,
                         max_new_tokens=20, priority=0,
                         sampling=sp(1000, logprobs=3))
        smalls = [ns.Request(uid=1 + i,
                             prompt=(np.arange(6, dtype=np.int32) + 11 * i)
                             % vocab, max_new_tokens=4, priority=1,
                             deadline=12.0, sampling=sp(2000 + i))
                  for i in range(4)]
        return [(1, big)] + [(3 + 2 * i, r) for i, r in enumerate(smalls)]
    return build


def _chunk_requests(vocab, seed=7, n=4):
    def build(ns):
        rng = np.random.default_rng(seed)
        out = []
        for i in range(n):
            plen = int(rng.integers(3, 30))
            out.append((1 + 2 * i, ns.Request(
                uid=i, prompt=rng.integers(0, vocab, size=plen,
                                           dtype=np.int32),
                max_new_tokens=int(rng.integers(2, 8)))))
        return out
    return build


# -- streaming arrivals and lookahead ----------------------------------------

def test_midrun_arrivals_match_reference(setup):
    vocab = setup[0].vocab_size

    def build(ns):
        rng = np.random.default_rng(5)
        reqs = [ns.Request(uid=i, prompt=rng.integers(0, vocab, size=5,
                                                      dtype=np.int32),
                           max_new_tokens=4) for i in range(4)]
        return [(1, reqs[0]), (4, reqs[1]), (4, reqs[2]), (9, reqs[3])]

    _, by_uid = _both(setup, build, ROOMY)
    for step, r in build(types.SimpleNamespace(Request=tserve.Request)):
        assert by_uid[r.uid].admit_step >= step
    assert by_uid[3].admit_step == 9


def test_lookahead_past_infeasible_head_matches_reference(setup):
    vocab = setup[0].vocab_size

    def build(ns):
        occupant = ns.Request(uid=0, prompt=np.arange(20, dtype=np.int32),
                              max_new_tokens=12)
        big = ns.Request(uid=1, prompt=(np.arange(30, dtype=np.int32) + 40)
                         % vocab, max_new_tokens=14)
        small = ns.Request(uid=2, prompt=(np.arange(5, dtype=np.int32) + 90)
                           % vocab, max_new_tokens=3)
        return [(1, occupant), (2, big), (3, small)]

    _, fifo = _both(setup, build, TIGHT, lookahead=0, preempt=False)
    _, ahead = _both(setup, build, TIGHT, lookahead=4, preempt=False)
    assert fifo[2].queueing_delay > 5
    assert ahead[2].admit_step == 3 and ahead[2].queueing_delay == 0
    assert {u: r.generated for u, r in fifo.items()} == \
        {u: r.generated for u, r in ahead.items()}


# -- preemption ---------------------------------------------------------------

def test_priority_preemption_and_resume_realiasing(setup):
    vocab = setup[0].vocab_size
    eng, by_uid = _both(setup, _pressure(vocab), TIGHT)
    assert eng.last_run_preemptions >= 1 and by_uid[0].preemptions >= 1
    assert all(by_uid[u].slo_met for u in (1, 2, 3, 4))
    st = eng.kv.stats
    assert st["suspends"] == st["resumes"] == eng.last_run_preemptions
    # every resume re-aliased the suspended sequence's retained full pages
    assert st["prefix_hits"] >= st["resumes"]
    assert any(e.resumed and e.prefix_tokens >= eng.kv.page_size
               for e in eng.admission_events)
    assert not eng.kv._pins
    # suspend/resume changes no token: the FIFO run gives the same output
    _, fifo = _both(setup, _pressure(vocab), TIGHT, lookahead=0,
                    preempt=False)
    assert {u: r.generated for u, r in fifo.items()} == \
        {u: r.generated for u, r in by_uid.items()}


def test_decode_pressure_suspends_lowest_priority(setup):
    vocab = setup[0].vocab_size

    def build(ns):
        lo = ns.Request(uid=0, prompt=np.arange(20, dtype=np.int32),
                        max_new_tokens=24, priority=0)
        hi = ns.Request(uid=1, prompt=(np.arange(20, dtype=np.int32) + 60)
                        % vocab, max_new_tokens=24, priority=1)
        return [(1, lo), (1, hi)]

    eng, by_uid = _both(setup, build, TIGHT)
    assert eng.last_run_preemptions >= 1
    assert by_uid[0].preemptions >= 1 and by_uid[1].preemptions == 0


# -- chunked prefill ------------------------------------------------------------

def test_chunked_prefill_random_chunks_match_reference(setup):
    """Chunk sizes drawn at random, so chunk boundaries fall mid-page (the
    prefill kernel's prefix is not page-aligned): each run equals the
    reference's and the one-shot run's tokens."""
    vocab = setup[0].vocab_size
    _, base = _both(setup, _chunk_requests(vocab), ROOMY)
    rng = np.random.default_rng(11)
    chunks = sorted(set(int(c) for c in rng.integers(1, 8, size=3)))
    assert any(c % ENGINE["page_size"] for c in chunks)
    for chunk in chunks:
        eng, got = _both(setup, _chunk_requests(vocab), ROOMY, chunk=chunk)
        assert {u: r.generated for u, r in got.items()} == \
            {u: r.generated for u, r in base.items()}, chunk


def test_budgeted_chunked_prefill_matches_reference(setup):
    vocab = setup[0].vocab_size
    cm = jserve.TokenCostModel(decode_step_cost=1.0, prefill_token_cost=0.1,
                               step_budget=2.0)
    eng, got = _both(setup, _chunk_requests(vocab), ROOMY, chunk=8,
                     cost_model=cm)
    costs = [c for c, _ in eng.last_run_step_costs]
    assert costs and max(costs) <= 2.0 + 2 * 0.8 + 1.0 + 1e-9


def test_midprefill_preemption_matches_reference(setup):
    vocab = setup[0].vocab_size

    def build(ns):
        big = ns.Request(uid=0, prompt=(np.arange(40, dtype=np.int32) * 3
                                        + 1) % vocab,
                         max_new_tokens=6, priority=0)
        smalls = [ns.Request(uid=1 + i,
                             prompt=(np.arange(14, dtype=np.int32) + 11 * i)
                             % vocab, max_new_tokens=3, priority=1,
                             deadline=12.0) for i in range(3)]
        return [(1, big)] + [(2 + 3 * i, r) for i, r in enumerate(smalls)]

    eng, got = _both(setup, build, TIGHT, chunk=4)
    assert [e for e in eng.preemption_events
            if e.uid == 0 and e.resident_tokens < 40], \
        "no mid-prefill suspension"
    resumed = [e for e in eng.admission_events if e.uid == 0 and e.resumed]
    assert resumed and resumed[0].prefix_tokens >= eng.kv.page_size
    _, base = _both(setup, build, TIGHT)
    assert {u: r.generated for u, r in got.items()} == \
        {u: r.generated for u, r in base.items()}


# -- sampling under the scheduler ---------------------------------------------

def test_sampled_stop_and_logprobs_under_preemption(setup):
    """Seeded sampled rows with logprobs under preemption equal the
    reference's; a stop id ends its row with ``"stop"``; and the FIFO run
    without preemption draws the same tokens (counter-based RNG)."""
    vocab = setup[0].vocab_size
    eng, got = _both(setup, _pressure(vocab, sampled=True), TIGHT)
    assert eng.last_run_preemptions >= 1
    assert len(got[0].logprobs) == len(got[0].generated) == 20
    _, fifo = _both(setup, _pressure(vocab, sampled=True), TIGHT,
                    lookahead=0, preempt=False)
    assert {u: r.generated for u, r in fifo.items()} == \
        {u: r.generated for u, r in got.items()}
    # stop at the first token of uid 0's draw that did not occur earlier
    toks = got[0].generated
    k = next(i for i in range(2, 20) if toks[i] not in toks[:i])
    build = _pressure(vocab, sampled=True)

    def stopping(ns):
        work = build(ns)
        big = work[0][1]
        big.sampling = dataclasses.replace(big.sampling,
                                           stop_token_ids=(toks[k],))
        return work

    _, stopped = _both(setup, stopping, TIGHT)
    assert stopped[0].finish_reason == "stop"
    assert stopped[0].generated == toks[:k + 1]
    # a stop id drawn as the prefill's first token finishes at admission
    k = 0
    _, stopped = _both(setup, stopping, TIGHT)
    assert stopped[0].generated == toks[:1]
    assert stopped[0].finish_step == stopped[0].admit_step


def test_sampled_shuffled_admission_matches_reference(setup):
    """Submission order changes slots and co-batching, not any request's
    draws; a twin of (seed, prompt, params) draws identically."""
    vocab = setup[0].vocab_size

    def build(order):
        def work(ns):
            reqs = [ns.Request(uid=u, prompt=(np.arange(6, dtype=np.int32)
                                              * 3 + 7 * u + 1) % vocab,
                               max_new_tokens=5,
                               sampling=ns.SamplingParams(
                                   temperature=0.8, top_k=32, seed=500 + u,
                                   logprobs=2 if u % 2 else 0))
                    for u in range(5)]
            reqs.append(ns.Request(uid=99, prompt=reqs[0].prompt.copy(),
                                   max_new_tokens=5,
                                   sampling=reqs[0].sampling))
            return [reqs[i] for i in order]
        return work

    _, fwd = _both(setup, build(range(6)), ROOMY, run="run")
    _, rev = _both(setup, build([3, 5, 1, 4, 0, 2]), ROOMY, run="run")
    assert {u: r.generated for u, r in fwd.items()} == \
        {u: r.generated for u, r in rev.items()}
    assert fwd[0].generated == fwd[99].generated


def test_truncated_run_matches_reference(setup):
    """A run cut by ``max_steps`` returns every request, the unfinished ones
    ``truncated`` with their partial output, frees every page and pin, and
    warns once per engine."""
    import warnings
    vocab = setup[0].vocab_size
    out = []
    for ns, make in ((jserve, _reference), (tserve, _port)):
        eng = make(setup, TIGHT)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            done = eng.run_stream(_pressure(vocab, sampled=True)(ns),
                                  max_steps=12)
            again = eng.run_stream(_pressure(vocab)(ns), max_steps=12)
        assert eng.last_run_truncated and not eng.kv._pins
        assert eng.kv.pages_in_use() == 0
        out.append(([(r.uid, r.done, r.truncated, list(r.generated))
                     for r in done + again],
                    sum("max_steps" in str(w.message) for w in caught)))
    assert out[1] == out[0]
    assert any(t for _, _, t, _ in out[1][0])


# -- scheduler policy and cost model -----------------------------------------

def test_scheduler_policy_and_cost_model_match_reference():
    """Candidate order (priority, slack, resumed-first, FIFO), the risk
    margin, the lookahead window, and the cost model's validation
    messages and calibrated clock, against the reference's."""
    orders = []
    for ns in (jserve, tserve):
        sched = ns.StreamScheduler(lookahead=8, preempt=True)
        reqs = [ns.Request(uid=0, prompt=np.arange(4), priority=0),
                ns.Request(uid=1, prompt=np.arange(4), priority=2),
                ns.Request(uid=2, prompt=np.arange(4), priority=1,
                           deadline=8.0, max_new_tokens=4),
                ns.Request(uid=3, prompt=np.arange(4), priority=1,
                           deadline=40.0, max_new_tokens=4)]
        for r in reqs:
            sched.push(r)
        sched.remove(reqs[0])
        sched.push_resume(reqs[0])
        seen = [[r.uid for r, _ in sched.window(now)] for now in (1, 3)]
        seen.append([sched.at_risk(reqs[2], now) for now in (0, 1, 2, 3)])
        seen.append([sched.slack(r, 2.0) for r in reqs])
        sched.configure(lookahead=1, preempt=True)
        seen.append([(r.uid, res) for r, res in sched.window(1.0)])
        seen.append(sorted(sched.demanded_adapters()))
        seen.append([r.uid for r in sched.drain()])
        orders.append(seen)
    assert orders[1] == orders[0]
    assert orders[1][0] == [1, 2, 3, 0]
    for bad, match in ((dict(decode_step_cost=0), "decode_step_cost"),
                       (dict(prefill_token_cost=-1), "prefill"),
                       (dict(step_budget=0), "step_budget")):
        with pytest.raises(ValueError, match=match) as got:
            tserve.TokenCostModel(**bad)
        with pytest.raises(ValueError) as want:
            jserve.TokenCostModel(**bad)
        assert str(got.value) == str(want.value)
    cm = tserve.TokenCostModel.calibrate(decode_step_s=2e-3,
                                         prefill_token_s=1e-4,
                                         step_budget_s=4e-3)
    assert cm.steps_to_cost(3) == pytest.approx(6e-3)
    assert cm.prefill_cost(10) == pytest.approx(1e-3)
    assert cm.step_budget == pytest.approx(4e-3)


# -- allocator units (in lockstep with the reference allocator) -------------

def _kv_pair(setup, **kw):
    return (jkv.PagedKVCache(setup[0], **kw),
            tkv.PagedKVCache(get_config("tiny"), device="cpu", **kw))


def _same_state(j, t):
    assert (j.tables == t.tables).all() and (j.refcount == t.refcount).all()
    assert j._free == t._free and list(j._reusable) == list(t._reusable)
    assert j._pins == t._pins and j.stats == t.stats


def test_kv_suspend_resume_roundtrip(setup):
    for kv in _kv_pair(setup, slots=2, max_len=32, page_size=8, num_pages=8):
        seq = np.arange(19, dtype=np.int32)           # 3 pages, 2 full
        kv.admit(0, seq, "base")
        kv.commit_prompt(0, seq, "base")
        row0 = [int(p) for p in kv.tables[0, :3]]
        pin = kv.suspend_slot(0, seq, "base", priority=1)
        assert kv.pages_in_use() == 0 and kv.pages_resident() == 2
        assert (kv.tables[0] == tkv.TRASH_PAGE).all() and pin in kv._pins
        assert kv.resume_slot(1, seq, "base", pin=pin) == 16
        assert [int(p) for p in kv.tables[1, :2]] == row0[:2]
        assert kv.stats["pages_aliased"] == 2 and pin not in kv._pins
        kv.free_slot(1)
        assert kv.pages_in_use() == 0


def test_kv_shared_pin_survives_one_dependents_resume(setup):
    j, t = _kv_pair(setup, slots=2, max_len=32, page_size=8, num_pages=9)
    for kv in (j, t):
        a = np.arange(19, dtype=np.int32)
        b = np.concatenate([np.arange(16, dtype=np.int32),
                            np.arange(5, dtype=np.int32) + 70])
        kv.admit(0, a, "x")
        kv.commit_prompt(0, a, "x")
        pin_a = kv.suspend_slot(0, a, "x", priority=3)
        assert kv.admit(0, b, "x") == 16
        kv.commit_prompt(0, b, "x")
        pin_b = kv.suspend_slot(0, b, "x", priority=3)
        kv.resume_slot(1, a, "x", pin=pin_a)
        kv.free_slot(1)
        assert len([p for p in kv._reusable
                    if kv._evict_key(p)[0] == 3]) >= 2
        kv.release_pin(pin_b)
        assert all(kv._evict_key(p)[0] == 0 for p in kv._reusable)
    _same_state(j, t)


def test_kv_eviction_order(setup):
    """Tail of a suspended chain before its head, and unpinned retained
    pages before a suspended high-priority request's."""
    j, t = _kv_pair(setup, slots=2, max_len=40, page_size=8, num_pages=6)
    for kv in (j, t):
        seq = np.arange(33, dtype=np.int32)           # 5 pages, 4 full
        kv.admit(0, seq, "x")
        kv.commit_prompt(0, seq, "x")
        chain = [int(p) for p in kv.tables[0, :4]]
        pin = kv.suspend_slot(0, seq, "x", priority=1)
        kv.admit(1, np.arange(9, dtype=np.int32) + 100, "y")
        assert kv.stats["evictions"] == 1 and chain[3] not in kv._reusable
        kv.free_slot(1)
        assert kv.resume_slot(0, seq, "x", pin=pin) == 24
        kv.free_slot(0)
    _same_state(j, t)
    j, t = _kv_pair(setup, slots=2, max_len=32, page_size=8, num_pages=7)
    for kv in (j, t):
        hi = np.arange(17, dtype=np.int32)
        kv.admit(0, hi, "hi")
        kv.commit_prompt(0, hi, "hi")
        kv.suspend_slot(0, hi, "hi", priority=5)
        hi_pages = set(kv._page_to_hash) & set(kv._reusable)
        lo = np.arange(16, dtype=np.int32) + 100
        kv.admit(0, lo, "lo")
        kv.commit_prompt(0, lo, "lo")
        kv.free_slot(0)
        kv.admit(1, np.arange(29, dtype=np.int32) + 200, "other")
        assert kv.stats["evictions"] == 2
        assert hi_pages <= set(kv._reusable) | set(
            p for p in range(kv.num_pages) if kv.refcount[p] > 0)
        kv.free_slot(1)
        assert kv.resume_slot(0, hi, "hi") == 16
    _same_state(j, t)


def test_kv_alias_probe_and_exclusive_pages(setup):
    j, t = _kv_pair(setup, slots=2, max_len=32, page_size=8, num_pages=8)
    for kv in (j, t):
        seq = np.arange(19, dtype=np.int32)
        kv.admit(0, seq, "x")
        kv.commit_prompt(0, seq, "x")
        before = kv.pages_resident()
        assert kv.alias_probe(seq, "x") == 2 and kv.alias_probe(seq, "y") == 0
        assert kv.pages_resident() == before
        assert kv.exclusive_pages(0) == 3
        kv.admit(1, seq, "x")
        assert kv.exclusive_pages(0) == 1 and kv.exclusive_pages(1) == 1
        assert kv.allocatable_pages() == len(kv._free)
        assert kv.prefix_hit_ratio() == 0.5
    _same_state(j, t)


def test_kv_out_of_pages_carries_pool_pressure(setup):
    tr = tserve.InMemoryTracker()
    kv = tkv.PagedKVCache(get_config("tiny"), slots=2, max_len=16,
                          page_size=8, num_pages=2, device="cpu")
    kv.set_tracker(tr)
    kv.admit(0, np.arange(5, dtype=np.int32), "base")
    with pytest.raises(tkv.OutOfPages, match="resident") as ei:
        kv.admit(1, np.arange(12, dtype=np.int32), "base")
    assert ei.value.referenced == 1 and ei.value.retained == 0
    assert tr.counter("kv/out_of_pages") == 1
    assert tr.gauges["kv/oom_referenced"] == 1


def _check_conservation(kv):
    free, retained = set(kv._free), set(kv._reusable)
    referenced = {p for p in range(1, kv.num_pages) if kv.refcount[p] > 0}
    assert not free & retained and not referenced & (free | retained)
    assert free | retained | referenced == set(range(1, kv.num_pages))
    owners = {}
    for owned in kv._owned:
        for p in owned:
            owners[p] = owners.get(p, 0) + 1
    for p in range(1, kv.num_pages):
        assert int(kv.refcount[p]) == owners.get(p, 0)
    assert kv.conservation()["conserved"] == 1


@pytest.mark.parametrize("seed", range(6))
def test_kv_refcount_conservation_seeded(setup, seed):
    """A random admit / suspend / resume / grow / free schedule on both
    allocators: conservation after every operation and identical state."""
    rng = np.random.default_rng(seed)
    j, t = _kv_pair(setup, slots=3, max_len=32, page_size=8,
                    num_pages=int(rng.integers(5, 11)))
    live, suspended = {}, []
    cap = t.pages_per_slot * t.page_size

    def both(fn):
        outcome = []
        for kv in (j, t):
            try:
                outcome.append(fn(kv))
            except (jkv.OutOfPages, tkv.OutOfPages, ValueError) as e:
                outcome.append(type(e).__name__ if not isinstance(
                    e, (jkv.OutOfPages, tkv.OutOfPages)) else "oom")
        assert outcome[0] == outcome[1]
        return outcome[1]

    for _ in range(120):
        op = int(rng.integers(0, 5))
        free_slots = [s for s in range(t.slots) if s not in live]
        if op == 0 and free_slots:
            seq = rng.integers(0, 40, size=int(rng.integers(1, cap + 1))
                               ).astype(np.int32)
            if both(lambda kv: kv.admit(free_slots[0], seq, "a")) \
                    not in ("oom", "ValueError"):
                both(lambda kv: kv.commit_prompt(free_slots[0], seq, "a"))
                live[free_slots[0]] = seq
        elif op == 1 and free_slots and suspended:
            seq, pin = suspended.pop()
            if both(lambda kv: kv.resume_slot(free_slots[0], seq, "a",
                                              pin=pin)) == "oom":
                suspended.append((seq, pin))
            else:
                live[free_slots[0]] = seq
        elif op == 2 and live:
            slot = int(rng.choice(list(live)))
            prio = int(rng.integers(0, 3))
            pin = both(lambda kv: kv.suspend_slot(slot, live[slot], "a",
                                                  priority=prio))
            suspended.append((live.pop(slot), pin))
        elif op == 3 and live:
            slot = int(rng.choice(list(live)))
            pos = min(len(live[slot]) + int(rng.integers(0, 9)), cap - 1)
            both(lambda kv: kv.ensure_position(slot, pos))
        elif op == 4 and live:
            slot = int(rng.choice(list(live)))
            both(lambda kv: kv.free_slot(slot))
            live.pop(slot)
        _check_conservation(t)
        _same_state(j, t)
    for slot in list(live):
        both(lambda kv: kv.free_slot(slot))
    for _seq, pin in suspended:
        both(lambda kv: kv.release_pin(pin))
    _check_conservation(t)
    _same_state(j, t)
    assert t.pages_in_use() == 0 and not t._pins
