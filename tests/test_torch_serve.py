"""The port's ServeEngine.run() against the reference engine on ``tiny``
(fp32) with the base model and one PSOFT adapter, shared-prefix prompts:
identical greedy tokens, identical admission events, prefix hits, every
page returned; the same with an OFT and a DoRA adapter, which serve through
the dense-delta bank; and a dropped engine is freed without Python's cycle
collector."""
import gc
import weakref
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny tensors: one intra-op thread, so the suite's parallel workers do not
# contend with idle-spinning thread pools
torch.set_num_threads(1)

import jax  # noqa: E402

from benchmarks.common import nudge_psoft  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.core import peft as jpeft  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.serve import Request as JRequest  # noqa: E402
from repro.serve import ServeEngine as JServeEngine  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.serve import Request, ServeEngine  # noqa: E402
import ssm_pairs as sp  # noqa: E402

#: a tight pool (10 usable pages): admissions wait for frees in FIFO order
#: and retained prefix pages get evicted
ENGINE = dict(max_len=64, slots=3, page_size=8, num_pages=11)


@pytest.fixture(scope="module", autouse=True)
def _compiled_rotations():
    with sp.compiled_reference_rotations():
        yield


def _workload(vocab):
    """(uid, prompt, max_new_tokens, adapter): four prompts share a
    20-token system prompt (two full pages of 8), two per adapter, so later
    admissions alias pages of earlier ones; uid 0 finishes early, so uid 3
    refills its slot while others are mid-decode."""
    rng = np.random.default_rng(0)
    system = rng.integers(0, vocab, 20).astype(np.int32)
    out = []
    for uid, (shared, adapter) in enumerate([
            (True, "base"), (False, "tuned"), (True, "tuned"),
            (False, "base"), (True, "base"), (True, "tuned")]):
        user = rng.integers(0, vocab, 4).astype(np.int32)
        prompt = np.concatenate([system, user]) if shared else user
        out.append((uid, prompt, 3 if uid == 0 else 4, adapter))
    return out


def _summary(engine, done):
    toks = {r.uid: list(r.generated) for r in done}
    events = [(e.step, e.slot, e.uid, e.adapter, e.prefix_tokens)
              for e in engine.admission_events]
    return toks, events


#: the dense-delta bank's adapters: method -> noise seed
DENSE_ADAPTERS = {"oft": 1, "dora": 2}


def _compiled_reference_fns(cfg):
    """The reference's jitted init of ``tiny`` and, per dense-bank
    adapter, its re-wrap of the merged base and its merge (one compile
    each, instead of op-by-op eager calls), traced in turn and compiled
    together on a thread pool (XLA compiles without holding the
    interpreter lock)."""
    key = jax.random.PRNGKey(0)

    def init(k):
        return jmodel.init_params(k, cfg)
    lowered = {"init": jax.jit(init).lower(key)}
    shapes = jax.eval_shape(init, key)
    for method in DENSE_ADAPTERS:
        pc = cfg.peft.replace(method=method)

        def rewrap(p, pc=pc):
            return jmodel.rewrap_peft(jpeft.merge_tree(p, cfg.peft),
                                      cfg.replace(peft=pc))

        def merge(t, pc=pc):
            return jpeft.merge_tree(t, pc)
        lowered[("rewrap", method)] = jax.jit(rewrap).lower(shapes)
        lowered[("merge", method)] = jax.jit(merge).lower(
            jax.eval_shape(rewrap, shapes))
    with ThreadPoolExecutor(len(lowered)) as pool:
        jobs = {k: pool.submit(lo.compile) for k, lo in lowered.items()}
        return {k: job.result() for k, job in jobs.items()}


@pytest.fixture(scope="module")
def reference():
    cfg = jget_config("tiny")
    fns = _compiled_reference_fns(cfg)
    params = fns["init"](jax.random.PRNGKey(0))
    tuned = nudge_psoft(params, 0.05)
    eng = JServeEngine(params, cfg, **ENGINE)
    eng.register_adapter("tuned", tuned, cfg.peft)
    done = eng.run([JRequest(uid=u, prompt=p, max_new_tokens=n, adapter=a)
                    for u, p, n, a in _workload(cfg.vocab_size)],
                   max_steps=128)
    assert all(r.done for r in done)
    to_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    return to_np(params), to_np(tuned), _summary(eng, done), \
        dict(eng.kv.stats), fns


def test_port_engine_matches_reference(reference):
    params, tuned, (want_toks, want_events), want_stats, _ = reference
    cfg = get_config("tiny")
    eng = ServeEngine(interop.params_from_numpy(params, device="cpu"), cfg,
                      device="cpu", **ENGINE)
    eng.register_adapter("tuned", interop.params_from_numpy(tuned, "cpu"))
    assert eng.list_adapters() == ["base", "tuned"]
    reqs = [Request(uid=u, prompt=p, max_new_tokens=n, adapter=a)
            for u, p, n, a in _workload(cfg.vocab_size)]
    done = eng.run(reqs, max_steps=128)
    toks, events = _summary(eng, done)
    assert toks == want_toks
    assert events == want_events
    assert all(r.done and len(r.generated) == r.max_new_tokens
               for r in done)
    assert eng.kv.stats["prefix_hits"] > 0
    assert eng.kv.stats["evictions"] > 0
    assert eng.kv.stats == {k: want_stats[k] for k in eng.kv.stats}
    assert eng.kv.pages_in_use() == 0


def test_port_engine_rejects_unknown_adapter_and_long_prompt(reference):
    params = reference[0]
    cfg = get_config("tiny")
    eng = ServeEngine(interop.params_from_numpy(params, device="cpu"), cfg,
                      device="cpu", **ENGINE)
    with pytest.raises(KeyError, match="unknown adapter"):
        eng.run([Request(uid=0, prompt=np.arange(4, dtype=np.int32),
                         adapter="missing")])
    with pytest.raises(ValueError, match="prompt length"):
        eng.run([Request(uid=0, prompt=np.zeros(64, np.int32))])


def _rewrapped(fns, jparams, jcfg, method):
    """An adapter of the base model trained with ``method``: the merged base
    re-wrapped by the reference, every trainable moved off init by seeded
    numpy noise (so both engines see the same values)."""
    jp = jcfg.peft.replace(method=method)
    tree = fns[("rewrap", method)](jparams)
    names = set(jpeft.trainable_names(method, jp))
    rng = np.random.default_rng(DENSE_ADAPTERS[method])

    def rec(node):
        if isinstance(node, dict):
            return {k: rec(v) if isinstance(v, dict) else (
                v + rng.standard_normal(v.shape).astype(v.dtype) * 0.05
                if k in names else v) for k, v in node.items()}
        return node
    return rec(jax.tree.map(np.asarray, tree)), jp


def test_dense_bank_adapters_match_reference(reference):
    """Base, OFT and DoRA adapters (the dense-delta bank) in one run: the
    port's tokens and admissions equal the reference engine's.  The port
    serves the OFT and DoRA trees as trained; the reference engine serves
    each as its merged tree (``merge_tree`` vmaps the merge over the layer
    stack), because its bank builder merges a layer-stacked adapter without
    vmap, where OFT's structure matcher takes the stacked ``q`` for BOFT's
    and DoRA's column norm runs over the layer axis."""
    params, fns = reference[0], reference[4]
    jcfg = jget_config("tiny")
    adapters = {m: _rewrapped(fns, params, jcfg, m) for m in DENSE_ADAPTERS}
    workload = [(u, p, n, "base" if a == "base" else ("oft", "dora")[u % 2])
                for u, p, n, a in _workload(jcfg.vocab_size)]
    eng = JServeEngine(params, jcfg, **ENGINE)
    for name, (tree, pc) in adapters.items():
        merged = fns[("merge", name)](tree)
        eng.register_adapter(name, jax.tree.map(np.asarray, merged),
                             pc.replace(method="none", target_modules=()))
    done = eng.run([JRequest(uid=u, prompt=p, max_new_tokens=n, adapter=a)
                    for u, p, n, a in workload], max_steps=128)
    want_toks, want_events = _summary(eng, done)

    cfg = get_config("tiny")
    port = ServeEngine(interop.params_from_numpy(params, device="cpu"), cfg,
                       device="cpu", **ENGINE)
    for name, (tree, pc) in adapters.items():
        port.register_adapter(name, interop.params_from_numpy(tree, "cpu"),
                              cfg.peft.replace(method=name))
    done = port.run([Request(uid=u, prompt=p, max_new_tokens=n, adapter=a)
                     for u, p, n, a in workload], max_steps=128)
    toks, events = _summary(port, done)
    assert toks == want_toks
    assert events == want_events
    bank = port._tree["layers"]["attn"]["q"]["bank"]
    assert set(bank) == {"delta"} and bank["delta"].shape[1] == 3
    assert {a for *_, a in workload} == {"base", "oft", "dora"}
    assert port.kv.pages_in_use() == 0


def test_dropped_engine_is_freed_without_the_cycle_collector(reference):
    """Nothing the engine builds refers back to it: with the collector off,
    the last reference going frees the engine, its KV pools and its bank."""
    params, tuned = reference[0], reference[1]
    cfg = get_config("tiny")
    gc.collect()
    gc.disable()
    try:
        eng = ServeEngine(interop.params_from_numpy(params, device="cpu"),
                          cfg, device="cpu", **ENGINE)
        eng.register_adapter("tuned", interop.params_from_numpy(tuned,
                                                                "cpu"))
        done = eng.run([Request(uid=0, prompt=np.arange(6, dtype=np.int32),
                                max_new_tokens=3, adapter="tuned")])
        assert done[0].done and "bank" in eng._tree["layers"]["mlp"]["up"]
        pools = weakref.ref(eng.kv.pools["k"])
        alive = weakref.ref(eng)
        del eng, done
        assert alive() is None
        assert pools() is None
    finally:
        gc.enable()
