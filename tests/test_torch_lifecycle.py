"""The port's live adapter lifecycle against the reference's on ``tiny``
(fp32) with shared weights: the mixed-bank repair of ``apply_batched``,
the bank units (``extend_bank``, ``take_bank_columns``) bit for bit on the
same numpy inputs, and the reference's lifecycle scenarios run through both
engines (mid-run register against a static bank, update pinning the
in-flight request, unregister semantics and re-registration, a mid-run
failure that rolls back, a bad mutation before a run, version-qualified
alias keys, retirement and compaction) with identical outcomes
(:mod:`lifecycle_pairs`).  Also the port's build-count pin (its
counterpart of the reference's recompile pin) and its refusal to
re-register a live name.  The checkpoint feeds are in
``test_torch_feed.py``."""
import gc
import weakref

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny tensors: one intra-op thread, so the suite's parallel workers do not
# contend with idle-spinning thread pools
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import lifecycle_pairs as lp  # noqa: E402
import ssm_pairs as sp  # noqa: E402
import repro_torch.serve as tserve  # noqa: E402
from benchmarks.common import nudge_psoft  # noqa: E402
from repro.configs.base import PEFTConfig as JPEFTConfig  # noqa: E402
from repro.core import registry as jregistry  # noqa: E402
from repro_torch.configs.base import PEFTConfig  # noqa: E402
from repro_torch.core import registry  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _compiled_rotations():
    with sp.compiled_reference_rotations():
        yield


@pytest.fixture(scope="module")
def setup():
    return lp.make_sides()


# -- the mixed-bank repair of apply_batched ----------------------------------

@pytest.mark.parametrize("shape", ["decode", "prefill"])
def test_apply_batched_on_a_mixed_bank_matches_reference(shape):
    """A mixed bank (left/right/delta), built by hand from numpy: every
    column's output against the reference's ``apply_batched``, and a
    dense column's decode row keeps its delta term."""
    rng = np.random.default_rng(0)
    lead, a, d_in, d_out, r = 2, 3, 16, 12, 4
    w = rng.standard_normal((lead, d_in, d_out)).astype(np.float32)
    left = rng.standard_normal((lead, a, d_in, r)).astype(np.float32)
    right = 0.1 * rng.standard_normal((lead, a, r, d_out)).astype(np.float32)
    delta = 0.1 * rng.standard_normal((lead, a, d_in, d_out)).astype(
        np.float32)
    left[:, 1], right[:, 1] = 0, 0      # column 1 dense, columns 0, 2 not
    delta[:, [0, 2]] = 0
    s = 1 if shape == "decode" else 5
    x = rng.standard_normal((4, s, d_in)).astype(np.float32)
    ids = np.asarray([1, 0, 2, 1], np.int32)
    for layer in range(lead):
        bank = {"left": left[layer], "right": right[layer],
                "delta": delta[layer]}
        want = jregistry.apply_batched(
            {"w": jnp.asarray(w[layer]),
             "bank": {k: jnp.asarray(v) for k, v in bank.items()}},
            jnp.asarray(x), jnp.float32, jnp.asarray(ids))
        got = registry.apply_batched(
            {"w": torch.from_numpy(w[layer]),
             "bank": {k: torch.from_numpy(v) for k, v in bank.items()}},
            torch.from_numpy(x), torch.float32, torch.from_numpy(ids))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=1e-5, rtol=1e-5)
        dense = x[0] @ (w[layer] + delta[layer, 1])
        np.testing.assert_allclose(got[0].numpy(), dense, atol=1e-5,
                                   rtol=1e-5)


# -- bank units ---------------------------------------------------------------

_D_IN, _D_OUT = 32, 24


def _lora_pair(seed, rank):
    """One LoRA linear from numpy: the reference's and the port's params
    (a and b moved off init) and their PEFT configs."""
    rng = np.random.default_rng(seed)
    w = (0.2 * np.random.default_rng(99).standard_normal(
        (_D_IN, _D_OUT))).astype(np.float32)
    a = (0.1 * rng.standard_normal((_D_IN, rank))).astype(np.float32)
    b = (0.05 * rng.standard_normal((rank, _D_OUT))).astype(np.float32)
    p = {"w": w, "a": a, "b": b}
    return (w, {k: jnp.asarray(v) for k, v in p.items()},
            JPEFTConfig(method="lora", rank=rank),
            {k: torch.from_numpy(v) for k, v in p.items()},
            PEFTConfig(method="lora", rank=rank))


def _equal(got: dict, want: dict):
    assert set(got) == set(want)
    for k in want:
        g, w = got[k].numpy(), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        assert g.tobytes() == w.tobytes(), k


@pytest.mark.parametrize("ranks", [(8, 4), (4, 8), (8, 8)])
def test_extend_bank_bit_equal_to_reference(ranks):
    """Growing a bank one adapter at a time (rank growth zero-pads): the
    port's bank equals the reference's bit for bit, and equals stacking
    both adapters at once."""
    w, ja, jca, ta, tca = _lora_pair(1, ranks[0])
    _, jb, jcb, tb, tcb = _lora_pair(2, ranks[1])
    jw, tw = jnp.asarray(w), torch.from_numpy(w)
    want = jregistry.extend_bank(
        jw, jregistry.stack_deltas(jw, [(ja, jca, None)]),
        jregistry.stack_deltas(jw, [(jb, jcb, None)]), n_existing=1)
    got = registry.extend_bank(
        tw, registry.stack_deltas(tw, [(ta, tca, None)]),
        registry.stack_deltas(tw, [(tb, tcb, None)]), n_existing=1)
    _equal(got, want)
    full = registry.stack_deltas(tw, [(ta, tca, None), (tb, tcb, None)])
    for k in full:
        assert torch.equal(full[k], got[k])
    zeros = registry.extend_bank(tw, got, None, n_existing=2, n_new=1)
    _equal(zeros, jregistry.extend_bank(jw, want, None, n_existing=2,
                                        n_new=1))
    with pytest.raises(ValueError, match="n_new is required"):
        registry.extend_bank(tw, got, None, n_existing=2)


def test_extend_bank_mixed_dense_lowrank_bit_equal_to_reference():
    """A dense newcomer on a low-rank bank: a MIXED bank equal to the
    reference's bit for bit, whose old column's outputs are bit-equal to
    the pure bank's (decode and prefill shapes) and whose dense column is
    the direct delta product."""
    w, ja, jca, ta, tca = _lora_pair(3, 8)
    d = (0.01 * np.random.default_rng(7).standard_normal(
        (_D_IN, _D_OUT))).astype(np.float32)
    jw, tw = jnp.asarray(w), torch.from_numpy(w)
    jlr = jregistry.stack_deltas(jw, [(ja, jca, None)])
    tlr = registry.stack_deltas(tw, [(ta, tca, None)])
    want = jregistry.extend_bank(jw, jlr, {"delta": jnp.asarray(d)[None]},
                                 n_existing=1)
    got = registry.extend_bank(tw, tlr, {"delta": torch.from_numpy(d)[None]},
                               n_existing=1)
    _equal(got, want)
    rng = np.random.default_rng(8)
    for s in (1, 3):
        x = torch.from_numpy(rng.standard_normal((2, s, _D_IN)).astype(
            np.float32))
        zero, one = torch.zeros(2, dtype=torch.int32), \
            torch.ones(2, dtype=torch.int32)
        y0 = registry.apply_batched({"w": tw, "bank": got}, x,
                                    torch.float32, zero)
        pure = registry.apply_batched({"w": tw, "bank": tlr}, x,
                                      torch.float32, zero)
        assert torch.equal(y0, pure)
        y1 = registry.apply_batched({"w": tw, "bank": got}, x,
                                    torch.float32, one)
        torch.testing.assert_close(
            y1, x @ tw + torch.einsum("b...d,do->b...o", x,
                                      torch.from_numpy(d)),
            atol=1e-6, rtol=1e-6)


def test_take_bank_columns_bit_equal_to_reference():
    """Compaction's gather: kept columns bit-exact and equal to the
    reference's; a form whose kept columns are all zero is dropped."""
    w, ja, jca, ta, tca = _lora_pair(4, 8)
    d = (0.01 * np.random.default_rng(9).standard_normal(
        (_D_IN, _D_OUT))).astype(np.float32)
    jw, tw = jnp.asarray(w), torch.from_numpy(w)
    jmixed = jregistry.extend_bank(
        jw, jregistry.stack_deltas(jw, [(ja, jca, None)]),
        {"delta": jnp.asarray(d)[None]}, n_existing=1)
    tlr = registry.stack_deltas(tw, [(ta, tca, None)])
    tmixed = registry.extend_bank(tw, tlr,
                                  {"delta": torch.from_numpy(d)[None]},
                                  n_existing=1)
    for idx in ([0], [1], [0, 1], [1, 0]):
        got = registry.take_bank_columns(tmixed, idx)
        _equal(got, jregistry.take_bank_columns(jmixed, idx))
    assert set(registry.take_bank_columns(tmixed, [0])) == {"left", "right"}
    assert set(registry.take_bank_columns(tmixed, [1])) == {"delta"}
    assert registry.take_bank_columns(tmixed, []) is None
    assert registry.take_bank_columns(None, [0]) is None


# -- engine scenarios, reference against port ---------------------------------

def test_midrun_register_matches_reference_and_static_bank(setup):
    """A register landing mid-run: in-flight requests unperturbed (the
    port's live run equals its statically pre-registered bank), the
    late request serves the new adapter at once, the swap is on the
    tracker; everything identical to the reference."""
    ref = setup[0]
    ja, jb = nudge_psoft(ref.params, 0.05), nudge_psoft(ref.params, -0.07)

    def trace(side):
        v = side.cfg.vocab_size
        return [(1, side.request(0, lp.prompt(6, 0, v), 12)),
                (1, side.request(1, lp.prompt(6, 40, v), 12, "tuned_a",
                                 sampled=True))]

    def late(side):
        return side.request(2, lp.prompt(5, 80, side.cfg.vocab_size), 4,
                            "tuned_b")

    def live(side):
        eng = side.engine(tracker=side.tracker())
        eng.register_adapter("tuned_a", side.adapter(ja))
        eng.add_step_hook(lp.once_at(5, lambda e, s: (
            e.register_adapter("tuned_b", side.adapter(jb)),
            e.submit(late(side)))))
        return eng, eng.run_stream(trace(side), max_steps=128)

    eng, done = lp.both(setup, live)
    port = setup[1]
    static = port.engine()
    static.register_adapter("tuned_a", port.adapter(ja))
    static.register_adapter("tuned_b", port.adapter(jb))
    static.add_step_hook(lp.once_at(5, lambda e, s: e.submit(late(port))))
    assert lp.tokens(static.run_stream(trace(port), max_steps=128)) == \
        lp.tokens(done)
    assert ("register", "tuned_b") in [(e.op, e.name)
                                       for e in eng.lifecycle.events]
    assert eng.tracker.gauges["engine/bank/epoch"] == \
        eng.lifecycle.current.version > 0


def test_midrun_update_pins_inflight_matches_reference(setup):
    """update_adapter mid-run: the in-flight (sampled) request finishes on
    its admission weights, the later one serves the new version; both
    identical to the reference, and to the port's single-version
    engines."""
    ref, port = setup
    old, new = nudge_psoft(ref.params, 0.05), nudge_psoft(ref.params, 0.11)

    def inflight(side):
        return side.request(0, lp.prompt(6, 0, side.cfg.vocab_size), 12,
                            "tuned_a", sampled=True)

    def late(side):
        return side.request(1, lp.prompt(6, 0, side.cfg.vocab_size), 6,
                            "tuned_a")

    def live(side):
        eng = side.engine(tracker=side.tracker())
        eng.register_adapter("tuned_a", side.adapter(old))
        eng.add_step_hook(lp.once_at(5, lambda e, s: (
            e.update_adapter("tuned_a", side.adapter(new)),
            e.submit(late(side)))))
        return eng, eng.run_stream([(1, inflight(side))], max_steps=128)

    eng, done = lp.both(setup, live)
    got = {r.uid: r for r in done}
    assert all(r.done for r in done)
    ref_old = port.engine()
    ref_old.register_adapter("tuned_a", port.adapter(old))
    assert ref_old.run_stream([(1, inflight(port))], max_steps=128)[0] \
        .generated == got[0].generated
    ref_new = port.engine()
    ref_new.register_adapter("tuned_a", port.adapter(new))
    assert ref_new.run([late(port)], max_steps=128)[0].generated == \
        got[1].generated
    assert eng.lifecycle.version_of("tuned_a") == 1


def test_unregister_semantics_match_reference(setup):
    """unregister refuses while queued requests demand the name; with only
    active pins it proceeds and they finish on their epoch; the name is
    gone; re-registration gets a fresh content version."""
    ref, port = setup
    ja, jb = nudge_psoft(ref.params, 0.05), nudge_psoft(ref.params, 0.08)

    def scenario(side):
        v = side.cfg.vocab_size
        eng = side.engine(tracker=side.tracker())
        eng.register_adapter("tuned_a", side.adapter(ja))
        eng.submit(side.request(0, lp.prompt(5, 0, v), 3, "tuned_a"))
        with pytest.raises(ValueError, match="queued requests still demand"):
            eng.unregister_adapter("tuned_a")
        first = eng.run_stream(max_steps=64)
        eng.add_step_hook(lp.once_at(4, lambda e, s: (
            e.unregister_adapter("tuned_a"),
            e.submit(side.request(2, lp.prompt(5, 30, v), 3)))))
        done = eng.run_stream([(1, side.request(1, lp.prompt(6, 0, v), 10,
                                                "tuned_a"))], max_steps=128)
        assert "tuned_a" not in eng.list_adapters()
        with pytest.raises(KeyError, match="unknown adapter"):
            eng.submit(side.request(3, lp.prompt(4, 0, v), 4, "tuned_a"))
        with pytest.raises(KeyError, match="unknown adapter"):
            eng.unregister_adapter("tuned_a")
        with pytest.raises(KeyError, match="unknown adapter"):
            eng.update_adapter("tuned_a", side.adapter(jb))
        eng.register_adapter("tuned_a", side.adapter(jb))
        assert eng.lifecycle.version_of("tuned_a") == 1
        again = eng.run([side.request(4, lp.prompt(6, 0, v), 4, "tuned_a")],
                        max_steps=64)
        return eng, first + done + again

    eng, done = lp.both(setup, scenario)
    control = port.engine()
    control.register_adapter("tuned_a", port.adapter(ja))
    want = control.run_stream(
        [(1, port.request(1, lp.prompt(6, 0, port.cfg.vocab_size), 10,
                          "tuned_a"))], max_steps=128)
    assert lp.tokens(done)[1] == want[0].generated
    with pytest.raises(ValueError, match="cannot unregister the 'base'"):
        eng.unregister_adapter("base")


def _bad_norm(jparams):
    variant = jax.tree.map(lambda x: x, jparams)
    variant["final_norm"] = jax.tree.map(lambda x: x + 0.1,
                                         variant["final_norm"])
    return variant


def test_midrun_swap_failure_rolls_back_like_reference(setup):
    """A mid-run register whose extension fails (a non-linear param
    changed) rolls back: the in-flight request is unperturbed, the failure
    is a warning, a counter and a ``swap_failed`` event, and the engine
    serves on."""
    ref, port = setup
    bad = _bad_norm(ref.params)

    def scenario(side):
        v = side.cfg.vocab_size
        eng = side.engine(tracker=side.tracker())
        eng.add_step_hook(lp.once_at(4, lambda e, s: e.register_adapter(
            "bad_norm", side.adapter(bad))))
        with pytest.warns(UserWarning, match="rolled back"):
            done = eng.run_stream([(1, side.request(0, lp.prompt(6, 0, v),
                                                    10))], max_steps=128)
        assert "bad_norm" not in eng.list_adapters()
        errors = [e["error"] for e in
                  eng.tracker.events_named("engine/bank/swap_failed")]
        assert len(errors) == 1 and "non-linear" in errors[0]
        again = eng.run([side.request(9, lp.prompt(4, 0, v), 3)],
                        max_steps=64)
        return eng, done + again

    eng, done = lp.both(setup, scenario)
    plain = port.engine().run_stream(
        [(1, port.request(0, lp.prompt(6, 0, port.cfg.vocab_size), 10))],
        max_steps=128)
    assert lp.tokens(done)[0] == plain[0].generated
    assert [e.op for e in eng.lifecycle.events] == ["register_failed"]


def test_prerun_bad_mutation_raises_then_recovers_like_reference(setup):
    """Between runs a queued bad mutation raises at the next run's bank
    build (nothing is in flight), and the rollback leaves the engine
    serviceable."""
    ref = setup[0]
    bad = _bad_norm(ref.params)

    def scenario(side):
        v = side.cfg.vocab_size
        eng = side.engine(tracker=side.tracker())
        first = eng.run([side.request(0, lp.prompt(4, 0, v), 2)], max_steps=64)
        eng.register_adapter("bad_norm", side.adapter(bad))
        with pytest.raises(ValueError, match="non-linear"):
            eng.run([side.request(1, lp.prompt(4, 0, v), 2)], max_steps=64)
        assert "bad_norm" not in eng.list_adapters()
        done = eng.run([side.request(2, lp.prompt(4, 0, v), 2)], max_steps=64)
        assert done[0].done
        return eng, first + done

    lp.both(setup, scenario)


def test_kv_alias_keys_are_version_qualified_like_reference(setup):
    """An updated adapter's requests never alias the previous version's
    retained pages; same-version repeats alias.  kv stats are compared
    after every run."""
    ref, port = setup
    old, new = nudge_psoft(ref.params, 0.05), nudge_psoft(ref.params, 0.11)
    stats = {}

    def scenario(side):
        prompt = lp.prompt(36, 0, side.cfg.vocab_size)
        eng = side.engine(tracker=side.tracker())
        eng.register_adapter("tuned_a", side.adapter(old))
        out = eng.run([side.request(0, prompt, 3, "tuned_a")], max_steps=64)
        hits = [eng.kv.stats["prefix_hits"]]
        eng.update_adapter("tuned_a", side.adapter(new))
        out += eng.run([side.request(1, prompt, 3, "tuned_a")], max_steps=64)
        hits.append(eng.kv.stats["prefix_hits"])
        out += eng.run([side.request(2, prompt, 3, "tuned_a")], max_steps=64)
        hits.append(eng.kv.stats["prefix_hits"])
        stats[side.is_port] = hits
        assert side.is_port or eng._kv_key(out[-1]) == "tuned_a#1"
        return eng, out

    eng, done = lp.both(setup, scenario)
    assert stats[True] == stats[False]
    assert stats[True][1] == 0 and stats[True][2] >= 1
    fresh = port.engine()
    fresh.register_adapter("tuned_a", port.adapter(new))
    want = fresh.run([port.request(1, lp.prompt(36, 0, port.cfg.vocab_size),
                                   3, "tuned_a")], max_steps=64)
    assert lp.tokens(done)[1] == lp.tokens(done)[2] == want[0].generated
    assert eng._kv_key(done[2]) == "tuned_a#1"


def test_retirement_and_compaction_like_reference(setup):
    """Unregistering retires the epoch once its pins drain; compaction
    gathers the dead column out (bank bytes, equal on both sides, fall)
    and the survivor serves bit-identically; a second compaction finds
    nothing."""
    ref = setup[0]
    ja, jb = nudge_psoft(ref.params, 0.05), nudge_psoft(ref.params, -0.07)
    sizes = {}

    def scenario(side):
        v = side.cfg.vocab_size
        eng = side.engine(tracker=side.tracker())
        eng.register_adapter("tuned_a", side.adapter(ja))
        eng.register_adapter("tuned_b", side.adapter(jb))
        first = eng.run([side.request(0, lp.prompt(5, 0, v), 4, "tuned_a"),
                         side.request(1, lp.prompt(5, 40, v), 4, "tuned_b")],
                        max_steps=64)
        full = eng.lifecycle.bank_bytes()
        eng.unregister_adapter("tuned_b")
        solo = eng.run([side.request(4, lp.prompt(5, 0, v), 4, "tuned_a")],
                       max_steps=64)
        reclaimed = eng.compact_banks()
        after = eng.run([side.request(5, lp.prompt(5, 0, v), 4, "tuned_a")],
                        max_steps=64)
        sizes[side.is_port] = (full, eng.lifecycle.bank_bytes(), reclaimed,
                               eng.compact_banks())
        return eng, first + solo + after

    eng, done = lp.both(setup, scenario)
    full, compacted, reclaimed, again = sizes[True]
    assert sizes[True] == sizes[False]
    assert reclaimed >= 1 and again == 0 and 0 < compacted < full
    toks = lp.tokens(done)
    assert toks[0] == toks[4] == toks[5]
    ops = [e.op for e in eng.lifecycle.events]
    assert "retire" in ops and "compact" in ops


def test_reregister_live_name_raises(setup):
    """The port has no deprecation shim: re-registering a live name
    raises and points to update_adapter, which serves the new weights
    with an explicit version bump (the reference test's outcome); the
    'base' name is never re-registerable."""
    ref, port = setup
    old, new = nudge_psoft(ref.params, 0.05), nudge_psoft(ref.params, 0.11)
    eng = port.engine()
    eng.register_adapter("tuned_a", port.adapter(old))
    with pytest.raises(ValueError, match="update_adapter"):
        eng.register_adapter("tuned_a", port.adapter(new))
    assert eng.lifecycle.version_of("tuned_a") == 0
    eng.update_adapter("tuned_a", port.adapter(new))
    assert eng.lifecycle.version_of("tuned_a") == 1
    prompt = lp.prompt(6, 0, port.cfg.vocab_size)
    got = eng.run([port.request(0, prompt, 5, "tuned_a")], max_steps=64)
    fresh = port.engine()
    fresh.register_adapter("tuned_a", port.adapter(new))
    assert got[0].generated == fresh.run(
        [port.request(0, prompt, 5, "tuned_a")], max_steps=64)[0].generated
    for op in (eng.register_adapter, eng.update_adapter):
        with pytest.raises(ValueError, match="'base' adapter"):
            op("base", port.params)


def test_build_count_pin(setup, monkeypatch):
    """The port's counterpart of the reference's recompile pin: one engine
    does exactly one full build; each applied register or update one
    extension walk that materializes one column; an unregister or a
    compaction none; and every stack_deltas call after the first build
    holds exactly one adapter (no existing column is rebuilt)."""
    ref, port = setup
    ja, jb = nudge_psoft(ref.params, 0.05), nudge_psoft(ref.params, -0.07)
    v = port.cfg.vocab_size
    eng = port.engine()
    eng.register_adapter("tuned_a", port.adapter(ja))
    eng.run([port.request(0, lp.prompt(6, 0, v), 6, "tuned_a")], max_steps=64)
    lc = eng.lifecycle
    assert (lc.full_builds, lc.extend_walks, lc.columns_built) == (1, 0, 2)
    widths = []
    stack = registry.stack_deltas

    def spy(base_w, adapters, **kw):
        widths.append(len(adapters))
        return stack(base_w, adapters, **kw)
    monkeypatch.setattr(registry, "stack_deltas", spy)
    eng.add_step_hook(lp.once_at(3, lambda e, s: (
        e.register_adapter("tuned_b", port.adapter(jb)),
        e.update_adapter("tuned_a", port.adapter(jb)),
        e.submit(port.request(2, lp.prompt(6, 80, v), 4, "tuned_b")))))
    eng.add_step_hook(lp.once_at(6, lambda e, s: e.unregister_adapter(
        "tuned_b")))
    done = eng.run_stream([(1, port.request(1, lp.prompt(6, 0, v), 12,
                                            "tuned_a"))], max_steps=128)
    assert all(r.done for r in done)
    assert widths and set(widths) == {1}
    assert (lc.full_builds, lc.extend_walks, lc.columns_built) == (1, 2, 4)
    assert eng.compact_banks() >= 1
    assert (lc.full_builds, lc.extend_walks, lc.columns_built) == (1, 2, 4)
    assert [e.op for e in lc.events if e.op not in ("retire", "compact")
            ][-3:] == ["register", "update", "unregister"]


def test_swapped_engine_frees_without_the_cycle_collector(setup, tmp_path):
    """After mid-run swaps, an unregister and compaction, dropping the
    engine frees it, its lifecycle and its bank by reference counting
    alone: the lifecycle and the feed hold the engine weakly, and no
    recursive closure ties the lifecycle to a garbage cycle."""
    ref, port = setup
    v = port.cfg.vocab_size
    gc.collect()
    gc.disable()
    try:
        eng = port.engine()
        eng.register_adapter("tuned_a", port.adapter(
            nudge_psoft(ref.params, 0.05)))
        tserve.AdapterFeed(eng, str(tmp_path), "live", None).attach()
        eng.add_step_hook(lp.once_at(2, lambda e, s: (
            e.update_adapter("tuned_a", port.adapter(
                nudge_psoft(ref.params, 0.11))),
            e.register_adapter("tuned_b", port.adapter(
                nudge_psoft(ref.params, -0.07))))))
        eng.add_step_hook(lp.once_at(4, lambda e, s: e.unregister_adapter(
            "tuned_b")))
        done = eng.run_stream([(1, port.request(0, lp.prompt(6, 0, v), 8,
                                                "tuned_a"))], max_steps=64)
        assert done[0].done and eng.compact_banks() >= 1
        refs = [weakref.ref(x) for x in (
            eng, eng.lifecycle,
            eng._tree["layers"]["attn"]["q"]["bank"]["right"])]
        del eng, done
        assert [r() is None for r in refs] == [True] * 3
    finally:
        gc.enable()
