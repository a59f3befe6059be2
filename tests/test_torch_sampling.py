"""The port's sampler against the reference's on the CPU: threefry keys
and random bits equal JAX's exactly (``jax_threefry_partitionable``), the
Gumbel noise within 2 ulp, ``sample_tokens`` gives identical tokens and
top ids with logprobs within 1e-5 over a per-row mix of greedy, top-k,
top-p and logprobs rows, ``support_mask`` is identical away from the
nucleus boundary, planted ties resolve to the lower id, the all-greedy
shortcut changes nothing, and seeds and validation errors are the
reference's."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny tensors: one intra-op thread, so the suite's parallel workers do not
# contend with idle-spinning thread pools
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.serve import sampling as R  # noqa: E402
from repro_torch.serve import sampling as S  # noqa: E402

SEEDS = (0, 1, 2 ** 31, 2 ** 32 - 1)
COUNTERS = np.arange(301)
LOGPROB_TOL = 1e-5
#: the exclusive nucleus mass agrees with XLA's within this (an ulp of the
#: log-sum-exp, ~2e-6 at |lse| ~ 20, scales every probability); a
#: candidate whose mass lies closer than this to top_p may fall either side
MASS_TOL = 1e-5


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("seed", SEEDS)
def test_threefry_keys_and_bits_equal_jax(seed):
    keys = jax.vmap(lambda c: jax.random.key_data(jax.random.fold_in(
        jax.random.PRNGKey(np.uint32(seed)), c)))(jnp.asarray(COUNTERS))
    bits = jax.vmap(lambda c: jax.random.bits(jax.random.fold_in(
        jax.random.PRNGKey(np.uint32(seed)), c), (S.MAX_CANDIDATES,)))(
        jnp.asarray(COUNTERS))
    k1, k2 = S.fold_in(torch.full((len(COUNTERS),), seed), _t(COUNTERS))
    np.testing.assert_array_equal(np.stack([k1.numpy(), k2.numpy()], 1),
                                  np.asarray(keys).astype(np.int64))
    np.testing.assert_array_equal(S.random_bits(k1, k2, S.MAX_CANDIDATES)
                                  .numpy(),
                                  np.asarray(bits).astype(np.int64))


def test_gumbel_within_two_ulp_of_jax():
    """The uniform draw is exact; each ``log`` is within 1 ulp of XLA's,
    so the noise is within 2 ulp of ``max(|g|, 1)`` (near g = 0 the outer
    log magnifies the inner one's last bit)."""
    seeds = np.arange(64) * 2654435761 % 2 ** 32
    counters = np.arange(64) * 7
    keys = [jax.random.fold_in(jax.random.PRNGKey(np.uint32(s)), int(c))
            for s, c in zip(seeds, counters)]
    want_u = np.stack([np.asarray(jax.random.uniform(
        k, (S.MAX_CANDIDATES,), minval=np.finfo(np.float32).tiny,
        maxval=1.0)) for k in keys])
    want_g = np.stack([np.asarray(jax.random.gumbel(
        k, (S.MAX_CANDIDATES,))) for k in keys])
    k1, k2 = S.fold_in(_t(seeds.astype(np.int64)), _t(counters))
    u = S.uniform_from_bits(S.random_bits(k1, k2, S.MAX_CANDIDATES))
    np.testing.assert_array_equal(u.numpy(), want_u)
    got = S.gumbel(k1, k2, S.MAX_CANDIDATES).numpy()
    ulp = np.spacing(np.maximum(np.abs(want_g), 1.0).astype(np.float32))
    assert np.all(np.abs(got - want_g) <= 2 * ulp)


def _rows(rng, b, v):
    """A per-row mix: greedy rows, top-k only, top-p only, both, neither,
    with random seeds and counters."""
    logits = rng.normal(0, rng.uniform(1, 5), (b, v)).astype(np.float32)
    temps = rng.uniform(0.3, 1.5, b).astype(np.float32)
    temps[:3] = 0.0
    ks = rng.integers(1, min(v, S.MAX_CANDIDATES) + 1, b).astype(np.int32)
    ks[3:7] = 0
    ps = rng.uniform(0.3, 1.0, b).astype(np.float32)
    ps[7:11] = 1.0
    seeds = rng.integers(0, 2 ** 32, b, dtype=np.uint64).astype(np.uint32)
    counters = rng.integers(0, 600, b).astype(np.int32)
    return logits, temps, ks, ps, seeds, counters


def _port(logits, temps, ks, ps, seeds, counters, **kw):
    return S.sample_tokens(_t(logits), _t(temps), _t(ks), _t(ps),
                           _t(seeds.astype(np.int64)),
                           _t(counters.astype(np.int64)), **kw)


@pytest.mark.parametrize("v", [1024, 100])
def test_sample_tokens_match_reference(v):
    rng = np.random.default_rng(v)
    for _ in range(4):
        args = _rows(rng, 16, v)
        want = R.sample_tokens(*args, want_logprobs=True)
        got = S.to_host(*_port(*args, want_logprobs=True))
        np.testing.assert_array_equal(got[0], np.asarray(want[0]))
        np.testing.assert_array_equal(got[2], np.asarray(want[2]))
        np.testing.assert_allclose(got[1], np.asarray(want[1]), rtol=0,
                                   atol=LOGPROB_TOL)
        np.testing.assert_allclose(got[3], np.asarray(want[3]), rtol=0,
                                   atol=LOGPROB_TOL)
        toks, none, _, _ = _port(*args, want_logprobs=False)
        assert none is None
        np.testing.assert_array_equal(toks.numpy(), got[0])


def test_all_greedy_shortcut_changes_nothing():
    rng = np.random.default_rng(3)
    logits, _, ks, ps, seeds, counters = _rows(rng, 8, 1024)
    temps = np.zeros(8, np.float32)
    want = R.sample_tokens(logits, temps, ks, ps, seeds, counters,
                           want_logprobs=True)
    full = S.to_host(*_port(logits, temps, ks, ps, seeds, counters,
                            want_logprobs=True))
    short = S.sample_tokens(_t(logits), None, None, None, None, None,
                            want_logprobs=True, greedy_only=True)
    short = S.to_host(*short)
    for got in (full, short):
        np.testing.assert_array_equal(got[0], np.asarray(want[0]))
        np.testing.assert_array_equal(got[0], logits.argmax(-1))
        np.testing.assert_array_equal(got[2], np.asarray(want[2]))
        np.testing.assert_allclose(got[3], np.asarray(want[3]), rtol=0,
                                   atol=LOGPROB_TOL)


def _reference_mass(z, c):
    """The reference's exclusive nucleus mass over its candidates."""
    cand, _ = jax.lax.top_k(jnp.asarray(z), c)
    probs = jnp.exp(cand - jax.nn.logsumexp(jnp.asarray(z), axis=-1,
                                            keepdims=True))
    return np.asarray(jnp.cumsum(probs, axis=-1) - probs)


@pytest.mark.parametrize("v", [1024, 100])
def test_support_mask_matches_reference(v):
    """Identical masks wherever the exclusive mass is clear of top_p by
    MASS_TOL.  At ``top_p = 1`` the mass of the last candidates rounds to
    1 or just below depending on the order of the sum: those candidates
    carry less than MASS_TOL of the probability together, and they are the
    only ones exempted."""
    rng = np.random.default_rng(17 + v)
    for _ in range(4):
        logits, temps, ks, ps, _, _ = _rows(rng, 16, v)
        want = np.asarray(R.support_mask(logits, temps, ks, ps))
        got = S.support_mask(_t(logits), _t(temps), _t(ks), _t(ps)).numpy()
        safe_t = np.where(temps > 0, temps, 1.0).astype(np.float32)
        z = logits / safe_t[:, None]
        c = min(S.MAX_CANDIDATES, v)
        mass = _reference_mass(z, c)
        idx = S._top_ids(_t(z), c)
        cand = _t(z).gather(-1, idx)
        probs = torch.exp(cand - torch.logsumexp(_t(z), -1, keepdim=True))
        ours = (S._prefix_sums(probs) - probs).numpy()
        np.testing.assert_allclose(ours, mass, rtol=0, atol=MASS_TOL)
        order = idx.numpy()
        for row in range(len(z)):
            near = np.abs(mass[row] - ps[row]) < MASS_TOL
            assert ps[row] == 1.0 or not near.any(), \
                "a boundary case below top_p = 1"
            clear = order[row][~near]
            np.testing.assert_array_equal(got[row][clear], want[row][clear])
            # tokens outside the candidate set are never in the support
            outside = np.setdiff1d(np.arange(v), order[row])
            assert not got[row][outside].any()


def test_ties_resolve_to_the_lower_id():
    z = np.zeros((3, 300), np.float32)
    z[0, [7, 3, 250]] = 5.0                     # argmax / top-1 tie
    z[1, 10:300] = 1.0                          # 290-way tie at the cap
    z[2, [0, 1]] = -0.0                         # signed zeros
    ones, full = np.ones(3, np.float32), np.ones(3, np.float32)
    for k in (1, 2, 64, 128):
        top_k = np.full(3, k, np.int32)
        want = np.asarray(R.support_mask(z, ones, top_k, full))
        got = S.support_mask(_t(z), _t(ones), _t(top_k), _t(full)).numpy()
        np.testing.assert_array_equal(got, want)
    assert S.support_mask(_t(z[:1]), _t(ones[:1]), torch.tensor([1]),
                          _t(full[:1]))[0].nonzero().tolist() == [[3]]
    want = R.sample_tokens(z, np.zeros(3, np.float32), np.zeros(3, np.int32),
                           full, np.zeros(3, np.uint32),
                           np.zeros(3, np.int32), want_logprobs=True)
    got = S.to_host(*_port(z, np.zeros(3, np.float32), np.zeros(3, np.int32),
                           full, np.zeros(3, np.uint32),
                           np.zeros(3, np.int32), want_logprobs=True))
    np.testing.assert_array_equal(got[0], np.asarray(want[0]))
    np.testing.assert_array_equal(got[2], np.asarray(want[2]))


def test_seeds_and_rows_equal_the_reference():
    for base, uid in ((0, 0), (0, 7), (12345, 3), (2 ** 40 + 5, 2 ** 33)):
        assert S.derive_seed(base, uid) == R.derive_seed(base, uid)
    for seed in SEEDS:
        for branch in (0, 1, 5, 2 ** 31):
            assert S.branch_seed(seed, branch) == R.branch_seed(seed, branch)
    entries = [(S.SamplingParams(temperature=0.7, top_k=5, top_p=0.9), 42,
                3), (S.SamplingParams.greedy(), 2 ** 32 - 1, 0)]
    jentries = [(R.SamplingParams(temperature=0.7, top_k=5, top_p=0.9), 42,
                 3), (R.SamplingParams.greedy(), 2 ** 32 - 1, 0)]
    for got, want in zip(S.stack(entries), R.stack(jentries)):
        np.testing.assert_array_equal(got, want.astype(got.dtype))


def test_validation_errors_equal_the_reference():
    assert (S.MAX_CANDIDATES, S.MAX_LOGPROBS) == \
        (R.MAX_CANDIDATES, R.MAX_LOGPROBS)
    for bad in (dict(temperature=-0.5), dict(temperature=float("nan")),
                dict(top_k=-1), dict(top_k=S.MAX_CANDIDATES + 1),
                dict(top_p=0.0), dict(top_p=1.5), dict(seed=-1),
                dict(seed=2 ** 32), dict(logprobs=S.MAX_LOGPROBS + 1),
                dict(logprobs=-1), dict(stop_token_ids=(1024,))):
        with pytest.raises(ValueError) as got:
            S.SamplingParams(**bad).validate(1024)
        with pytest.raises(ValueError) as want:
            R.SamplingParams(**bad).validate(1024)
        assert str(got.value) == str(want.value)
    assert S.SamplingParams(stop_token_ids=[3, 4]).stop_token_ids == (3, 4)
    assert S.SamplingParams.greedy().is_greedy


def test_record_occupancy_counts_live_and_ghost_rows():
    from repro_torch.obs import InMemoryTracker
    tr = InMemoryTracker()
    S.record_occupancy(tr, [object(), None, object(), None], step=1)
    assert tr.counter("sampler/live_rows") == 2
    assert tr.counter("sampler/ghost_rows") == 2
    assert tr.values("sampler/batch_occupancy") == [0.5]
