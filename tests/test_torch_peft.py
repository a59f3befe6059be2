"""The port's PEFT core against the reference package on shared inputs:
PSOFT init (compared through A·B and W_res: the SVD fixes column signs
arbitrarily), Cayley maps, merge, delta factors, LoRA, adapter banks
(low-rank and dense branches) and banked apply, all fp32; plus the bf16
round trip through interop."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny tensors: one intra-op thread, so the suite's parallel workers do not
# contend with idle-spinning thread pools
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import PEFTConfig as JPEFTConfig  # noqa: E402
from repro.core import cayley as jcayley, psoft as jpsoft  # noqa: E402
from repro.core import lora as jlora, peft as jpeft  # noqa: E402
from repro.core import registry as jregistry  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import PEFTConfig  # noqa: E402
from repro_torch.core import cayley, lora, peft, psoft, registry  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jit(fn, *static):
    """A reference function jitted (one compile instead of op-by-op)."""
    return jax.jit(fn, static_argnames=static)


def _port(tree):
    return interop.params_from_numpy(_np(tree), device="cpu")


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **(tol or TOL))


def _psoft_pair(rng, d_in=48, d_out=40, r=8, lead=()):
    """Reference PSOFT params with trainables moved off identity, and the
    same params in the port."""
    w = (rng.standard_normal(lead + (d_in, d_out)) * 0.1).astype(np.float32)
    def init(w):
        fn = lambda m: jpsoft.psoft_init(m, r, True, jnp.float32,  # noqa
                                         jnp.float32)
        for _ in lead:
            fn = jax.vmap(fn)
        return fn(w)
    p = jax.jit(init)(jnp.asarray(w))
    p = dict(p)
    p["q"] = p["q"] + jnp.asarray(
        rng.standard_normal(p["q"].shape) * 0.05, jnp.float32)
    p["alpha"] = p["alpha"] + jnp.asarray(
        rng.standard_normal(p["alpha"].shape) * 0.05, jnp.float32)
    p["beta"] = p["beta"] + jnp.asarray(
        rng.standard_normal(p["beta"].shape) * 0.05, jnp.float32)
    return w, p, _port(p)


@pytest.mark.parametrize("d_in,d_out,r", [(48, 40, 8), (32, 64, 16),
                                          (24, 24, 24)])
def test_psoft_init_matches_reference(d_in, d_out, r):
    rng = np.random.default_rng(d_in)
    w = (rng.standard_normal((d_in, d_out)) * 0.1).astype(np.float32)
    want = _jit(jpsoft.psoft_init, "rank", "relax_vectors", "param_dtype",
                "peft_dtype")(jnp.asarray(w), rank=r, relax_vectors=True,
                              param_dtype=jnp.float32,
                              peft_dtype=jnp.float32)
    got = psoft.psoft_init(torch.from_numpy(w), r, True, torch.float32,
                           torch.float32)
    assert set(got) == set(want)
    for k in ("q", "alpha", "beta"):
        _close(got[k], want[k])
    _close(got["A"] @ got["B"], want["A"] @ want["B"], atol=1e-5)
    _close(got["w_res"], want["w_res"], atol=1e-5)
    eye = torch.eye(got["A"].shape[1])
    _close(got["A"].T @ got["A"], eye, atol=1e-5)


def test_psoft_init_is_batched_over_layers():
    rng = np.random.default_rng(1)
    w = torch.from_numpy(
        (rng.standard_normal((3, 32, 24)) * 0.1).astype(np.float32))
    stacked = psoft.psoft_init(w, 6, True, torch.float32, torch.float32)
    for i in range(3):
        one = psoft.psoft_init(w[i], 6, True, torch.float32, torch.float32)
        torch.testing.assert_close(stacked["A"][i] @ stacked["B"][i],
                                   one["A"] @ one["B"], atol=1e-5, rtol=0)
        torch.testing.assert_close(stacked["w_res"][i], one["w_res"],
                                   atol=1e-5, rtol=0)


@pytest.mark.parametrize("r,terms", [(4, 1), (46, 8)])
def test_cayley_matches_reference(r, terms):
    rng = np.random.default_rng(r)
    q = (rng.standard_normal(cayley.num_skew_params(r)) * 0.03).astype(
        np.float32)
    tq = torch.from_numpy(q)
    jq = jnp.asarray(q)
    _close(cayley.skew_from_flat(tq, r),
           _jit(jcayley.skew_from_flat, "r")(jq, r=r), atol=0)
    _close(cayley.cayley_neumann(tq, r, terms),
           _jit(jcayley.cayley_neumann, "r", "terms")(jq, r=r, terms=terms))
    _close(cayley.cayley_exact(tq, r),
           _jit(jcayley.cayley_exact, "r")(jq, r=r))


def test_psoft_merge_apply_deviation_match_reference():
    rng = np.random.default_rng(2)
    _, jp, tp = _psoft_pair(rng)
    merge = _jit(jpsoft.psoft_merge, "neumann_terms", "exact")
    _close(psoft.psoft_merge(tp), merge(jp))
    _close(psoft.psoft_merge(tp, exact=True), merge(jp, exact=True))
    x = (rng.standard_normal((5, 48)) * 0.5).astype(np.float32)
    _close(psoft.psoft_apply(tp, torch.from_numpy(x),
                             compute_dtype=torch.float32),
           _jit(jpsoft.psoft_apply, "compute_dtype")(
               jp, jnp.asarray(x), compute_dtype=jnp.float32))
    _close(psoft.orthogonality_deviation(tp),
           _jit(jpsoft.orthogonality_deviation)(jp), atol=1e-5)


def test_delta_factors_match_reference():
    rng = np.random.default_rng(3)
    _, jp, tp = _psoft_pair(rng)
    cfg, jcfg = PEFTConfig(rank=8), JPEFTConfig(rank=8)
    jl, jr = jregistry.get_method("psoft").delta_factors(jp, jcfg)
    tl, tr = registry.get_method("psoft").delta_factors(tp, cfg)
    _close(tl, jl)
    _close(tr, jr)
    # merge == base_weight + left @ right, in both packages
    m = registry.get_method("psoft")
    _close(m.base_weight(tp, cfg) + tl @ tr, m.merge(tp, cfg).numpy())


def test_lora_merge_and_factors_match_reference():
    rng = np.random.default_rng(4)
    w = (rng.standard_normal((32, 24)) * 0.1).astype(np.float32)
    jp = jlora.lora_init(jax.random.PRNGKey(0), jnp.asarray(w), 8,
                         jnp.float32, jnp.float32)
    jp = dict(jp, b=jnp.asarray(rng.standard_normal((8, 24)) * 0.1,
                                jnp.float32))
    tp = _port(jp)
    cfg, jcfg = PEFTConfig(method="lora", rank=8), JPEFTConfig(
        method="lora", rank=8)
    scale = cfg.lora_alpha / cfg.rank
    _close(lora.lora_merge(tp, scale), jlora.lora_merge(jp, scale))
    x = (rng.standard_normal((3, 32))).astype(np.float32)
    _close(lora.lora_apply(tp, torch.from_numpy(x), scale, torch.float32),
           jlora.lora_apply(jp, jnp.asarray(x), scale, jnp.float32))
    jl, jr = jregistry.get_method("lora").delta_factors(jp, jcfg)
    tl, tr = registry.get_method("lora").delta_factors(tp, cfg)
    _close(tl, jl)
    _close(tr, jr)
    # the port's own init: zero update, Kaiming-scaled a, seeded generator
    g = torch.Generator().manual_seed(0)
    own = lora.lora_init(g, torch.from_numpy(w), 8, torch.float32,
                         torch.float32)
    assert torch.all(own["b"] == 0) and own["a"].shape == (32, 8)


def _bank_inputs(rng, lead=(2,)):
    """A merged base weight and (params, cfg, module) entries: the base
    adapter itself plus a PSOFT fine-tune of the same frozen factors."""
    _, jbase, tbase = _psoft_pair(rng, lead=lead)
    jbase = dict(jbase, q=jnp.zeros_like(jbase["q"]),
                 alpha=jnp.ones_like(jbase["alpha"]),
                 beta=jnp.ones_like(jbase["beta"]))
    tbase = _port(jbase)
    jtuned = dict(jbase, q=jbase["q"] + 0.05, alpha=jbase["alpha"] + 0.05,
                  beta=jbase["beta"] - 0.03)
    return jbase, tbase, jtuned, _port(jtuned)


def test_stack_deltas_low_rank_matches_reference():
    rng = np.random.default_rng(5)
    jbase, tbase, jtuned, ttuned = _bank_inputs(rng)
    cfg, jcfg = PEFTConfig(rank=8), JPEFTConfig(rank=8)
    jw = jax.jit(jax.vmap(jpsoft.psoft_merge))(jbase)
    tw = psoft.psoft_merge(tbase)
    _close(tw, jw)
    want = jregistry.stack_deltas(
        jw, [(jbase, jcfg, "q"), (jtuned, jcfg, "q")])
    got = registry.stack_deltas(tw, [(tbase, cfg, "q"), (ttuned, cfg, "q")])
    assert set(got) == set(want) == {"left", "right"}
    _close(got["left"], want["left"])
    _close(got["right"], want["right"])
    # every adapter at the base: no bank at all
    assert registry.stack_deltas(tw, [(tbase, cfg, "q")]) is None


def test_stack_deltas_dense_branch_matches_reference():
    """An adapter whose frozen base differs from the serving base falls back
    to an exact dense delta."""
    rng = np.random.default_rng(6)
    jbase, tbase, _, _ = _bank_inputs(rng)
    _, jother, tother = _psoft_pair(rng, lead=(2,))
    cfg, jcfg = PEFTConfig(rank=8), JPEFTConfig(rank=8)
    jw = jax.jit(jax.vmap(jpsoft.psoft_merge))(jbase)
    tw = psoft.psoft_merge(tbase)
    want = jregistry.stack_deltas(
        jw, [(jbase, jcfg, "q"), (jother, jcfg, "q")])
    got = registry.stack_deltas(tw, [(tbase, cfg, "q"), (tother, cfg, "q")])
    assert set(got) == set(want) == {"delta"}
    _close(got["delta"], want["delta"])


def test_apply_batched_matches_reference():
    """Banked linear: prefill-shaped rows through einsums, decode-shaped
    rows through the gather-delta wrapper."""
    rng = np.random.default_rng(7)
    jbase, tbase, jtuned, ttuned = _bank_inputs(rng, lead=())
    cfg, jcfg = PEFTConfig(rank=8), JPEFTConfig(rank=8)
    jw = jax.jit(jpsoft.psoft_merge)(jbase)
    tw = psoft.psoft_merge(tbase)
    jbank = jregistry.stack_deltas(jw, [(jbase, jcfg, "q"),
                                        (jtuned, jcfg, "q")])
    tbank = registry.stack_deltas(tw, [(tbase, cfg, "q"),
                                       (ttuned, cfg, "q")])
    ids = np.asarray([1, 0, 1], np.int32)
    for s in (4, 1):
        x = (rng.standard_normal((3, s, 48)) * 0.5).astype(np.float32)
        want = _jit(jregistry.apply_batched, "compute_dtype")(
            {"w": jw, "bank": jbank}, jnp.asarray(x),
            compute_dtype=jnp.float32, adapter_ids=jnp.asarray(ids))
        got = registry.apply_batched({"w": tw, "bank": tbank},
                                     torch.from_numpy(x), torch.float32,
                                     torch.from_numpy(ids))
        _close(got, want)
    assert registry.is_banked_linear({"w": tw, "bank": tbank})


def test_apply_batched_sends_every_low_rank_decode_to_the_wrapper(
        monkeypatch):
    """Decode-shaped rows on a low-rank bank always reach the gather-delta
    wrapper (which launches the kernel on a GPU); prefill-shaped rows, a
    dense bank and base-only rows do not."""
    calls = []
    real = registry.ops.gather_delta_matmul

    def spy(*args, **kw):
        calls.append(args[0].shape)
        return real(*args, **kw)
    monkeypatch.setattr(registry.ops, "gather_delta_matmul", spy)
    gen = torch.Generator().manual_seed(0)
    w = torch.randn((16, 12), generator=gen)
    low = {"left": torch.randn((2, 16, 4), generator=gen),
           "right": torch.randn((2, 4, 12), generator=gen)}
    dense = {"delta": torch.randn((2, 16, 12), generator=gen)}
    ids = torch.tensor([1, 0, 1], dtype=torch.int32)
    dec = torch.randn((3, 1, 16), generator=gen)
    pre = torch.randn((3, 5, 16), generator=gen)
    for bank, x, adapter_ids in ((dense, dec, ids), (low, pre, ids),
                                 (low, dec, None)):
        registry.apply_batched({"w": w, "bank": bank}, x, torch.float32,
                               adapter_ids)
    assert calls == []
    got = registry.apply_batched({"w": w, "bank": low}, dec, torch.float32,
                                 ids)
    assert calls == [(3, 16)]
    want = dec @ w + torch.einsum(
        "bsd,bdk,bko->bso", dec, low["left"][ids.long()],
        low["right"][ids.long()])
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


def test_apply_and_merge_tree_dispatch_match_reference():
    rng = np.random.default_rng(8)
    _, jp, tp = _psoft_pair(rng, lead=(2,))
    jtree = {"attn": {"q": jp}, "ln": {"scale": jnp.ones((2, 48))}}
    ttree = {"attn": {"q": tp}, "ln": {"scale": torch.ones((2, 48))}}
    cfg, jcfg = PEFTConfig(rank=8), JPEFTConfig(rank=8)
    want = jpeft.merge_tree(jtree, jcfg)
    got = peft.merge_tree(ttree, cfg)
    _close(got["attn"]["q"]["w"], want["attn"]["q"]["w"])
    x = (rng.standard_normal((5, 48))).astype(np.float32)
    one = jax.tree.map(lambda a: a[0], jp)
    _close(peft.apply_linear(_port(one),
                             torch.from_numpy(x), cfg, torch.float32,
                             module="q"),
           jpeft.apply_linear(one, jnp.asarray(x), jcfg, jnp.float32,
                              module="q"))
    w = torch.from_numpy(rng.standard_normal((16, 8)).astype(np.float32))
    plain = peft.init_linear(None, w, cfg, False, torch.float32,
                             torch.float32, module="q")
    assert set(plain) == {"w"}


def test_interop_bfloat16_round_trip():
    rng = np.random.default_rng(9)
    a = jnp.asarray(rng.standard_normal((3, 5)), jnp.bfloat16)
    tree = {"layers": {"w": np.asarray(a)}, "f": np.arange(4, dtype=np.int32)}
    t = interop.params_from_numpy(tree, device="cpu")
    assert t["layers"]["w"].dtype == torch.bfloat16
    _close(t["layers"]["w"].float(), np.asarray(a, np.float32), atol=0)
    back = interop.params_to_numpy(t, bf16_dtype=jnp.bfloat16)
    assert back["layers"]["w"].dtype == np.asarray(a).dtype
    np.testing.assert_array_equal(back["layers"]["w"].view(np.uint16),
                                  np.asarray(a).view(np.uint16))
    np.testing.assert_array_equal(back["f"], tree["f"])
    if not torch.cuda.is_available():
        # the default device is the card: no silent CPU fallback
        with pytest.raises(RuntimeError, match="cuda"):
            interop.params_from_numpy(tree)
