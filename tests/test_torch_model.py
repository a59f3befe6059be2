"""The port's dense decoder against the reference package on converted
``tiny`` params (PSOFT-wrapped, trainables moved off identity): paged
prefill and per-slot decode logits and KV pools, with and without an
aliased prefix (page-aligned and mid-page), fp32, atol/rtol 1e-4."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny tensors: one intra-op thread, so the suite's parallel workers do not
# contend with idle-spinning thread pools
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from benchmarks.common import nudge_psoft  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import model  # noqa: E402

TOL = dict(atol=1e-4, rtol=1e-4)
PG, MAXP, PAGES = 8, 6, 32


@pytest.fixture(scope="module")
def pair():
    jcfg = jget_config("tiny")
    # jitted: one compile instead of op-by-op eager init
    jp = jax.jit(lambda k: jmodel.init_params(k, jcfg))(
        jax.random.PRNGKey(0))
    jp = nudge_psoft(jp, 0.05)
    tp = interop.params_from_numpy(jax.tree.map(np.asarray, jp),
                                   device="cpu")
    # the reference entry points, jitted (one compile per shape)
    jfns = {"prefill": jax.jit(lambda p, b, c, ln, pre: jmodel.paged_prefill(
                p, b, c, jcfg, ln, pre)),
            "decode": jax.jit(lambda p, b, c, pos: jmodel.decode_step(
                p, b, c, pos, jcfg))}
    return jcfg, jp, get_config("tiny"), tp, jfns


def _tables(rows):
    t = np.zeros((len(rows), MAXP), np.int32)
    for i, r in enumerate(rows):
        t[i, :len(r)] = r
    return t


def _prefill(pair, jpools, tpools, toks, lengths, prefix, table, n_pref):
    jcfg, jp, cfg, tp, jfns = pair
    jl, jnew = jfns["prefill"](
        jp, {"tokens": jnp.asarray(toks)},
        {**jpools, "page_table": jnp.asarray(table),
         "prefix_table": jnp.asarray(table[:, :n_pref])},
        jnp.asarray(lengths), jnp.asarray(prefix))
    tl, _ = model.paged_prefill(
        tp, {"tokens": torch.from_numpy(toks)},
        {**tpools, "page_table": torch.from_numpy(table),
         "prefix_table": torch.from_numpy(table[:, :n_pref])},
        cfg, torch.from_numpy(lengths), torch.from_numpy(prefix))
    return jl, jnew, tl


def _decode(pair, jpools, tpools, toks, pos, table):
    jcfg, jp, cfg, tp, jfns = pair
    jl, jnew = jfns["decode"](
        jp, {"tokens": jnp.asarray(toks)},
        {**jpools, "page_table": jnp.asarray(table)}, jnp.asarray(pos))
    tl, _ = model.decode_step(
        tp, {"tokens": torch.from_numpy(toks)},
        {**tpools, "page_table": torch.from_numpy(table)},
        torch.from_numpy(pos), cfg)
    return jl, {"k": jnew["k"], "v": jnew["v"]}, tl


def _assert_pools(jpools, tpools):
    for k in ("k", "v"):
        np.testing.assert_allclose(tpools[k].numpy(), np.asarray(jpools[k]),
                                   **TOL)


def test_init_params_layout_matches_reference(pair):
    """The port's own seeded init builds the reference's tree: same keys,
    shapes and dtypes, so either tree converts 1:1."""
    jcfg, jp, cfg, tp, _ = pair
    own = model.init_params(cfg, seed=0, device="cpu")
    jshapes = jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), jp)
    tshapes = jax.tree.map(
        lambda t: (tuple(t.shape), str(t.dtype).replace("torch.", "")), own)
    assert tshapes == jshapes
    again = model.init_params(cfg, seed=0, device="cpu")
    torch.testing.assert_close(own["embed"]["w"], again["embed"]["w"])
    torch.testing.assert_close(own["layers"]["mlp"]["up"]["A"]
                               @ own["layers"]["mlp"]["up"]["B"],
                               again["layers"]["mlp"]["up"]["A"]
                               @ again["layers"]["mlp"]["up"]["B"])


def test_prefill_and_decode_match_reference(pair):
    jcfg, _, cfg, _, _ = pair
    rng = np.random.default_rng(0)
    jpools = jmodel.init_cache(jcfg, 2, MAXP * PG, page_size=PG,
                               num_pages=PAGES)
    tpools = model.init_cache(cfg, 2, MAXP * PG, page_size=PG,
                              num_pages=PAGES, device="cpu")
    toks = rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    lengths = np.asarray([13, 16], np.int32)
    table = _tables([[1, 2, 3], [5, 4, 6]])
    jl, jpools, tl = _prefill(pair, jpools, tpools, toks, lengths,
                              np.zeros(2, np.int32), table, 0)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _assert_pools(jpools, tpools)
    # two decode steps at per-slot positions
    pos = lengths.copy()
    for _ in range(2):
        nxt = np.asarray(jl)[:, -1, :cfg.vocab_size].argmax(-1)
        jl, jpools, tl = _decode(pair, jpools, tpools,
                                 nxt[:, None].astype(np.int32), pos, table)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        _assert_pools(jpools, tpools)
        pos = pos + 1


def test_prefill_with_aliased_prefix_matches_reference(pair):
    """Rows alias a resident prefix: one page-aligned (8 tokens), one ending
    mid-page (13 tokens); both read the pools through the prefix-prefill
    path and then decode."""
    jcfg, _, cfg, _, _ = pair
    rng = np.random.default_rng(1)
    jpools = jmodel.init_cache(jcfg, 2, MAXP * PG, page_size=PG,
                               num_pages=PAGES)
    tpools = model.init_cache(cfg, 2, MAXP * PG, page_size=PG,
                              num_pages=PAGES, device="cpu")
    toks = rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    first = _tables([[1, 2], [7, 8]])
    jl, jpools, tl = _prefill(pair, jpools, tpools, toks,
                              np.asarray([16, 16], np.int32),
                              np.zeros(2, np.int32), first, 0)
    _assert_pools(jpools, tpools)
    suffix = rng.integers(0, cfg.vocab_size, (2, 8)).astype(np.int32)
    lengths = np.asarray([6, 8], np.int32)
    prefix = np.asarray([8, 13], np.int32)
    table = _tables([[1, 10, 11], [7, 8, 12]])
    jl, jpools, tl = _prefill(pair, jpools, tpools, suffix, lengths, prefix,
                              table, MAXP)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _assert_pools(jpools, tpools)
    pos = prefix + lengths
    nxt = np.asarray(jl)[:, -1, :cfg.vocab_size].argmax(-1)
    jl, jpools, tl = _decode(pair, jpools, tpools,
                             nxt[:, None].astype(np.int32), pos, table)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _assert_pools(jpools, tpools)


def test_attention_reference_paths_match_reference():
    """The plain attention paths of models/attention.py against the
    reference's: chunked causal attention (several chunks), paged gather and
    write, gathered-prefix prefill and contiguous decode attention."""
    from repro.models import attention as jattn
    from repro_torch.models import attention
    rng = np.random.default_rng(2)
    b, s, h, kh, d, pg, maxp, pages = 2, 16, 4, 2, 32, 8, 3, 10
    f32 = np.float32
    q = rng.standard_normal((b, s, h, d)).astype(f32)
    k = rng.standard_normal((b, s, kh, d)).astype(f32)
    v = rng.standard_normal((b, s, kh, d)).astype(f32)
    pool = rng.standard_normal((pages, pg, kh, d)).astype(f32)
    vals = rng.standard_normal((b, 2, kh, d)).astype(f32)
    table = rng.integers(1, pages, (b, maxp)).astype(np.int32)
    pos = np.asarray([[3, 4], [9, 23]], np.int32)
    valid = np.asarray([[True, False], [True, True]])
    plen = np.asarray([5, 17], np.int32)
    lens = np.asarray([1, 24], np.int32)

    @jax.jit
    def reference(q, k, v, pool, vals, table, pos, valid, plen, lens):
        g = jattn.paged_gather(pool, table)
        return (jattn.chunked_attention(q, k, v, q_chunk=8, kv_chunk=4), g,
                jattn.paged_write(pool, vals, table, pos, valid),
                jattn.paged_prefill_attention(q, k, v, g, g, plen),
                jattn.decode_attention(q[:, :1], g, g, lens))

    want = [np.asarray(a) for a in reference(
        q, k, v, pool, vals, table, pos, valid, plen, lens)]
    t = {n: torch.from_numpy(a) for n, a in dict(
        q=q, k=k, v=v, pool=pool, vals=vals, table=table, pos=pos,
        valid=valid, plen=plen, lens=lens).items()}
    g = attention.paged_gather(t["pool"], t["table"])
    np.testing.assert_allclose(attention.chunked_attention(
        t["q"], t["k"], t["v"], q_chunk=8, kv_chunk=4).numpy(), want[0],
        **TOL)
    np.testing.assert_array_equal(g.numpy(), want[1])
    written = attention.paged_write(t["pool"].clone(), t["vals"], t["table"],
                                    t["pos"], t["valid"])
    # the masked write lands in trash page 0 in both: compare real pages
    np.testing.assert_array_equal(written[1:].numpy(), want[2][1:])
    np.testing.assert_allclose(attention.paged_prefill_attention(
        t["q"], t["k"], t["v"], g, g, t["plen"]).numpy(), want[3], **TOL)
    np.testing.assert_allclose(attention.decode_attention(
        t["q"][:, :1], g, g, t["lens"]).numpy(), want[4], **TOL)
