"""The port's paged prefix-prefill wrapper against the reference package:
on CPU tensors it returns its plain PyTorch version, held here against both
the reference oracle (``repro.kernels.ref``) and the interpret-mode Pallas
kernel over ragged, page-unaligned prefixes, fp32, tolerance 1e-5."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny tensors: one intra-op thread, so the suite's parallel workers do not
# contend with idle-spinning thread pools
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops, ref as jref  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _j(a):
    return jnp.asarray(a)


def _normal(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _prefill_case(seed, b, s, h, kh, hd, pages, pg, maxp):
    rng = np.random.default_rng(seed)
    q = _normal(rng, (b, s, h, hd))
    k = _normal(rng, (b, s, kh, hd), 0.5)
    v = _normal(rng, (b, s, kh, hd), 0.5)
    k_pool = _normal(rng, (pages, pg, kh, hd), 0.5)
    v_pool = _normal(rng, (pages, pg, kh, hd), 0.5)
    table = rng.integers(0, pages, size=(b, maxp)).astype(np.int32)
    return q, k, v, k_pool, v_pool, table


def _prefill_both(case, plen):
    q, k, v, kp, vp, table = case
    got = ops.paged_prefill_attention(_t(q), _t(k), _t(v), _t(kp), _t(vp),
                                      _t(table), _t(plen)).numpy()
    kernel = np.asarray(jops.paged_prefill_attention(
        _j(q), _j(k), _j(v), _j(kp), _j(vp), _j(table), _j(plen)))
    return got, kernel


@pytest.mark.parametrize("b,s,h,kh,hd,pages,pg,maxp", [
    (2, 8, 4, 4, 32, 8, 8, 3),     # MHA
    (2, 8, 8, 2, 32, 8, 8, 3),     # GQA
    (1, 16, 4, 1, 64, 6, 8, 2),    # MQA
])
def test_paged_prefill_plain_vs_reference(b, s, h, kh, hd, pages, pg, maxp):
    case = _prefill_case(b + s, b, s, h, kh, hd, pages, pg, maxp)
    rng = np.random.default_rng(b)
    plen = rng.integers(0, maxp * pg + 1, size=b).astype(np.int32)
    got, kernel = _prefill_both(case, plen)
    np.testing.assert_allclose(got, kernel, **TOL)
    q, k, v, kp, vp, table = case
    oracle = np.asarray(jref.paged_prefill_attention_ref(
        _j(q), _j(k), _j(v), _j(kp), _j(vp), _j(table), _j(plen)))
    np.testing.assert_allclose(got, oracle, **TOL)


@pytest.mark.parametrize("plen", [
    [0, 0],          # empty prefix: pure causal prefill
    [8, 8],          # exactly one full page
    [1, 24],         # single prefix token / full table
    [5, 17],         # prefixes ending mid-page
])
def test_paged_prefill_plain_edges(plen):
    case = _prefill_case(17, 2, 8, 4, 2, 32, 8, 8, 3)
    got, kernel = _prefill_both(case, np.asarray(plen, np.int32))
    np.testing.assert_allclose(got, kernel, **TOL)


def test_paged_prefill_plain_empty_table():
    """A width-0 table is padded to one trash column: a causal prefill."""
    q, k, v, kp, vp, _ = _prefill_case(23, 2, 8, 4, 2, 32, 4, 8, 1)
    empty = torch.zeros((2, 0), dtype=torch.int32)
    lens = torch.zeros((2,), dtype=torch.int32)
    got = ops.paged_prefill_attention(_t(q), _t(k), _t(v), _t(kp), _t(vp),
                                      empty, lens).numpy()
    kernel = np.asarray(jops.paged_prefill_attention(
        _j(q), _j(k), _j(v), _j(kp), _j(vp), jnp.zeros((2, 0), jnp.int32),
        jnp.zeros((2,), jnp.int32)))
    np.testing.assert_allclose(got, kernel, **TOL)


def test_paged_prefill_plain_single_suffix_token():
    case = _prefill_case(29, 2, 1, 4, 4, 32, 6, 8, 2)
    got, kernel = _prefill_both(case, np.asarray([7, 16], np.int32))
    np.testing.assert_allclose(got, kernel, **TOL)
