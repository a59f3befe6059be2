"""The port's kernel wrappers against the reference package: on CPU tensors
each wrapper returns its plain PyTorch version, held here against both the
reference oracle (``repro.kernels.ref``) and the interpret-mode Pallas
kernel, fp32, tolerance 1e-5.  The CUDA launch path is tested on the card
by test_torch_cuda.py."""
import math
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny tensors: one intra-op thread, so the suite's parallel workers do not
# contend with idle-spinning thread pools
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops, ref as jref  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _j(a):
    return jnp.asarray(a)


def _normal(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


# --------------------------------------------------------------- decode

def _decode_case(seed, b, h, kh, hd, pages, pg, maxp):
    rng = np.random.default_rng(seed)
    q = _normal(rng, (b, h, hd))
    k_pool = _normal(rng, (pages, pg, kh, hd), 0.5)
    v_pool = _normal(rng, (pages, pg, kh, hd), 0.5)
    # repeated and non-contiguous page ids, as aliased prefixes produce
    table = rng.integers(0, pages, size=(b, maxp)).astype(np.int32)
    lengths = rng.integers(1, maxp * pg, size=b).astype(np.int32)
    lengths[0] = 0      # a dead slot
    lengths[-1] = 1     # a single cached token
    return q, k_pool, v_pool, table, lengths


@pytest.mark.parametrize("b,h,kh,hd,pages,pg,maxp", [
    (4, 8, 4, 64, 16, 8, 4),      # GQA
    (2, 4, 1, 128, 8, 16, 3),     # MQA
    (3, 8, 8, 32, 12, 8, 2),      # MHA
])
def test_paged_decode_plain_vs_reference(b, h, kh, hd, pages, pg, maxp):
    q, kp, vp, table, lengths = _decode_case(b, b, h, kh, hd, pages, pg,
                                             maxp)
    got = ops.paged_decode_attention(_t(q), _t(kp), _t(vp), _t(table),
                                     _t(lengths)).numpy()
    kernel = np.asarray(jops.paged_decode_attention(
        _j(q), _j(kp), _j(vp), _j(table), _j(lengths)))
    np.testing.assert_allclose(got, kernel, **TOL)
    # the gather oracle averages uniformly over a length-0 row; the kernels
    # (and the port's plain version) output exact zeros there
    oracle = np.asarray(jref.paged_decode_attention_ref(
        _j(q), _j(kp), _j(vp), _j(table), _j(lengths)))
    live = lengths > 0
    np.testing.assert_allclose(got[live], oracle[live], **TOL)
    assert np.all(got[~live] == 0.0)


def test_paged_decode_dead_rows_are_zero():
    rng = np.random.default_rng(0)
    q = _normal(rng, (4, 8, 64))
    pool = _normal(rng, (16, 8, 4, 64))
    out = ref.paged_decode_attention(
        _t(q), _t(pool), _t(pool), torch.zeros((4, 3), dtype=torch.int32),
        torch.zeros((4,), dtype=torch.int32))
    assert torch.all(out == 0.0)


# --------------------------------------------------------------- gather-delta

def _delta_case(seed, b, k, n, r, na):
    rng = np.random.default_rng(seed)
    x = _normal(rng, (b, k), 0.5)
    w = _normal(rng, (k, n), 0.05)
    left = _normal(rng, (na, k, r), 0.1)
    right = _normal(rng, (na, r, n), 0.1)
    ids = np.asarray([(i * 2 + 1) % na for i in range(b)], np.int32)
    return x, w, left, right, ids


@pytest.mark.parametrize("b,k,n,r,na", [
    (4, 64, 96, 8, 3), (8, 128, 128, 16, 2), (3, 64, 160, 4, 5),
])
def test_gather_delta_plain_vs_reference(b, k, n, r, na):
    x, w, left, right, ids = _delta_case(b, b, k, n, r, na)
    got = ops.gather_delta_matmul(_t(x), _t(w), _t(left), _t(right),
                                  _t(ids), compute_dtype=torch.float32)
    assert got.dtype == torch.float32
    kernel = np.asarray(jops.gather_delta_matmul(
        _j(x), _j(w), _j(left), _j(right), _j(ids),
        compute_dtype=jnp.float32))
    np.testing.assert_allclose(got.numpy(), kernel, **TOL)
    oracle = np.asarray(jref.gather_delta_matmul_ref(
        _j(ids), _j(x), _j(w), _j(left), _j(right)))
    np.testing.assert_allclose(got.numpy(), oracle, **TOL)


def test_gather_delta_plain_row_isolation():
    """Each row's output depends only on its own adapter id."""
    x, w, left, right, _ = _delta_case(2, 4, 64, 128, 8, 4)
    ids = torch.arange(4, dtype=torch.int32)
    batched = ops.gather_delta_matmul(_t(x), _t(w), _t(left), _t(right), ids,
                                      compute_dtype=torch.float32)
    for i in range(4):
        solo = ops.gather_delta_matmul(_t(x[i:i + 1]), _t(w), _t(left),
                                       _t(right), ids[i:i + 1],
                                       compute_dtype=torch.float32)
        np.testing.assert_allclose(batched[i].numpy(), solo[0].numpy(),
                                   atol=1e-6)


# --------------------------------------------------------------- wrappers

def test_wrappers_refuse_other_devices():
    """Only CPU tensors take the plain version; anything else launches a
    kernel or raises."""
    x, w, left, right, ids = _delta_case(0, 2, 16, 32, 4, 2)
    with pytest.raises(ValueError, match="device"):
        ops.gather_delta_matmul(_t(x).to("meta"), _t(w).to("meta"),
                                _t(left).to("meta"), _t(right).to("meta"),
                                _t(ids).to("meta"))
    with pytest.raises(ValueError, match="different devices"):
        ops.gather_delta_matmul(_t(x), _t(w).to("meta"), _t(left),
                                _t(right), _t(ids))


def test_cpu_calls_do_not_count_as_launches():
    ops.reset_launches()
    q, kp, vp, table, lengths = _decode_case(1, 2, 4, 2, 32, 6, 8, 2)
    ops.paged_decode_attention(_t(q), _t(kp), _t(vp), _t(table), _t(lengths))
    assert ops.LAUNCHES == {k: 0 for k in ops.LAUNCHES}


def test_plain_decode_lse_is_the_scores_logsumexp():
    """The paged-decode wrapper's plain version (CPU tensors) with
    ``lse``: each row's and head's log-sum-exp equals ``torch.logsumexp``
    of its scaled scores over its valid tokens, -inf for a row of length
    0; the output is the one without ``lse``; ``dense_decode_attention``
    over a dense buffer gives the same through its view."""
    from repro_torch.models import attention
    gen = torch.Generator().manual_seed(3)
    b, h, kh, d, pg, maxp = 3, 6, 2, 8, 4, 3
    q = torch.randn((b, h, d), generator=gen)
    kp = torch.randn((10, pg, kh, d), generator=gen)
    vp = torch.randn((10, pg, kh, d), generator=gen)
    table = torch.randint(0, 10, (b, maxp), generator=gen, dtype=torch.int32)
    lengths = torch.tensor([0, 5, 12], dtype=torch.int32)
    out, lse = ops.paged_decode_attention(q, kp, vp, table, lengths, lse=True)
    assert torch.equal(out, ops.paged_decode_attention(q, kp, vp, table,
                                                       lengths))
    keys = kp[table.long()].reshape(b, maxp * pg, kh, d)
    for row in range(b):
        n = int(lengths[row])
        for head in range(h):
            if n == 0:
                assert lse[row, head] == -math.inf
                continue
            s = keys[row, :n, head // (h // kh)] @ q[row, head] / math.sqrt(d)
            torch.testing.assert_close(lse[row, head], torch.logsumexp(s, 0),
                                       rtol=1e-6, atol=1e-6)
    dense_k = keys.contiguous()
    dense_v = vp[table.long()].reshape(b, maxp * pg, kh, d).contiguous()
    got, got_lse = attention.dense_decode_attention(
        q[:, None], dense_k, dense_v, lengths, None, lse=True)
    torch.testing.assert_close(got[:, 0], out, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(got_lse, lse, rtol=1e-6, atol=1e-6)
