"""The port's CUDA kernels against their plain PyTorch versions on the card
(fp32 tolerance 1e-4; bf16 2e-2, its absolute part scaled by the
output's RMS), both engines of the prefill kernel, the serving wrappers
under ``torch.cuda.set_sync_debug_mode("error")``, plus a tiny paged
serving run that must launch every serving kernel, a tiny PSOFT train step
that must launch both of its training kernels and tiny OFT-family train
steps that must launch blockdiag_rotate.  Imports nothing of the reference
package, so it runs where JAX is not installed:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \
        tests/test_torch_cuda.py

Without a GPU every test here skips."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny tensors: one intra-op thread, so the suite's parallel workers do not
# contend with idle-spinning thread pools
torch.set_num_threads(1)

from repro_torch.kernels import ops, ref  # noqa: E402

DTYPES = [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only on a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _normal(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _on(device, dtype):
    def put(a):
        t = torch.from_numpy(np.ascontiguousarray(a)).to(device)
        return t.to(dtype) if t.dtype == torch.float32 else t
    return put


def _close(got, want, tol):
    """Within ``atol + tol * |want|``: atol is ``tol`` for fp32 and
    ``tol * rms(want)`` for bf16, so the bf16 limit stays below a typical
    output whatever the inputs' scale."""
    want = want.float()
    atol = tol * float(want.square().mean().sqrt()) \
        if got.dtype == torch.bfloat16 else tol
    torch.testing.assert_close(got.float(), want, atol=atol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("b,h,kh,hd,pages,pg,maxp", [
    (4, 8, 4, 64, 16, 8, 4), (2, 4, 1, 128, 8, 16, 3),
    (3, 8, 8, 32, 12, 8, 2), (8, 24, 8, 128, 257, 16, 32)])
def test_decode_kernel_matches_plain(cuda_device, dtype, tol, b, h, kh, hd,
                                     pages, pg, maxp):
    rng = np.random.default_rng(b)
    put = _on(cuda_device, dtype)
    table = rng.integers(0, pages, size=(b, maxp)).astype(np.int32)
    lengths = rng.integers(1, maxp * pg, size=b).astype(np.int32)
    lengths[0], lengths[-1] = 0, 1
    args = [put(_normal(rng, (b, h, hd))),
            put(_normal(rng, (pages, pg, kh, hd), 0.5)),
            put(_normal(rng, (pages, pg, kh, hd), 0.5)), put(table),
            put(lengths)]
    before = ops.LAUNCHES["paged_decode_attention"]
    got = ops.paged_decode_attention(*args)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["paged_decode_attention"] == before + 1
    assert torch.all(got[0] == 0)
    _close(got, ref.paged_decode_attention(*args), tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("maxp", [32, 30])
def test_decode_kernel_at_split_seams(cuda_device, dtype, tol, maxp):
    """Lengths at and next to the split seams (k * pps * pg - 1, k * pps *
    pg, + 1), a full row of maxp * pg tokens, a length-0 row, and a maxp
    that pps does not divide (30: the last split holds 2 pages)."""
    b, h, kh, hd, pg = 8, 24, 8, 128, 16
    pps, splits = ops.decode_split_plan(b, kh, maxp)
    assert pps == 4 and splits == -(-maxp // 4)
    seam = pps * pg
    lengths = np.asarray([seam - 1, seam, seam + 1, 2 * seam - 1, 2 * seam,
                          2 * seam + 1, maxp * pg, 0], np.int32)
    rng = np.random.default_rng(maxp)
    pages = 1 + b * maxp
    table = (rng.permutation(pages - 1)[:b * maxp] + 1).reshape(b, maxp)
    put = _on(cuda_device, dtype)
    args = [put(_normal(rng, (b, h, hd))),
            put(_normal(rng, (pages, pg, kh, hd), 0.5)),
            put(_normal(rng, (pages, pg, kh, hd), 0.5)),
            put(table.astype(np.int32)), put(lengths)]
    got = ops.paged_decode_attention(*args)
    torch.cuda.synchronize()
    assert torch.all(got[-1] == 0)
    _close(got, ref.paged_decode_attention(*args), tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("b,s,h,kh,hd,pages,pg,maxp,plen", [
    (2, 8, 4, 4, 32, 8, 8, 3, [5, 17]), (2, 8, 8, 2, 32, 8, 8, 3, [0, 24]),
    (1, 16, 4, 1, 64, 6, 8, 2, [9]), (2, 1, 4, 4, 32, 6, 8, 2, [7, 16]),
    (4, 64, 24, 8, 128, 129, 16, 32, [32, 0, 45, 32])])
def test_prefill_kernel_matches_plain(cuda_device, dtype, tol, b, s, h, kh,
                                      hd, pages, pg, maxp, plen):
    rng = np.random.default_rng(b + s)
    put = _on(cuda_device, dtype)
    args = [put(_normal(rng, (b, s, h, hd))),
            put(_normal(rng, (b, s, kh, hd), 0.5)),
            put(_normal(rng, (b, s, kh, hd), 0.5)),
            put(_normal(rng, (pages, pg, kh, hd), 0.5)),
            put(_normal(rng, (pages, pg, kh, hd), 0.5)),
            put(rng.integers(0, pages, size=(b, maxp)).astype(np.int32)),
            put(np.asarray(plen, np.int32))]
    got = ops.paged_prefill_attention(*args)
    _close(got, ref.paged_prefill_attention(*args), tol)
    # an empty prefix table is a causal prefill over the suffix
    q, k, v, kp, vp, table, pl = args
    got = ops.paged_prefill_attention(q, k, v, kp, vp, table[:, :0], pl)
    _close(got, ref.paged_prefill_attention(
        q, k, v, kp, vp, table[:, :1], torch.zeros_like(pl)), tol)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("b,k,n,r,na", [
    (4, 64, 96, 8, 3), (8, 128, 128, 16, 2), (3, 64, 160, 4, 5),
    (8, 3072, 1024, 352, 3), (9, 8192, 3072, 352, 3), (2, 600, 40, 600, 1)])
def test_gather_delta_kernel_matches_plain(cuda_device, dtype, tol, b, k, n,
                                           r, na):
    rng = np.random.default_rng(b)
    put = _on(cuda_device, dtype)
    x = put(_normal(rng, (b, k), 0.5))
    w = put(_normal(rng, (k, n), k ** -0.5))
    left = put(_normal(rng, (na, k, r), k ** -0.5))
    right = torch.from_numpy(_normal(rng, (na, r, n), 0.05)).to(cuda_device)
    ids = put(np.asarray([(i * 2 + 1) % na for i in range(b)], np.int32))
    got = ops.gather_delta_matmul(x, w, left, right, ids,
                                  compute_dtype=dtype)
    assert got.dtype == dtype
    _close(got, ref.gather_delta_matmul(ids, x, w, left, right), tol)
    torch.cuda.synchronize()


#: (K, N, r): K that no split divides, N not a multiple of the 64-column
#: tile (200; 100 is not a multiple of 8 either, so W and right are read
#: element by element), r of PiSSA/DoRA (8), LoRA-XS (136) and PSOFT (352)
GATHER_DELTA_SHAPES = [(1000, 200, 8), (3072, 1024, 136), (520, 100, 352)]


def _gather_ids(pattern, b):
    """(ids, bank columns): every row on one adapter, each row on its own,
    or ids outside [0, A) that the kernel clamps."""
    if pattern == "one":
        return np.full(b, 2, np.int32), 3
    if pattern == "own":
        return np.arange(b, dtype=np.int32), b
    return np.asarray([(-3, 5, 1, 9)[i % 4] for i in range(b)], np.int32), 3


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("b", [1, 3, 8, 11, 16])
@pytest.mark.parametrize("pattern", ["one", "own", "clamped"])
def test_gather_delta_split_kernel_matches_plain(cuda_device, dtype, tol, b,
                                                 pattern):
    k, n, r = GATHER_DELTA_SHAPES[b % len(GATHER_DELTA_SHAPES)]
    rng = np.random.default_rng(b * 7 + len(pattern))
    ids, na = _gather_ids(pattern, b)
    put = _on(cuda_device, dtype)
    x = put(_normal(rng, (b, k), 0.5))
    w = put(_normal(rng, (k, n), k ** -0.5))
    left = put(_normal(rng, (na, k, r), k ** -0.5))
    right = torch.from_numpy(_normal(rng, (na, r, n), 0.05)).to(cuda_device)
    idt = put(ids)
    before = ops.LAUNCHES["gather_delta_matmul"]
    got = ops.gather_delta_matmul(x, w, left, right, idt, compute_dtype=dtype)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["gather_delta_matmul"] == before + 1
    assert got.dtype == dtype and got.shape == (b, n)
    _close(got, ref.gather_delta_matmul(idt.clamp(0, na - 1), x, w, left,
                                        right), tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("s", [1, 17, 64, 130])
@pytest.mark.parametrize("g", [1, 3, 4])
@pytest.mark.parametrize("hd", [64, 128])
def test_prefill_engines_match_plain(cuda_device, dtype, tol, s, g, hd):
    """Three rows over pages of 16: no prefix, a prefix ending mid-page and
    the full table, the last row aliasing the second's pages; then the same
    suffix over an empty table.  bf16 runs on the tensor-core engine, fp32
    on the CUDA cores."""
    b, kh, pg, maxp = 3, 2, 16, 3
    h, pages = g * kh, 1 + b * maxp
    rng = np.random.default_rng(s * 16 + g * 4 + hd)
    put = _on(cuda_device, dtype)
    table = (rng.permutation(pages - 1)[:b * maxp] + 1).reshape(b, maxp)
    table[2] = table[1]
    args = [put(_normal(rng, (b, s, h, hd))),
            put(_normal(rng, (b, s, kh, hd), 0.5)),
            put(_normal(rng, (b, s, kh, hd), 0.5)),
            put(_normal(rng, (pages, pg, kh, hd), 0.5)),
            put(_normal(rng, (pages, pg, kh, hd), 0.5)),
            put(table.astype(np.int32)),
            put(np.asarray([0, 21, maxp * pg], np.int32))]
    engine = "mma" if dtype == torch.bfloat16 else "simt"
    assert ops._prefill_engine(dtype, hd) == engine
    ops.reset_launches()
    got = ops.paged_prefill_attention(*args)
    _close(got, ref.paged_prefill_attention(*args), tol)
    q, k, v, kp, vp, tab, pl = args
    got = ops.paged_prefill_attention(q, k, v, kp, vp, tab[:, :0], pl)
    _close(got, ref.paged_prefill_attention(
        q, k, v, kp, vp, tab[:, :1], torch.zeros_like(pl)), tol)
    torch.cuda.synchronize()
    assert ops.PREFILL_ENGINE_LAUNCHES[engine] == 2 == \
        ops.LAUNCHES["paged_prefill_attention"], ops.PREFILL_ENGINE_LAUNCHES


@pytest.mark.cuda
def test_prefill_refuses_a_bf16_head_dim_it_is_not_built_for(cuda_device):
    q = torch.zeros((1, 4, 2, 96), dtype=torch.bfloat16, device=cuda_device)
    pool = torch.zeros((2, 16, 2, 96), dtype=torch.bfloat16,
                       device=cuda_device)
    table = torch.ones((1, 1), dtype=torch.int32, device=cuda_device)
    plen = torch.zeros((1,), dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="head_dim 96"):
        ops.paged_prefill_attention(q, q.clone(), q.clone(), pool, pool,
                                    table, plen)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_serving_wrappers_never_sync_with_the_host(cuda_device, dtype):
    """Neither wrapper reads a device value on the host: under
    ``set_sync_debug_mode("error")`` a synchronising call would raise."""
    rng = np.random.default_rng(5)
    put = _on(cuda_device, dtype)
    x, w = put(_normal(rng, (8, 256))), put(_normal(rng, (256, 192), 0.06))
    left = put(_normal(rng, (3, 256, 16), 0.06))
    right = torch.from_numpy(_normal(rng, (3, 16, 192), 0.05)).to(cuda_device)
    ids = put(np.asarray([0, 1, 2, 1, 0, 2, 2, 7], np.int32))
    pre = [put(_normal(rng, (2, 24, 6, 64))),
           put(_normal(rng, (2, 24, 2, 64), 0.5)),
           put(_normal(rng, (2, 24, 2, 64), 0.5)),
           put(_normal(rng, (5, 16, 2, 64), 0.5)),
           put(_normal(rng, (5, 16, 2, 64), 0.5)),
           put(np.asarray([[1, 2], [3, 4]], np.int32)),
           put(np.asarray([20, 32], np.int32))]
    # build and load both libraries first (the build is host work)
    ops.gather_delta_matmul(x, w, left, right, ids, compute_dtype=dtype)
    ops.paged_prefill_attention(*pre)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        y = ops.gather_delta_matmul(x, w, left, right, ids,
                                    compute_dtype=dtype)
        out = ops.paged_prefill_attention(*pre)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    tol = dict(DTYPES)[dtype]
    _close(y, ref.gather_delta_matmul(ids.clamp(0, 2), x, w, left, right),
           tol)
    _close(out, ref.paged_prefill_attention(*pre), tol)


@pytest.mark.cuda
def test_wrappers_reject_what_the_kernels_do_not_take(cuda_device):
    q = torch.zeros((2, 4, 32), dtype=torch.float16, device=cuda_device)
    pool = torch.zeros((4, 8, 2, 32), dtype=torch.float16, device=cuda_device)
    idx = torch.zeros((2, 1), dtype=torch.int32, device=cuda_device)
    ln = torch.zeros((2,), dtype=torch.int32, device=cuda_device)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ops.paged_decode_attention(q, pool, pool, idx, ln)
    q = torch.zeros((2, 32, 4), device=cuda_device).transpose(1, 2)
    pool = pool.float()
    with pytest.raises(ValueError, match="contiguous"):
        ops.paged_decode_attention(q, pool, pool, idx, ln)


@pytest.mark.cuda
def test_tiny_serving_launches_every_kernel(cuda_device):
    """A tiny fp32 engine on the card with an adapter and a shared prompt
    prefix goes through all three serving kernels and returns every page."""
    from repro_torch.configs import get_config
    from repro_torch.models import model
    from repro_torch.serve import Request, ServeEngine
    cfg = get_config("tiny")
    params = model.init_params(cfg, seed=0, device=cuda_device)
    tuned = {**params, "layers": {**params["layers"], "attn": {
        name: {**lin, "q": lin["q"] + 0.05}
        for name, lin in params["layers"]["attn"].items()}}}
    eng = ServeEngine(params, cfg, max_len=64, slots=3, page_size=8,
                      device=cuda_device)
    eng.register_adapter("tuned", tuned)
    rng = np.random.default_rng(0)
    system = rng.integers(0, cfg.vocab_size, 20).astype(np.int32)
    reqs = [Request(uid=i, prompt=np.concatenate(
        [system, rng.integers(0, cfg.vocab_size, 4).astype(np.int32)]),
        max_new_tokens=4, adapter=("base", "tuned")[i % 2])
        for i in range(6)]
    ops.reset_launches()
    done = eng.run(reqs)
    assert all(r.done and len(r.generated) == 4 for r in done)
    assert eng.kv.stats["prefix_hits"] > 0
    assert eng.kv.pages_in_use() == 0
    serving = ("paged_decode_attention", "paged_prefill_attention",
               "gather_delta_matmul")
    assert all(ops.LAUNCHES[n] > 0 for n in serving), ops.LAUNCHES


# ---------------------------------------------------------------------------
# training kernels
# ---------------------------------------------------------------------------

def _psoft_inputs(rng, put, m, k, n, r, transpose=False):
    """The scales of an SVD split of W ~ N(0, 1/k): A's columns of unit
    norm, B's rows of norm ~2.4 (the top singular values), R near the
    identity."""
    x = put(_normal(rng, (m, n if transpose else k), 0.5))
    w = put(_normal(rng, (k, n), k ** -0.5))
    a = put(_normal(rng, (k, r), k ** -0.5))
    b = put(_normal(rng, (r, n), 2.4 * n ** -0.5))
    f32 = _on(x.device, torch.float32)
    rot = f32(_normal(rng, (r, r), 0.1 * r ** -0.5)
              + np.eye(r, dtype=np.float32))
    s_in = f32(1 + 0.1 * _normal(rng, (r,)))
    s_out = f32(1 + 0.1 * _normal(rng, (r,)))
    return x, w, a, rot, b, s_in, s_out


PSOFT_SHAPES = [(64, 128, 128, 8), (37, 96, 40, 12), (130, 200, 72, 33),
                (2048, 3072, 1024, 352), (200, 3072, 8192, 352),
                (128, 8192, 3072, 352)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("m,k,n,r", PSOFT_SHAPES)
@pytest.mark.parametrize("transpose", [False, True])
def test_psoft_matmul_kernel_matches_plain(cuda_device, dtype, tol, m, k, n,
                                           r, transpose):
    """Forward and the backward's transposed launch (ragged M, K, N, r,
    N = 1024 and the llama32-3b shapes): y, u and t."""
    rng = np.random.default_rng(m + k + n + r)
    args = _psoft_inputs(rng, _on(cuda_device, dtype), m, k, n, r, transpose)
    before = ops.LAUNCHES["psoft_matmul"]
    got = ops._psoft_mm(*args, transpose)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["psoft_matmul"] == before + 1
    want = ref.psoft_matmul_parts(*args, transpose)
    assert got[0].shape == (m, k if transpose else n)
    assert got[0].dtype == dtype
    _close(got[0], want[0], tol)
    # u and t are fp32 in both dtypes (bf16 products are exact in fp32):
    # only the order of the sums differs
    for g, w in zip(got[1:], want[1:]):
        rms = float(w.square().mean().sqrt())
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4 * rms)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("m,k,n,r", [(96, 128, 136, 16), (40, 72, 24, 9)])
def test_psoft_matmul_grads_match_autograd_of_plain(cuda_device, dtype, tol,
                                                    m, k, n, r):
    """Every grad of the autograd function, the frozen factors' included,
    against autograd of the plain version in fp32 on the same values (in
    bf16, autograd of the plain version would round the cotangent where v
    is cast; the kernel's backward, like the reference's custom VJP, keeps
    the rank-r cotangents in fp32)."""
    rng = np.random.default_rng(m + r)
    args = _psoft_inputs(rng, _on(cuda_device, dtype), m, k, n, r)
    dy = _on(cuda_device, dtype)(_normal(rng, (m, n)))
    leaves = [a.detach().clone().requires_grad_(True) for a in args]
    twins = [a.detach().float().requires_grad_(True) for a in args]
    y = ops.psoft_matmul(*leaves)
    got = torch.autograd.grad(y, leaves, dy)
    y2 = ref.psoft_matmul(*twins)
    want = torch.autograd.grad(y2, twins, dy.float())
    _close(y.detach(), y2.detach(), tol)
    for g, w, leaf in zip(got, want, leaves):
        assert g.dtype == leaf.dtype
        _close(g, w, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,r", [
    (130, 72, 200, 8), (200, 3072, 1000, 64), (130, 3072, 1000, 352),
    (200, 72, 136, 352)])
@pytest.mark.parametrize("transpose", [False, True])
def test_psoft_matmul_wgmma_engine_matches_plain(cuda_device, m, k, n, r,
                                                 transpose):
    """The Hopper engine (TMA + wgmma) at ragged M, N not a tile multiple,
    K a multiple of 64 or not, and r below, at and across one 64-deep step
    (the seam mid-step at r = 352): y in bf16, u and t in fp32."""
    rng = np.random.default_rng(m + k + n + r)
    args = _psoft_inputs(rng, _on(cuda_device, torch.bfloat16), m, k, n, r,
                         transpose)
    ops.reset_launches()
    got = ops._psoft_mm(*args, transpose)
    torch.cuda.synchronize()
    assert ops.PSOFT_ENGINE_LAUNCHES == {"wgmma": 1, "wmma": 0, "simt": 0}
    want = ref.psoft_matmul_parts(*args, transpose)
    assert got[0].shape == (m, k if transpose else n)
    _close(got[0], want[0], 2e-2)
    for g, w in zip(got[1:], want[1:]):
        rms = float(w.square().mean().sqrt())
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4 * rms)


@pytest.mark.cuda
def test_psoft_matmul_engines_by_shape_on_the_card(cuda_device):
    """fp32 takes the CUDA-core engine, bf16 with r = 12 (a 24-byte row)
    the WMMA one, bf16 with every pitch a multiple of 16 bytes wgmma."""
    rng = np.random.default_rng(5)
    for dtype, r, engine in ((torch.float32, 16, "simt"),
                             (torch.bfloat16, 12, "wmma"),
                             (torch.bfloat16, 16, "wgmma")):
        args = _psoft_inputs(rng, _on(cuda_device, dtype), 64, 128, 128, r)
        ops.reset_launches()
        ops._psoft_mm(*args, False)
        torch.cuda.synchronize()
        assert ops.PSOFT_ENGINE_LAUNCHES[engine] == 1, (dtype, r)
        assert sum(ops.PSOFT_ENGINE_LAUNCHES.values()) == 1


@pytest.mark.cuda
def test_psoft_matmul_grads_on_the_wgmma_engine(cuda_device):
    """Every grad of the autograd function on the Hopper engine (forward
    and the transposed dx launch) against autograd of the plain version in
    fp32 on the same values."""
    m, k, n, r = 200, 72, 136, 64
    rng = np.random.default_rng(7)
    args = _psoft_inputs(rng, _on(cuda_device, torch.bfloat16), m, k, n, r)
    dy = _on(cuda_device, torch.bfloat16)(_normal(rng, (m, n)))
    leaves = [a.detach().clone().requires_grad_(True) for a in args]
    twins = [a.detach().float().requires_grad_(True) for a in args]
    ops.reset_launches()
    y = ops.psoft_matmul(*leaves)
    got = torch.autograd.grad(y, leaves, dy)
    torch.cuda.synchronize()
    assert ops.PSOFT_ENGINE_LAUNCHES == {"wgmma": 2, "wmma": 0, "simt": 0}
    y2 = ref.psoft_matmul(*twins)
    want = torch.autograd.grad(y2, twins, dy.float())
    _close(y.detach(), y2.detach(), 2e-2)
    for g, w, leaf in zip(got, want, leaves):
        assert g.dtype == leaf.dtype
        _close(g, w, 2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("n_mat,r", [(1, 8), (3, 46), (28, 352)])
@pytest.mark.parametrize("terms", [0, 1, 5])
def test_cayley_kernel_matches_plain(cuda_device, n_mat, r, terms):
    rng = np.random.default_rng(n_mat * r + terms)
    q = _normal(rng, (n_mat, r, r), 0.03)
    q = torch.from_numpy(q - q.transpose(0, 2, 1)).to(cuda_device)
    before = ops.LAUNCHES["cayley_neumann"]
    rot, series = ops._cayley(q, terms)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["cayley_neumann"] == before + 1
    want_rot, want_series = ref.cayley_neumann_series(q, terms)
    _close(rot, want_rot, 1e-4)
    assert series.shape == (terms, n_mat, r, r)
    if terms:
        _close(series, want_series, 1e-4)
    # the reverse Horner backward against autograd of the plain series
    wt = torch.from_numpy(_normal(rng, (n_mat, r, r))).to(cuda_device)
    q1 = q.clone().requires_grad_(True)
    q2 = q.clone().requires_grad_(True)
    (ops.cayley_neumann(q1, terms) * wt).sum().backward()
    (ref.cayley_neumann(q2, terms) * wt).sum().backward()
    _close(q1.grad, q2.grad, 1e-4)


@pytest.mark.cuda
def test_tiny_train_step_launches_both_training_kernels(cuda_device):
    """One fp32 tiny train step on the card goes through psoft_matmul (the
    forward, the remat recompute and the backward's transposed launch of
    every PSOFT linear) and cayley_neumann (once per linear stack), and
    matches the same step on the CPU."""
    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.train import trainer
    cfg = get_config("tiny")
    tc = TrainConfig(steps=5, learning_rate=1e-2, warmup_ratio=0.0)
    cpu_state = trainer.init_train_state(cfg, tc, seed=0, device="cpu")
    gpu_state = _to_device(cpu_state, cuda_device)
    batch = SyntheticLMDataset(cfg, 4, 32).batch_at(0)
    step = trainer.make_train_step(cfg, tc)
    ops.reset_launches()
    new_gpu, m_gpu = step(gpu_state, batch)
    torch.cuda.synchronize()
    linears = 7 * cfg.num_layers
    assert ops.LAUNCHES["psoft_matmul"] == 3 * linears, ops.LAUNCHES
    assert ops.LAUNCHES["cayley_neumann"] == 7, ops.LAUNCHES
    _, m_cpu = step(cpu_state, batch)
    assert float(m_gpu["loss"]) == pytest.approx(float(m_cpu["loss"]),
                                                  rel=1e-4)
    assert float(m_gpu["grad_norm"]) > 0


def _to_device(tree, device):
    """``tree`` with every tensor leaf moved to ``device`` (None kept)."""
    from repro_torch.tree import tree_map
    return tree_map(lambda t: t.to(device), tree)


#: (M, d, b): ragged M, every block size of the OFT family's path (32, 8,
#: 2), b = 128 (one group a block), blocks that are not a multiple of 4
#: (6) or do not divide 128 (48), and d that is not a multiple of 128
BLOCKDIAG_SHAPES = [(70, 256, 32), (128, 96, 8), (33, 64, 2),
                    (64, 256, 128), (50, 96, 6), (17, 192, 48),
                    (200, 3072, 32)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("m,d,b", BLOCKDIAG_SHAPES)
@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("rots_in_x_dtype", [False, True])
def test_blockdiag_rotate_kernel_matches_plain(cuda_device, dtype, tol, m,
                                               d, b, transpose,
                                               rots_in_x_dtype):
    rng = np.random.default_rng(m * d + b)
    put = _on(cuda_device, dtype)
    x = put(_normal(rng, (m, d)))
    rots = torch.from_numpy(np.eye(b, dtype=np.float32)
                            + _normal(rng, (d // b, b, b), 0.2)
                            ).to(cuda_device)
    if rots_in_x_dtype:
        rots = rots.to(dtype)
    before = ops.LAUNCHES["blockdiag_rotate"]
    got = ops.blockdiag_rotate(x, rots, transpose=transpose)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["blockdiag_rotate"] == before + 1
    assert got.dtype == dtype and got.shape == x.shape
    _close(got, ref.blockdiag_rotate(x, rots, transpose), tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("b,transpose", [(32, False), (8, True), (2, False)])
def test_blockdiag_rotate_grads_match_autograd_of_plain(cuda_device, dtype,
                                                        tol, b, transpose):
    rng = np.random.default_rng(b)
    put = _on(cuda_device, dtype)
    x = put(_normal(rng, (96, 128)))
    rots = torch.from_numpy(np.eye(b, dtype=np.float32)
                            + _normal(rng, (128 // b, b, b), 0.2)
                            ).to(cuda_device).to(dtype)
    dy = put(_normal(rng, (96, 128)))
    leaves = [x.clone().requires_grad_(True),
              rots.clone().requires_grad_(True)]
    got = torch.autograd.grad(
        ops.blockdiag_rotate(*leaves, transpose=transpose), leaves, dy)
    twins = [t.detach().float().requires_grad_(True) for t in (x, rots)]
    want = torch.autograd.grad(ref.blockdiag_rotate(*twins, transpose),
                               twins, dy.float())
    for g, w, leaf in zip(got, want, leaves):
        assert g.dtype == leaf.dtype
        _close(g, w, tol)


@pytest.mark.cuda
def test_blockdiag_rotate_refuses_what_the_kernel_does_not_take(
        cuda_device):
    x = torch.zeros((4, 512), device=cuda_device)
    with pytest.raises(ValueError, match="at most 128"):
        ops.blockdiag_rotate(x, torch.zeros((2, 256, 256),
                                            device=cuda_device))
    with pytest.raises(ValueError, match="rots must be"):
        ops.blockdiag_rotate(x, torch.zeros((3, 32, 32), device=cuda_device))
    with pytest.raises(TypeError, match="rots"):
        ops.blockdiag_rotate(x, torch.zeros((16, 32, 32), device=cuda_device,
                                            dtype=torch.bfloat16))


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["oft", "boft", "goft"])
def test_tiny_oft_family_step_launches_blockdiag_rotate(cuda_device, method):
    """One fp32 tiny train step on the card rotates through the kernel: 3
    launches per rotation of the forward (forward, remat recompute, the
    backward's dx) but for the first rotation of layer 0's q, k and v,
    whose input comes from the frozen embedding and takes no dx; and it
    matches the same step on the CPU."""
    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.core import oft
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.train import trainer
    cfg = get_config("tiny")
    cfg = cfg.replace(peft=cfg.peft.replace(method=method))
    tc = TrainConfig(steps=5, learning_rate=1e-2, warmup_ratio=0.0)
    cpu_state = trainer.init_train_state(cfg, tc, seed=0, device="cpu")
    gpu_state = _to_device(cpu_state, cuda_device)
    batch = SyntheticLMDataset(cfg, 4, 32).batch_at(0)
    step = trainer.make_train_step(cfg, tc)
    ops.reset_launches()
    _, m_gpu = step(gpu_state, batch)
    torch.cuda.synchronize()
    d, f = cfg.d_model, cfg.d_ff
    per = {"oft": lambda n: 1, "boft": lambda n: cfg.peft.boft_factors,
           "goft": oft._num_levels}[method]
    rotations = cfg.num_layers * (6 * per(d) + per(f))
    assert ops.LAUNCHES["blockdiag_rotate"] == 3 * rotations - 3, \
        ops.LAUNCHES
    assert ops.LAUNCHES["cayley_neumann"] == (0 if method == "goft" else 7)
    _, m_cpu = step(cpu_state, batch)
    assert float(m_gpu["loss"]) == pytest.approx(float(m_cpu["loss"]),
                                                  rel=1e-4)
    assert float(m_gpu["grad_norm"]) == pytest.approx(
        float(m_cpu["grad_norm"]), rel=1e-4)
