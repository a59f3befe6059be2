"""The port's CUDA kernels against their plain PyTorch versions on the card
(fp32 tolerance 1e-4; bf16 2e-2, its absolute part scaled by the
output's RMS), both engines of the prefill kernel, the serving wrappers
under ``torch.cuda.set_sync_debug_mode("error")``, plus a tiny paged
serving run that must launch every serving kernel, a tiny PSOFT train step
that must launch both of its training kernels and tiny OFT-family train
steps that must launch blockdiag_rotate, the recurrent families'
shapes and dense-cache engine, and the dense zoo's widths (gather-delta
at K 24576, both attention kernels at GQA group 12), the remat policies'
psoft_matmul launches and the training launcher.  Imports nothing of the
reference package, so it runs where JAX is not installed:

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
@pytest.mark.parametrize("hd", [5, 20, 96, 6, 33])
def test_decode_kernel_at_any_head_dim(cuda_device, dtype, tol, hd):
    """Head dims whose rows are not a multiple of 16 bytes in one dtype or
    both (5, 33 odd; 20 and 6 bf16 rows of 40 and 12 bytes) take the
    element-by-element copies; 96 the 16-byte ones."""
    b, h, kh, pages, pg, maxp = 4, 6, 2, 20, 8, 4
    rng = np.random.default_rng(hd)
    put = _on(cuda_device, dtype)
    table = rng.integers(0, pages, size=(b, maxp)).astype(np.int32)
    lengths = np.asarray([0, 1, 19, maxp * pg], np.int32)
    args = [put(_normal(rng, (b, h, hd))),
            put(_normal(rng, (pages, pg, kh, hd), 0.5)),
            put(_normal(rng, (pages, pg, kh, hd), 0.5)), put(table),
            put(lengths)]
    got = ops.paged_decode_attention(*args)
    torch.cuda.synchronize()
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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("maxp", [32, 30, 3])
def test_decode_kernel_lse_matches_plain(cuda_device, dtype, maxp):
    """The combine kernel's log-sum-exp output (a decode over one slice of
    a sequence-split cache): each row's and head's lse within fp32's 1e-4
    of the plain version's, -inf exactly at a length-0 row, across split
    seams; the output equal to the call without it."""
    b, h, kh, hd, pg = 8, 24, 8, 128, 16
    rng = np.random.default_rng(100 + maxp)
    lengths = rng.integers(1, maxp * pg + 1, size=b).astype(np.int32)
    lengths[0], lengths[1] = 0, maxp * pg
    pages = 1 + b * maxp
    table = (rng.permutation(pages - 1)[:b * maxp] + 1).reshape(b, maxp)
    put = _on(cuda_device, dtype)
    args = [put(_normal(rng, (b, h, hd))),
            put(_normal(rng, (pages, pg, kh, hd), 0.5)),
            put(_normal(rng, (pages, pg, kh, hd), 0.5)),
            put(table.astype(np.int32)), put(lengths)]
    out, lse = ops.paged_decode_attention(*args, lse=True)
    want, want_lse = ref.paged_decode_attention(*args, lse=True)
    torch.cuda.synchronize()
    assert lse.dtype == torch.float32 and lse.shape == (b, h)
    assert torch.equal(out, ops.paged_decode_attention(*args))
    assert torch.all(torch.isneginf(lse[0])) and \
        not torch.isinf(lse[1:]).any()
    torch.testing.assert_close(lse[1:], want_lse[1:], atol=1e-4, rtol=1e-4)


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
@pytest.mark.parametrize("hd", [80, 96, 256])
def test_prefill_bf16_head_dims_off_the_mma_engine(cuda_device, hd):
    """bf16 head dims the "mma" engine is not built for run on "simt"
    against the plain version: three rows (no prefix, one ending mid-page,
    the full table), G = 3."""
    b, s, kh, g, pg, maxp = 3, 17, 2, 3, 16, 3
    h, pages = g * kh, 1 + b * maxp
    rng = np.random.default_rng(hd)
    put = _on(cuda_device, torch.bfloat16)
    table = (rng.permutation(pages - 1)[:b * maxp] + 1).reshape(b, maxp)
    args = [put(_normal(rng, (b, s, h, hd))),
            put(_normal(rng, (b, s, kh, hd), 0.5)),
            put(_normal(rng, (b, s, kh, hd), 0.5)),
            put(_normal(rng, (pages, pg, kh, hd), 0.5)),
            put(_normal(rng, (pages, pg, kh, hd), 0.5)),
            put(table.astype(np.int32)),
            put(np.asarray([0, 21, maxp * pg], np.int32))]
    assert ops._prefill_engine(torch.bfloat16, hd) == "simt"
    ops.reset_launches()
    got = ops.paged_prefill_attention(*args)
    torch.cuda.synchronize()
    assert ops.PREFILL_ENGINE_LAUNCHES == {"mma": 0, "simt": 1}
    _close(got, ref.paged_prefill_attention(*args), 2e-2)


@pytest.mark.cuda
def test_prefill_refuses_a_bf16_head_dim_it_is_not_built_for(cuda_device):
    """The wrapper sends bf16 D = 96 to "simt"; the C entry point refuses
    the "mma" engine code at that head dim."""
    from repro_torch.kernels import build
    q = torch.zeros((1, 4, 2, 96), dtype=torch.bfloat16, device=cuda_device)
    pool = torch.zeros((2, 16, 2, 96), dtype=torch.bfloat16,
                       device=cuda_device)
    table = torch.ones((1, 1), dtype=torch.int32, device=cuda_device)
    plen = torch.zeros((1,), dtype=torch.int32, device=cuda_device)
    assert ops._prefill_engine(torch.bfloat16, 96) == "simt"
    out = ops.paged_prefill_attention(q, q.clone(), q.clone(), pool, pool,
                                      table, plen)
    lib = build.library("paged_prefill_attention")
    rc = lib.launch(1, 1, q.data_ptr(), q.data_ptr(), q.data_ptr(),
                    pool.data_ptr(), pool.data_ptr(), table.data_ptr(),
                    plen.data_ptr(), out.data_ptr(), 1, 4, 2, 2, 96, 2, 16,
                    1, 1, torch.cuda.current_stream().cuda_stream)
    assert rc != 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_serving_wrappers_never_sync_with_the_host(cuda_device, dtype):
    """Neither wrapper reads a device value on the host: under
    ``set_sync_debug_mode("error")`` a synchronising call would raise.  And
    a sampling, preempting, chunking ``run_stream`` of a tiny engine in the
    same dtype, its adapter bank built beforehand, synchronises exactly
    once per sampler call (its one device-to-host transfer), so once a
    decode step."""
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

    import warnings
    from repro_torch.serve import sampling
    cfg_dtype = {torch.float32: "float32", torch.bfloat16: "bfloat16"}[dtype]
    eng, trace = _tiny_stream_engine(cuda_device, cfg_dtype)
    eng.run_stream(trace(), max_steps=400)          # build + warm up
    calls = []
    to_host = sampling.to_host

    def counted(*a):
        calls.append(1)
        return to_host(*a)
    eng, trace = _tiny_stream_engine(cuda_device, cfg_dtype)
    eng._banked_tree()      # the bank build reads device values, once
    sampling.to_host = counted
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            done = eng.run_stream(trace(), max_steps=400)
    finally:
        torch.cuda.set_sync_debug_mode(0)
        sampling.to_host = to_host
    syncs = [w for w in caught if "synchroniz" in str(w.message)]
    assert all(r.done for r in done) and eng.last_run_preemptions >= 1
    assert eng.last_run_stats["decode_steps"] > 0
    assert len(syncs) == len(calls) >= eng.last_run_stats["decode_steps"], (
        len(syncs), len(calls), [str(w.message)[:80] for w in syncs[:3]])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_spec_decode_syncs_once_per_draft_pass_and_accept(cuda_device,
                                                          dtype):
    """A speculating (k = 3), sampling, preempting, chunking ``run_stream``
    of a tiny engine: the draft loop keeps its tokens on the card, so the
    run synchronises once per draft pass (its drafted tokens) and once
    per sampler call (the accept draw, plain decode, prefill), never per
    draft step."""
    import warnings
    from repro_torch.serve import SpecConfig, sampling
    cfg_dtype = {torch.float32: "float32", torch.bfloat16: "bfloat16"}[dtype]
    spec = SpecConfig(k=3)
    eng, trace = _tiny_stream_engine(cuda_device, cfg_dtype, spec=spec)
    eng.run_stream(trace(), max_steps=400)          # build + warm up
    calls = []
    to_host = sampling.to_host

    def counted(*a):
        calls.append(1)
        return to_host(*a)
    eng, trace = _tiny_stream_engine(cuda_device, cfg_dtype, spec=spec)
    eng._banked_tree()      # the bank build reads device values, once
    sampling.to_host = counted
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            done = eng.run_stream(trace(), max_steps=400)
    finally:
        torch.cuda.set_sync_debug_mode(0)
        sampling.to_host = to_host
    syncs = [w for w in caught if "synchroniz" in str(w.message)]
    st = eng.last_run_stats
    assert all(r.done for r in done) and eng.kv.pages_in_use() == 0
    assert st["draft_passes"] == st["verify_calls"] > 0
    # draft steps outnumber draft passes: a per-step sync would show
    assert st["draft_steps"] > st["draft_passes"]
    assert len(syncs) == len(calls) + st["draft_passes"], (
        len(syncs), len(calls), st["draft_passes"],
        [str(w.message)[:80] for w in syncs[:3]])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("s", [2, 4, 5, 6])
def test_verify_shaped_prefill_matches_plain(cuda_device, dtype, tol, s):
    """The speculative verify's prefill: 8 rows of S = k + 1 window
    positions, G = 3, D = 128, over prefixes that are not page-aligned
    (the window's first page is the prefix's last where the prefix ends
    mid-page), each row's window KV written into its own pages first, as
    the model writes it.  bf16 on "mma", fp32 on "simt"."""
    from repro_torch.models import attention
    b, kh, g, hd, pg, maxp = 8, 2, 3, 128, 16, 8
    h, pages = g * kh, 1 + b * maxp
    rng = np.random.default_rng(100 + s)
    put = _on(cuda_device, dtype)
    table = put((rng.permutation(pages - 1) + 1).reshape(b, maxp).astype(
        np.int32))
    plen = rng.integers(1, maxp * pg - s, size=b)
    plen[:3] = (15, 16, 17)                 # before, at and past a seam
    plen = put(plen.astype(np.int32))
    q, k, v = (put(_normal(rng, (b, s, n, hd), sc))
               for n, sc in ((h, 1.0), (kh, 0.5), (kh, 0.5)))
    kp = put(_normal(rng, (pages, pg, kh, hd), 0.5))
    vp = put(_normal(rng, (pages, pg, kh, hd), 0.5))
    positions = plen.long()[:, None] + torch.arange(s, device=cuda_device)
    attention.paged_write(kp, k, table, positions)
    attention.paged_write(vp, v, table, positions)
    args = (q, k, v, kp, vp, table, plen)
    engine = "mma" if dtype == torch.bfloat16 else "simt"
    ops.reset_launches()
    got = ops.paged_prefill_attention(*args)
    torch.cuda.synchronize()
    assert ops.PREFILL_ENGINE_LAUNCHES[engine] == 1
    _close(got, ref.paged_prefill_attention(*args), tol)


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


def _tiny_stream_engine(device, dtype="float32", **kw):
    """A tiny engine with a tight pool (6 usable pages of 8) and prefill
    chunks of 5 (``kw`` adds engine arguments), and a trace factory: a big
    low-priority sampled request with logprobs, then deadlined
    high-priority arrivals on two adapters, greedy, sampled and stop rows
    (a quarter of the vocabulary stops them) behind a shared 16-token
    prefix."""
    from repro_torch.configs import get_config
    from repro_torch.models import model
    from repro_torch.serve import Request, SamplingParams, ServeEngine
    cfg = get_config("tiny").replace(dtype=dtype)
    params = model.init_params(cfg, seed=0, device="cpu")
    tuned = {**params, "layers": {**params["layers"], "attn": {
        name: {**lin, "q": lin["q"] + 0.05}
        for name, lin in params["layers"]["attn"].items()}}}
    put = (lambda t: {k: put(v) for k, v in t.items()}
           if isinstance(t, dict) else t.to(device))
    eng = ServeEngine(put(params), cfg, max_len=56, slots=2, page_size=8,
                      num_pages=7, prefill_chunk_tokens=5, device=device,
                      **kw)
    eng.register_adapter("tuned", put(tuned))
    vocab = cfg.vocab_size

    def trace():
        rng = np.random.default_rng(3)
        system = rng.integers(0, vocab, 16).astype(np.int32)
        out = [(1, Request(uid=0, prompt=(np.arange(30, dtype=np.int32) * 3
                                          + 1) % vocab, max_new_tokens=14,
                           sampling=SamplingParams(temperature=1.0,
                                                   top_p=0.9, seed=5,
                                                   logprobs=4)))]
        for i in range(6):
            sp = (None, SamplingParams(temperature=0.8, top_k=50,
                                       top_p=0.95, seed=40 + i),
                  SamplingParams(temperature=1.0, top_p=0.9, logprobs=4,
                                 stop_token_ids=range(0, vocab, 4)))[i % 3]
            out.append((3 + 2 * i, Request(
                uid=1 + i, prompt=np.concatenate(
                    [system, rng.integers(0, vocab, 3).astype(np.int32)]),
                max_new_tokens=5, priority=1, deadline=14.0,
                adapter=("base", "tuned")[i % 2], sampling=sp)))
        return out
    return eng, trace


def _stream_summary(eng, done):
    return dict(
        tokens={r.uid: list(r.generated) for r in done},
        reasons={r.uid: r.finish_reason for r in done},
        admissions=[(e.step, e.slot, e.uid, e.resumed, e.prefix_tokens)
                    for e in eng.admission_events],
        preemptions=[(e.step, e.slot, e.uid, e.resident_tokens)
                     for e in eng.preemption_events],
        kv=dict(eng.kv.stats))


@pytest.mark.cuda
def test_tiny_stream_card_matches_cpu(cuda_device):
    """The sampling, preempting, chunking trace on the card and on the CPU:
    identical tokens, finish reasons, admissions, preemptions and kv
    stats, logprobs within 1e-4."""
    out = {}
    for dev in ("cpu", cuda_device):
        eng, trace = _tiny_stream_engine(dev)
        done = eng.run_stream(trace(), max_steps=400)
        assert all(r.done for r in done) and eng.kv.pages_in_use() == 0
        out[str(dev)[:4]] = (_stream_summary(eng, done),
                             {r.uid: r.logprobs for r in done})
    (want, want_lp), (got, got_lp) = out["cpu"], out["cuda"]
    assert got == want
    assert want["preemptions"] and any(r == "stop" for r in
                                       want["reasons"].values())
    for uid, lps in want_lp.items():
        for a, b in zip(got_lp[uid], lps):
            assert (a.token, a.top_tokens) == (b.token, b.top_tokens)
            assert abs(a.logprob - b.logprob) <= 1e-4
            assert np.allclose(a.top_logprobs, b.top_logprobs, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("v", [1024, 128256])
def test_sampler_on_the_card_matches_the_cpu(cuda_device, v):
    """The sampler on CUDA tensors against the CPU sampler on the same
    logits and parameters: identical tokens and top ids, logprobs within
    1e-5; the all-greedy shortcut gives the argmax."""
    from repro_torch.serve import sampling
    rng = np.random.default_rng(v)
    b = 8
    logits = rng.normal(0, 3, (b, v)).astype(np.float32)
    temps = rng.uniform(0.3, 1.5, b).astype(np.float32)
    temps[:2] = 0.0
    ks = rng.integers(0, 129, b).astype(np.int32)
    ps = rng.uniform(0.3, 1.0, b).astype(np.float32)
    seeds = rng.integers(0, 2 ** 32, b).astype(np.int64)
    counters = rng.integers(0, 500, b).astype(np.int64)
    host = [torch.from_numpy(a) for a in (logits, temps, ks, ps, seeds,
                                          counters)]
    want = sampling.to_host(*sampling.sample_tokens(*host,
                                                    want_logprobs=True))
    got = sampling.to_host(*sampling.sample_tokens(
        *[t.to(cuda_device) for t in host], want_logprobs=True))
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got[3], want[3], rtol=0, atol=1e-5)
    greedy = sampling.sample_tokens(host[0].to(cuda_device), None, None,
                                    None, None, None, want_logprobs=False,
                                    greedy_only=True)[0]
    np.testing.assert_array_equal(greedy.cpu().numpy(), logits.argmax(-1))


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
@pytest.mark.parametrize("n_mat,r", [(1, 8), (3, 46), (28, 352), (2688, 32),
                                     (21504, 8), (2, 128), (4, 80)])
@pytest.mark.parametrize("terms", [0, 1, 5])
def test_cayley_kernel_matches_plain(cuda_device, n_mat, r, terms):
    """The test shapes, PSOFT's stack (28, 352, on "tc"), OFT's q stack
    (2688 blocks of 32) and BOFT's (21504 of 8), the largest "smem" r (four
    4 x 4 tiles a thread) and r = 80 (two); each launch on the engine
    :func:`ops._cayley_engine` names."""
    rng = np.random.default_rng(n_mat * r + terms)
    q = _normal(rng, (n_mat, r, r), 0.03)
    q = torch.from_numpy(q - q.transpose(0, 2, 1)).to(cuda_device)
    engine = ops._cayley_engine(r)
    assert engine == ("tc" if r == 352 else "smem")
    ops.reset_launches()
    rot, series = ops._cayley(q, terms)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["cayley_neumann"] == 1
    assert ops.CAYLEY_ENGINE_LAUNCHES[engine] == 1
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
@pytest.mark.parametrize("n_mat,r", [(3, 129), (2, 130), (1, 200),
                                     (2, 360)])
@pytest.mark.parametrize("terms", [1, 2, 5])
def test_cayley_tc_engine_at_any_r(cuda_device, n_mat, r, terms):
    """The "tc" engine at sizes that its 352 x 88 tiles do not divide
    (ragged edges zero-filled; 360 spills into a second row tile), two of
    them not a multiple of 4 (4-byte copies): R and the series at the fp32
    limit, K = 1 (R from S_1 in the first launch) included."""
    rng = np.random.default_rng(r + terms)
    q = _normal(rng, (n_mat, r, r), 0.03)
    q = torch.from_numpy(q - q.transpose(0, 2, 1)).to(cuda_device)
    assert ops._cayley_engine(r) == "tc"
    ops.reset_launches()
    rot, series = ops._cayley(q, terms)
    torch.cuda.synchronize()
    assert ops.CAYLEY_ENGINE_LAUNCHES == {"smem": 0, "tc": 1}
    want_rot, want_series = ref.cayley_neumann_series(q, terms)
    _close(rot, want_rot, 1e-4)
    _close(series, want_series, 1e-4)


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
#: (6) or do not divide 128 (48), d that is not a multiple of 128, b = 16,
#: and blocks above 128 (depth in chunks of 64, 128-column slices): 256 at
#: (64, 512) and at d = 3072, 512, 144 (a 16-column last slice and
#: chunk) and 136 (not a multiple of 16: "simt" in bf16 too); b = 64, 32
#: and 16 with a last column block short of groups
BLOCKDIAG_SHAPES = [(70, 256, 32), (128, 96, 8), (33, 64, 2),
                    (64, 256, 128), (50, 96, 6), (17, 192, 48),
                    (200, 3072, 32), (96, 256, 16), (64, 512, 256),
                    (130, 3072, 256), (33, 1024, 512), (20, 288, 144),
                    (20, 272, 136), (40, 320, 64), (50, 192, 32),
                    (30, 160, 16)]


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
    engine = ops._blockdiag_engine(dtype, rots.dtype, b, True)
    assert engine == ("mma" if dtype == rots.dtype == torch.bfloat16
                      and b % 16 == 0 else "simt")
    ops.reset_launches()
    got = ops.blockdiag_rotate(x, rots, transpose=transpose)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["blockdiag_rotate"] == 1
    assert ops.BLOCKDIAG_ENGINE_LAUNCHES[engine] == 1
    assert got.dtype == dtype and got.shape == x.shape
    _close(got, ref.blockdiag_rotate(x, rots, transpose), tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("b,transpose", [(32, False), (8, True), (2, False),
                                         (256, True), (256, False)])
def test_blockdiag_rotate_grads_match_autograd_of_plain(cuda_device, dtype,
                                                        tol, b, transpose):
    rng = np.random.default_rng(b)
    put = _on(cuda_device, dtype)
    d = max(128, 2 * b)
    x = put(_normal(rng, (96, d)))
    rots = torch.from_numpy(np.eye(b, dtype=np.float32)
                            + _normal(rng, (d // b, b, b), 0.2)
                            ).to(cuda_device).to(dtype)
    dy = put(_normal(rng, (96, d)))
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
    """Rotations that do not tile d, or in a third dtype, are refused;
    blocks above 128 are taken (both engines walk their depth in
    chunks)."""
    rng = np.random.default_rng(7)
    x = torch.from_numpy(_normal(rng, (4, 512))).to(cuda_device)
    big = torch.from_numpy(np.eye(256, dtype=np.float32)
                           + _normal(rng, (2, 256, 256), 0.05)
                           ).to(cuda_device)
    for rots in (big, big.to(torch.bfloat16)):
        xx = x.to(rots.dtype)
        _close(ops.blockdiag_rotate(xx, rots),
               ref.blockdiag_rotate(xx, rots), dict(DTYPES)[rots.dtype])
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


def _ulp_up(t: torch.Tensor) -> torch.Tensor:
    """Every element one ulp further from zero (its bit pattern plus
    one)."""
    bits = {torch.float32: torch.int32, torch.bfloat16: torch.int16}[t.dtype]
    return (t.contiguous().view(bits) + 1).view(t.dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k,n,r_old,r_new", [(3072, 1024, 352, 384),
                                             (512, 256, 8, 16),
                                             (1024, 3072, 40, 72)])
def test_bank_extension_keeps_old_rows_bit_equal(cuda_device, dtype, k, n,
                                                 r_old, r_new):
    """The hot-swap exactness contract on the card: a decode-shaped
    banked linear's rows on old columns are bit-equal before and after the
    bank grows by one column, by a column of higher rank (zero-padded
    ranks, more r slices in the gather-delta plan) and by a dense column
    (a mixed bank); the new column's rows match the plain version.  One
    ulp planted on an old column (``right`` in fp32, ``left`` in bf16,
    where an fp32 ulp of ``right`` is below the output's rounding) breaks
    the equality of that column's rows and of no other."""
    from repro_torch.core import registry
    rng = np.random.default_rng(k + r_old)
    a, b = 3, 8
    put = _on(cuda_device, torch.float32)
    w = put(_normal(rng, (k, n), k ** -0.5)).to(dtype)
    bank = {"left": put(_normal(rng, (a, k, r_old), k ** -0.5)).to(dtype),
            "right": put(_normal(rng, (a, r_old, n), 0.05))}
    x = put(_normal(rng, (b, 1, k))).to(dtype)
    ids = torch.tensor([0, 1, 2, 0, 1, 2, 1, 0], dtype=torch.int32,
                       device=cuda_device)
    before = ops.LAUNCHES["gather_delta_matmul"]
    y0 = registry.apply_batched({"w": w, "bank": bank}, x, dtype, ids)
    grown = {
        "column": {"left": put(_normal(rng, (1, k, r_old), k ** -0.5)),
                   "right": put(_normal(rng, (1, r_old, n), 0.05))},
        "rank": {"left": put(_normal(rng, (1, k, r_new), k ** -0.5)),
                 "right": put(_normal(rng, (1, r_new, n), 0.05))},
        "dense": {"delta": put(_normal(rng, (1, k, n), 0.01))}}
    new_ids = torch.full((b,), a, dtype=torch.int32, device=cuda_device)
    for name, sub in grown.items():
        if "left" in sub:
            sub["left"] = sub["left"].to(dtype)
        ext = registry.extend_bank(w, bank, sub, a)
        assert ext["left"].shape[0] == a + 1
        assert ("delta" in ext) == (name == "dense")
        y = registry.apply_batched({"w": w, "bank": ext}, x, dtype, ids)
        assert torch.equal(y, y0), name
        got = registry.apply_batched({"w": w, "bank": ext}, x, dtype,
                                     new_ids)
        plain = registry.apply_batched(
            {"w": w.cpu(), "bank": {kk: v.cpu() for kk, v in ext.items()}},
            x.cpu(), dtype, new_ids.cpu())
        _close(got.cpu()[:, 0], plain[:, 0], dict(DTYPES)[dtype])
    assert ops.LAUNCHES["gather_delta_matmul"] == before + 7
    bad = dict(bank)
    key = "right" if dtype == torch.float32 else "left"
    bad[key] = bank[key].clone()
    bad[key][1] = _ulp_up(bank[key][1])
    y = registry.apply_batched({"w": w, "bank": bad}, x, dtype, ids)
    on1 = ids == 1
    assert not torch.equal(y[on1], y0[on1]), "a planted ulp went unseen"
    assert torch.equal(y[~on1], y0[~on1])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("k,n,r", [(3072, 3072, 352), (256, 384, 8)])
def test_mixed_bank_decode_matches_plain(cuda_device, dtype, tol, k, n, r):
    """A decode row on a mixed bank takes the gather-delta kernel over
    left and right plus the dense term of its column: every column's rows
    against the whole banked linear on the CPU (the plain versions)."""
    from repro_torch.core import registry
    rng = np.random.default_rng(n + r)
    put = _on(cuda_device, torch.float32)
    w = put(_normal(rng, (k, n), k ** -0.5))
    lowrank = {"left": put(_normal(rng, (2, k, r), k ** -0.5)),
               "right": put(_normal(rng, (2, r, n), 0.05))}
    mixed = registry.extend_bank(
        w, lowrank, {"delta": put(_normal(rng, (2, k, n), 0.02))}, 2)
    mixed["left"] = mixed["left"].to(dtype)
    node = {"w": w.to(dtype), "bank": mixed}
    x = put(_normal(rng, (8, 1, k))).to(dtype)
    ids = torch.tensor([0, 1, 2, 3, 3, 2, 1, 0], dtype=torch.int32,
                       device=cuda_device)
    before = ops.LAUNCHES["gather_delta_matmul"]
    got = registry.apply_batched(node, x, dtype, ids)
    assert ops.LAUNCHES["gather_delta_matmul"] == before + 1
    plain = registry.apply_batched(
        {"w": node["w"].cpu(),
         "bank": {key: v.cpu() for key, v in mixed.items()}},
        x.cpu(), dtype, ids.cpu())
    _close(got.cpu()[:, 0], plain[:, 0], tol)
    dense = (x[4, 0].float() @ (w + mixed["delta"][3])).to(dtype)
    _close(got[4, 0].cpu(), dense.cpu(), tol)


# ---------------------------------------------------------------------------
# the MoE family: grouped psoft_matmul and deepseek-moe-16b's shapes
# ---------------------------------------------------------------------------

def _stack_inputs(rng, device, dtype, g, m, k, n, r, transpose=False):
    """An expert stack of G linears at :func:`_psoft_inputs`' scales, every
    array leading with G."""
    parts = [_psoft_inputs(rng, _on(device, dtype), m, k, n, r, transpose)
             for _ in range(g)]
    return tuple(torch.stack(arrays) for arrays in zip(*parts))


GROUPED_SHAPES = [(3, 100, 200, 136, 64), (3, 37, 96, 40, 12),
                  (2, 130, 72, 200, 8), (64, 240, 2048, 1408, 64),
                  (64, 240, 1408, 2048, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("g,m,k,n,r", GROUPED_SHAPES)
@pytest.mark.parametrize("transpose", [False, True])
def test_grouped_psoft_matmul_matches_plain(cuda_device, dtype, tol, g, m, k,
                                            n, r, transpose):
    """One grouped launch per expert stack (M not a multiple of 64, G 3,
    the wmma engine at r 12, deepseek-moe-16b's two stacks): y, u and t
    against the plain version, each expert also against the 2-D call on
    its own slices, and no expert's rows touched by another's tile."""
    rng = np.random.default_rng(g * m + k + n + r)
    args = _stack_inputs(rng, cuda_device, dtype, g, m, k, n, r, transpose)
    ops.reset_launches()
    got = ops._psoft_mm(*args, transpose)
    torch.cuda.synchronize()
    engine = "simt" if dtype == torch.float32 else \
        ("wgmma" if r % 8 == 0 and k % 8 == 0 and n % 8 == 0 else "wmma")
    assert ops.PSOFT_ENGINE_LAUNCHES[engine] == 1 == \
        ops.PSOFT_GROUPED_LAUNCHES[engine] == ops.LAUNCHES["psoft_matmul"]
    want = ref.psoft_matmul_parts(*args, transpose)
    assert got[0].shape == (g, m, k if transpose else n)
    _close(got[0], want[0], tol)
    for gv, wv in zip(got[1:], want[1:]):
        rms = float(wv.square().mean().sqrt())
        torch.testing.assert_close(gv, wv, rtol=1e-4, atol=1e-4 * rms)
    if g <= 3:
        for e in range(g):
            one = ops._psoft_mm(*(a[e].contiguous() for a in args),
                                transpose)[0]
            _close(got[0][e], one, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("g,m,k,n,r", [(3, 100, 200, 136, 64),
                                       (4, 240, 256, 192, 64)])
def test_grouped_psoft_matmul_grads_match_autograd_of_plain(
        cuda_device, dtype, tol, g, m, k, n, r):
    """Every grad of the autograd function on an expert stack (the r-sized
    grads as batched products over G) against autograd of the plain
    version in fp32 on the same values."""
    rng = np.random.default_rng(g + m + r)
    args = _stack_inputs(rng, cuda_device, dtype, g, m, k, n, r)
    dy = torch.from_numpy(_normal(rng, (g, m, n))).to(cuda_device).to(dtype)
    leaves = [a.detach().clone().requires_grad_(True) for a in args]
    twins = [a.detach().float().requires_grad_(True) for a in args]
    ops.reset_launches()
    y = ops.psoft_matmul(*leaves)
    got = torch.autograd.grad(y, leaves, dy)
    torch.cuda.synchronize()
    assert sum(ops.PSOFT_GROUPED_LAUNCHES.values()) == 2
    want = torch.autograd.grad(ref.psoft_matmul(*twins), twins, dy.float())
    for gv, wv, leaf in zip(got, want, leaves):
        assert gv.dtype == leaf.dtype and gv.shape == leaf.shape
        _close(gv, wv, tol)


@pytest.mark.cuda
def test_cayley_kernel_at_the_expert_stack(cuda_device):
    """deepseek-moe-16b's expert stack: 28 layers x 64 experts of r = 64,
    one launch on "smem"."""
    rng = np.random.default_rng(64)
    q = _normal(rng, (1792, 64, 64), 0.03)
    q = torch.from_numpy(q - q.transpose(0, 2, 1)).to(cuda_device)
    ops.reset_launches()
    rot, series = ops._cayley(q, 5)
    torch.cuda.synchronize()
    assert ops.CAYLEY_ENGINE_LAUNCHES == {"smem": 1, "tc": 0}
    want, want_series = ref.cayley_neumann_series(q, 5)
    torch.testing.assert_close(rot, want, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(series, want_series, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", DTYPES)
def test_serving_kernels_at_deepseek_shapes(cuda_device, dtype, tol):
    """gather-delta at K = N = 2048, r 64, B 8 over 3 adapters; paged
    decode and prefill at 16 heads over 16 KV heads, D 128 (prefill on
    "mma" in bf16)."""
    rng = np.random.default_rng(16)
    put = _on(cuda_device, dtype)
    x = put(_normal(rng, (8, 2048)))
    w = put(_normal(rng, (2048, 2048), 2048 ** -0.5))
    left = put(_normal(rng, (3, 2048, 64), 2048 ** -0.5))
    right = _on(cuda_device, torch.float32)(_normal(rng, (3, 64, 2048), 0.01))
    ids = torch.tensor([0, 1, 2, 1, 0, 2, 2, 1], dtype=torch.int32,
                       device=cuda_device)
    _close(ops.gather_delta_matmul(x, w, left, right, ids,
                                   compute_dtype=dtype),
           ref.gather_delta_matmul(ids, x, w, left, right), tol)
    pages, pg, maxp = 257, 16, 32
    table = torch.from_numpy(rng.permutation(pages - 1)[:8 * maxp].reshape(
        8, maxp).astype(np.int32) + 1).to(cuda_device)
    lengths = torch.tensor([0, 1, 77, 130, 256, 300, 511, 45],
                           dtype=torch.int32, device=cuda_device)
    kp = put(_normal(rng, (pages, pg, 16, 128), 0.5))
    vp = put(_normal(rng, (pages, pg, 16, 128), 0.5))
    q = put(_normal(rng, (8, 16, 128)))
    _close(ops.paged_decode_attention(q, kp, vp, table, lengths),
           ref.paged_decode_attention(q, kp, vp, table, lengths), tol)
    qs = put(_normal(rng, (4, 64, 16, 128)))
    ks = put(_normal(rng, (4, 64, 16, 128), 0.5))
    vs = put(_normal(rng, (4, 64, 16, 128), 0.5))
    plen = torch.tensor([32, 0, 45, 32], dtype=torch.int32,
                        device=cuda_device)
    ops.reset_launches()
    got = ops.paged_prefill_attention(qs, ks, vs, kp, vp, table[:4], plen)
    torch.cuda.synchronize()
    engine = "mma" if dtype == torch.bfloat16 else "simt"
    assert ops.PREFILL_ENGINE_LAUNCHES[engine] == 1
    _close(got, ref.paged_prefill_attention(qs, ks, vs, kp, vp, table[:4],
                                            plen), tol)


@pytest.mark.cuda
@pytest.mark.parametrize("impl", ["capacity", "dense"])
def test_moe_layer_on_the_card_matches_the_cpu(cuda_device, impl):
    """A reduced deepseek-moe-16b MoE layer (fp32, PSOFT expert stacks,
    a shared expert) with capacity 0.25 (drops) and with the dense
    dispatch: the card's output and aux against the CPU's, the expert
    stacks on grouped launches."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import model, moe
    cfg = get_config("deepseek-moe-16b").reduced()
    cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=0.25))
    params = model.init_params(cfg, seed=0, device="cpu")
    layer = {k: {kk: (vv[0] if not isinstance(vv, dict) else
                      {a: b[0] for a, b in vv.items()})
                 for kk, vv in v.items()}
             for k, v in params["layers"]["moe"].items()}
    x = torch.from_numpy(_normal(np.random.default_rng(1),
                                 (4, 32, cfg.d_model)))

    def on(tree, dev):
        if isinstance(tree, dict):
            return {k: on(v, dev) for k, v in tree.items()}
        return tree.to(dev)
    want, want_aux = moe.moe_apply(layer, x, cfg, torch.float32, impl)
    ops.reset_launches()
    got, aux = moe.moe_apply(on(layer, cuda_device), x.to(cuda_device), cfg,
                             torch.float32, impl)
    torch.cuda.synchronize()
    assert ops.PSOFT_GROUPED_LAUNCHES["simt"] == 3
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    assert abs(float(aux) - float(want_aux)) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("b,h,kh,d,max_len", [(8, 32, 32, 64, 512),
                                              (3, 8, 2, 16, 40),
                                              (2, 4, 4, 64, 45)])
def test_dense_view_decode_matches_plain(cuda_device, dtype, tol, b, h, kh,
                                         d, max_len):
    """The dense cache's decode on the card: the paged-decode kernel over
    the buffers viewed as pages (zamba2's 32 over 32 heads of 64 at
    max_len 512, pages of 16; a GQA case at pages of 8; an odd max_len at
    pages of 1) against the plain ``decode_attention``, one launch."""
    from repro_torch.models import attention
    rng = np.random.default_rng(b * h + max_len)
    put = _on(cuda_device, dtype)
    q = put(_normal(rng, (b, 1, h, d)))
    kb = put(_normal(rng, (b, max_len, kh, d), 0.5))
    vb = put(_normal(rng, (b, max_len, kh, d), 0.5))
    lengths = torch.from_numpy(rng.integers(1, max_len + 1, b).astype(
        np.int32)).to(cuda_device)
    lengths[-1] = max_len
    table = attention.dense_view_table(b, max_len, cuda_device)
    assert table.shape == (b, max_len // attention.dense_page_size(max_len))
    ops.reset_launches()
    got = attention.dense_decode_attention(q, kb, vb, lengths, table)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["paged_decode_attention"] == 1
    _close(got, attention.decode_attention(q, kb, vb, lengths), tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("n", [8512, 8384])
@pytest.mark.parametrize("transpose", [False, True])
def test_psoft_matmul_at_the_recurrent_in_proj(cuda_device, dtype, tol, n,
                                               transpose):
    """psoft_matmul at mamba2's (N 8512) and zamba2's (N 8384) in_proj, K
    2048, r 64, M 256: N is no multiple of 128, so the wgmma engine's last
    column tile is half full; against the plain version."""
    rng = np.random.default_rng(n + transpose)
    args = _psoft_inputs(rng, _on(cuda_device, dtype), 256, 2048, n, 64,
                         transpose)
    ops.reset_launches()
    got = ops._psoft_mm(*args, transpose)
    torch.cuda.synchronize()
    engine = "simt" if dtype == torch.float32 else "wgmma"
    assert ops.PSOFT_ENGINE_LAUNCHES[engine] == 1
    want = ref.psoft_matmul_parts(*args, transpose)
    _close(got[0], want[0], tol)
    _close(got[0][:, -64:], want[0][:, -64:], tol)
    for gv, wv in zip(got[1:], want[1:]):
        rms = float(wv.square().mean().sqrt())
        torch.testing.assert_close(gv, wv, rtol=1e-4, atol=1e-4 * rms)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("k,n", [(2048, 8512), (2048, 8384), (4096, 2048)])
def test_gather_delta_at_the_recurrent_widths(cuda_device, dtype, tol, k, n):
    """gather_delta_matmul at the recurrent families' in_proj (N 8512,
    8384) and out_proj (K 4096, N 2048), r 64, B 8 over 3 adapters."""
    rng = np.random.default_rng(k + n)
    put = _on(cuda_device, dtype)
    x = put(_normal(rng, (8, k)))
    w = put(_normal(rng, (k, n), k ** -0.5))
    left = put(_normal(rng, (3, k, 64), k ** -0.5))
    right = _on(cuda_device, torch.float32)(_normal(rng, (3, 64, n), 0.01))
    ids = torch.tensor([0, 1, 2, 1, 0, 2, 2, 1], dtype=torch.int32,
                       device=cuda_device)
    got = ops.gather_delta_matmul(x, w, left, right, ids, compute_dtype=dtype)
    want = ref.gather_delta_matmul(ids, x, w, left, right)
    _close(got, want, tol)
    _close(got[:, -64:], want[:, -64:], tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("mixed", [False, True])
def test_two_d_decode_input_reaches_the_kernel(cuda_device, dtype, tol,
                                               mixed):
    """A Mamba2 decode's 2-D (B, d_in) rows on a low-rank bank go through
    the gather-delta kernel (one launch), and a mixed bank keeps its dense
    term; against the plain version."""
    from repro_torch.core import registry
    rng = np.random.default_rng(2 + mixed)
    put = _on(cuda_device, dtype)
    f32 = _on(cuda_device, torch.float32)
    x = put(_normal(rng, (5, 256)))
    bank = {"left": put(_normal(rng, (3, 256, 16), 256 ** -0.5)),
            "right": f32(_normal(rng, (3, 16, 384), 0.01))}
    if mixed:
        bank["delta"] = f32(_normal(rng, (3, 256, 384), 0.01))
    lin = {"w": put(_normal(rng, (256, 384), 256 ** -0.5)), "bank": bank}
    ids = torch.tensor([0, 2, 1, 2, 0], dtype=torch.int32,
                       device=cuda_device)
    ops.reset_launches()
    got = registry.apply_batched(lin, x, dtype, ids)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["gather_delta_matmul"] == 1
    assert got.shape == (5, 384)
    cpu = {"w": lin["w"].cpu(), "bank": {k: v.cpu() for k, v in
                                         bank.items()}}
    want = registry.apply_batched(cpu, x.cpu(), dtype, ids.cpu())
    _close(got.cpu(), want, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["mamba2-1.3b", "zamba2-1.2b"])
def test_recurrent_dense_engine_on_the_card_matches_the_cpu(cuda_device,
                                                            arch):
    """Reduced mamba2 / zamba2 (fp32) on the dense-cache engine, base and
    one PSOFT adapter: the card gives the CPU's greedy tokens, its decode
    through gather_delta_matmul (and, for the hybrid, the paged-decode
    kernel over the dense view)."""
    from repro_torch import serve
    from repro_torch.configs import get_config
    from repro_torch.models import model
    from repro_torch.tree import tree_map
    cfg = get_config(arch).reduced()
    params = model.init_params(cfg, seed=0, device="cpu")
    tuned = tree_map(lambda t: t, params)
    for lay in (tuned["layers"] if isinstance(tuned["layers"], list)
                else [tuned["layers"]]):
        if "ssm" in lay:
            lay["ssm"]["in_proj"]["q"] = lay["ssm"]["in_proj"]["q"] + 0.05
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (5, 17, 32, 9)]
    out = {}
    for dev in ("cpu", cuda_device):
        move = (lambda t: tree_map(lambda x: x.to(dev), t))
        eng = serve.ServeEngine(move(params), cfg, max_len=64, slots=2,
                                device=dev)
        eng.register_adapter("tuned", move(tuned))
        ops.reset_launches()
        done = eng.run([serve.Request(uid=i, prompt=p, max_new_tokens=6,
                                      adapter="tuned" if i % 2 else "base")
                        for i, p in enumerate(prompts)])
        out[str(dev)] = {r.uid: r.generated for r in done}
    assert eng.cache_mode == "dense"
    assert ops.LAUNCHES["gather_delta_matmul"] > 0
    assert (ops.LAUNCHES["paged_decode_attention"] > 0) == \
        (cfg.family == "hybrid")
    assert out["cuda"] == out["cpu"]


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["mamba2-1.3b", "zamba2-1.2b"])
def test_recurrent_prefill_and_decode_never_sync(cuda_device, arch):
    """The dense-cache prefill (the SSD scan) and decode step of reduced
    mamba2 / zamba2 on a merged serving tree read no device value on the
    host: under ``set_sync_debug_mode("error")`` a synchronising call
    would raise."""
    from repro_torch.configs import PEFTConfig, get_config
    from repro_torch.core import peft
    from repro_torch.models import attention, model
    cfg = get_config(arch).reduced()
    params = peft.merge_tree(model.init_params(cfg, seed=0,
                                               device=cuda_device), cfg.peft)
    cfg = cfg.replace(peft=PEFTConfig(method="none", target_modules=()))
    toks = torch.randint(0, cfg.vocab_size, (2, 32), device=cuda_device)
    lengths = torch.full((2,), 32, dtype=torch.long, device=cuda_device)
    step = torch.randint(0, cfg.vocab_size, (2, 1), device=cuda_device)
    table = attention.dense_view_table(2, 64, cuda_device)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        logits, cache = model.prefill(params, {"tokens": toks}, cfg, 64,
                                      lengths)
        nxt, cache = model.decode_step(params, {"tokens": step}, cache,
                                       lengths, cfg, view_table=table)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert torch.isfinite(logits).all() and torch.isfinite(nxt).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", DTYPES)
def test_paged_attention_at_internvl2_heads(cuda_device, dtype, tol):
    """Paged decode and prefill at internvl2-26b's 48 heads over 8 KV
    heads of 128 (GQA group 6; prefill on "mma" in bf16)."""
    rng = np.random.default_rng(48)
    put = _on(cuda_device, dtype)
    pages, pg, maxp = 257, 16, 32
    table = torch.from_numpy(rng.permutation(pages - 1)[:8 * maxp].reshape(
        8, maxp).astype(np.int32) + 1).to(cuda_device)
    lengths = torch.tensor([0, 1, 77, 130, 256, 300, 511, 45],
                           dtype=torch.int32, device=cuda_device)
    kp = put(_normal(rng, (pages, pg, 8, 128), 0.5))
    vp = put(_normal(rng, (pages, pg, 8, 128), 0.5))
    q = put(_normal(rng, (8, 48, 128)))
    _close(ops.paged_decode_attention(q, kp, vp, table, lengths),
           ref.paged_decode_attention(q, kp, vp, table, lengths), tol)
    qs = put(_normal(rng, (4, 64, 48, 128)))
    ks = put(_normal(rng, (4, 64, 8, 128), 0.5))
    vs = put(_normal(rng, (4, 64, 8, 128), 0.5))
    plen = torch.tensor([32, 0, 45, 32], dtype=torch.int32,
                        device=cuda_device)
    ops.reset_launches()
    got = ops.paged_prefill_attention(qs, ks, vs, kp, vp, table[:4], plen)
    torch.cuda.synchronize()
    engine = "mma" if dtype == torch.bfloat16 else "simt"
    assert ops.PREFILL_ENGINE_LAUNCHES[engine] == 1
    _close(got, ref.paged_prefill_attention(qs, ks, vs, kp, vp, table[:4],
                                            plen), tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("frames", [250, 251])
def test_cross_view_at_odd_source_lengths(cuda_device, dtype, tol, frames):
    """The audio decode's cross-attention at seamless-m4t-medium's 16 heads
    of 64: ``model.cross_cache`` pads the cross K/V to 256 rows, which the
    paged-decode kernel reads as pages of 16 up to the true length; against
    the plain ``decode_attention`` over the unpadded K/V, one launch."""
    from repro_torch.configs import PEFTConfig, get_config
    from repro_torch.models import attention, model
    dname = "float32" if dtype == torch.float32 else "bfloat16"
    cfg = get_config("seamless-m4t-medium", num_layers=1, dtype=dname,
                     peft=PEFTConfig(method="none", target_modules=()))
    rng = np.random.default_rng(frames)
    put = _on(cuda_device, dtype)
    lin = {n: {"w": put(_normal(rng, (1, 1024, 1024), 1024 ** -0.5))}
           for n in ("k", "v")}
    enc = put(_normal(rng, (4, frames, 1024)))
    cross = model.cross_cache({"layers": {"cross": lin}}, enc, cfg)
    assert cross["k"].shape == (1, 4, 256, 16, 64)
    assert cross["len"].tolist() == [frames] * 4
    k, v = model.cross_kv({n: {"w": w["w"][0]} for n, w in lin.items()},
                          enc, cfg, dtype)
    q = put(_normal(rng, (4, 1, 16, 64)))
    table = attention.dense_view_table(4, 256, cuda_device)
    assert table.shape == (4, 16)
    ops.reset_launches()
    got = attention.dense_decode_attention(q, cross["k"][0], cross["v"][0],
                                           cross["len"], table)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["paged_decode_attention"] == 1
    _close(got, attention.decode_attention(q, k, v, cross["len"]), tol)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,r", [(256, 6144, 16384, 128),
                                     (256, 16384, 6144, 128),
                                     (256, 1024, 4096, 48),
                                     (256, 4096, 1024, 48)])
@pytest.mark.parametrize("transpose", [False, True])
def test_psoft_matmul_at_the_vlm_and_audio_linears(cuda_device, m, k, n, r,
                                                   transpose):
    """The wgmma engine at internvl2-26b's gate/up and down (K or N 16384,
    r 128) and seamless-m4t-medium's MLP (r 48, a 96-byte row): y in bf16,
    u and t in fp32, against the plain version."""
    rng = np.random.default_rng(k + n + r + transpose)
    args = _psoft_inputs(rng, _on(cuda_device, torch.bfloat16), m, k, n, r,
                         transpose)
    ops.reset_launches()
    got = ops._psoft_mm(*args, transpose)
    torch.cuda.synchronize()
    assert ops.PSOFT_ENGINE_LAUNCHES == {"wgmma": 1, "wmma": 0, "simt": 0}
    want = ref.psoft_matmul_parts(*args, transpose)
    _close(got[0], want[0], 2e-2)
    for g, w in zip(got[1:], want[1:]):
        rms = float(w.square().mean().sqrt())
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4 * rms)


@pytest.mark.cuda
@pytest.mark.parametrize("k,n,r", [(6144, 16384, 128), (1024, 4096, 48)])
def test_psoft_matmul_grads_at_the_vlm_and_audio_linears(cuda_device, k, n,
                                                         r):
    """Every grad of the autograd function (forward and the transposed dx
    launch on wgmma) at internvl2-26b's gate/up and seamless-m4t-medium's
    up, against autograd of the plain version in fp32."""
    rng = np.random.default_rng(k + r)
    args = _psoft_inputs(rng, _on(cuda_device, torch.bfloat16), 128, k, n, r)
    dy = _on(cuda_device, torch.bfloat16)(_normal(rng, (128, n)))
    leaves = [a.detach().clone().requires_grad_(True) for a in args]
    twins = [a.detach().float().requires_grad_(True) for a in args]
    ops.reset_launches()
    y = ops.psoft_matmul(*leaves)
    got = torch.autograd.grad(y, leaves, dy)
    torch.cuda.synchronize()
    assert ops.PSOFT_ENGINE_LAUNCHES == {"wgmma": 2, "wmma": 0, "simt": 0}
    want = torch.autograd.grad(ref.psoft_matmul(*twins), twins, dy.float())
    for g, w, leaf in zip(got, want, leaves):
        assert g.dtype == leaf.dtype
        _close(g, w, 2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", DTYPES)
def test_gather_delta_at_internvl2_gate_up(cuda_device, dtype, tol):
    """gather_delta_matmul at internvl2-26b's gate/up (K 6144, N 16384),
    r 128, B 8 over 3 adapters."""
    rng = np.random.default_rng(6144)
    put = _on(cuda_device, dtype)
    x = put(_normal(rng, (8, 6144)))
    w = put(_normal(rng, (6144, 16384), 6144 ** -0.5))
    left = put(_normal(rng, (3, 6144, 128), 6144 ** -0.5))
    right = _on(cuda_device, torch.float32)(_normal(rng, (3, 128, 16384),
                                                    0.01))
    ids = torch.tensor([0, 1, 2, 1, 0, 2, 2, 1], dtype=torch.int32,
                       device=cuda_device)
    _close(ops.gather_delta_matmul(x, w, left, right, ids,
                                   compute_dtype=dtype),
           ref.gather_delta_matmul(ids, x, w, left, right), tol)


@pytest.mark.cuda
@pytest.mark.parametrize("n_mat,r", [(48, 128), (12, 48)])
def test_cayley_kernel_at_the_vlm_and_audio_stacks(cuda_device, n_mat, r):
    """internvl2-26b's PSOFT stacks (48 layers of r 128) and
    seamless-m4t-medium's (12 of r 48): one launch on "smem"."""
    rng = np.random.default_rng(n_mat * r)
    q = _normal(rng, (n_mat, r, r), 0.03)
    q = torch.from_numpy(q - q.transpose(0, 2, 1)).to(cuda_device)
    ops.reset_launches()
    rot, series = ops._cayley(q, 5)
    torch.cuda.synchronize()
    assert ops.CAYLEY_ENGINE_LAUNCHES == {"smem": 1, "tc": 0}
    want, want_series = ref.cayley_neumann_series(q, 5)
    torch.testing.assert_close(rot, want, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(series, want_series, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["internvl2-26b", "seamless-m4t-medium"])
def test_vlm_and_audio_generation_on_the_card_matches_the_cpu(cuda_device,
                                                              arch):
    """Reduced fp32 models, PSOFT merged: ``prefill`` (8 patch embeddings
    in front, or a 21-frame source with right-padded prompts) and 3
    ``decode_step``s on the card against the CPU, within 1e-4; one
    paged_decode_attention per layer a step, two for the encoder-decoder
    (self and cross)."""
    from repro_torch.configs import PEFTConfig, get_config
    from repro_torch.core import peft
    from repro_torch.models import model
    from repro_torch.tree import tree_map
    cfg = get_config(arch).reduced()
    params = peft.merge_tree(model.init_params(cfg, seed=0, device="cpu"),
                             cfg.peft)
    cfg = cfg.replace(peft=PEFTConfig(method="none", target_modules=()))
    rng = np.random.default_rng(3)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                                     (3, 9)))}
    if cfg.family == "vlm":
        batch["patch_embeds"] = torch.from_numpy(_normal(rng, (3, 8, 64)))
        lengths = torch.full((3,), 17, dtype=torch.long)
    else:
        batch["src_embeds"] = torch.from_numpy(_normal(rng, (3, 21, 64)))
        lengths = torch.tensor([9, 4, 6])
    outs = {}
    for dev in ("cpu", cuda_device):
        move = (lambda t: tree_map(lambda x: x.to(dev), t))
        p = move(params)
        ops.reset_launches()
        with torch.no_grad():
            logits, cache = model.prefill(p, move(batch), cfg, 32,
                                          lengths.to(dev))
            got = [logits.cpu()]
            for t in range(3):
                tok = torch.full((3, 1), 7 + t, device=dev)
                logits, cache = model.decode_step(
                    p, {"tokens": tok}, cache, lengths.to(dev) + t, cfg)
                got.append(logits.cpu())
        outs[str(dev)] = got
    per_layer = 1 if cfg.family == "vlm" else 2
    assert ops.LAUNCHES["paged_decode_attention"] == \
        3 * per_layer * cfg.num_layers
    for g, w in zip(outs["cuda"], outs["cpu"]):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("k,n", [(24576, 6144), (6144, 24576)])
def test_gather_delta_at_the_zoo_widths(cuda_device, dtype, tol, k, n):
    """gather_delta_matmul at starcoder2-15b's and nemotron-4-15b's down
    (K 24576: the split-K plan's widest) and up, r 128, B 8 over 3
    adapters."""
    rng = np.random.default_rng(k)
    put = _on(cuda_device, dtype)
    x = put(_normal(rng, (8, k)))
    w = put(_normal(rng, (k, n), k ** -0.5))
    left = put(_normal(rng, (3, k, 128), k ** -0.5))
    right = _on(cuda_device, torch.float32)(_normal(rng, (3, 128, n), 0.01))
    ids = torch.tensor([0, 1, 2, 1, 0, 2, 2, 1], dtype=torch.int32,
                       device=cuda_device)
    _close(ops.gather_delta_matmul(x, w, left, right, ids,
                                   compute_dtype=dtype),
           ref.gather_delta_matmul(ids, x, w, left, right), tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", DTYPES)
def test_attention_kernels_at_gqa_group_12(cuda_device, dtype, tol):
    """Paged decode and prefill at starcoder2-15b's 48 query heads over 4
    KV heads of 128 (the prefill's flattened (position, group) rows end
    mid-position in a tile): against the plain versions."""
    rng = np.random.default_rng(12)
    put = _on(cuda_device, dtype)
    pages, pg, kh, d, h = 65, 16, 4, 128, 48
    kp = put(_normal(rng, (pages, pg, kh, d), 0.5))
    vp = put(_normal(rng, (pages, pg, kh, d), 0.5))
    table = torch.from_numpy(rng.permutation(pages - 1)[:64].reshape(4, 16)
                             + 1).to(torch.int32).to(cuda_device)
    ln = torch.tensor([1, 77, 200, 256], dtype=torch.int32,
                      device=cuda_device)
    q = put(_normal(rng, (4, h, d)))
    _close(ops.paged_decode_attention(q, kp, vp, table, ln),
           ref.paged_decode_attention(q, kp, vp, table, ln), tol)
    qs = put(_normal(rng, (4, 21, h, d)))
    ks = put(_normal(rng, (4, 21, kh, d), 0.5))
    vs = put(_normal(rng, (4, 21, kh, d), 0.5))
    plen = torch.tensor([0, 16, 45, 100], dtype=torch.int32,
                        device=cuda_device)
    _close(ops.paged_prefill_attention(qs, ks, vs, kp, vp, table, plen),
           ref.paged_prefill_attention(qs, ks, vs, kp, vp, table, plen), tol)


@pytest.mark.cuda
def test_minimal_remat_launches_psoft_twice_per_linear(cuda_device):
    """A tiny PSOFT train step on the card under each remat policy:
    psoft_matmul 2 calls per linear under "none" and "minimal" (the kept
    forward is not launched again), 3 under "full"; "minimal"'s loss and
    trainables equal "full"'s within 1e-6."""
    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.models import model
    from repro_torch.train import trainer
    from repro_torch.tree import tree_leaves
    base = get_config("tiny")
    params = model.init_params(base, seed=0, device=cuda_device)
    batch = SyntheticLMDataset(base, 4, 32).batch_at(0)
    out = {}
    for policy, calls in (("none", 2), ("minimal", 2), ("full", 3)):
        cfg = base.replace(remat_policy=policy)
        tc = TrainConfig(learning_rate=1e-2)
        state = trainer.train_state_from_params(params, cfg, tc)
        ops.reset_launches()
        state, m = trainer.make_train_step(cfg, tc)(state, batch)
        torch.cuda.synchronize()
        assert ops.LAUNCHES["psoft_matmul"] == calls * 7 * cfg.num_layers
        out[policy] = (float(m["loss"]), tree_leaves(state.trainable))
    assert out["minimal"][0] == pytest.approx(out["full"][0], rel=1e-6)
    for a, b in zip(out["minimal"][1], out["full"][1]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


@pytest.mark.cuda
def test_training_launcher_runs_on_the_card(cuda_device, tmp_path):
    """``repro_torch.launch.train.main`` on ``tiny`` on the card: 4 steps,
    checkpoints at 2 and 4, then a resumed call to 6."""
    from repro_torch.launch import train
    from repro_torch.train import checkpoint
    flags = ["--arch", "tiny", "--rank", "8", "--batch", "4", "--seq", "32",
             "--ckpt", str(tmp_path), "--ckpt-every", "2", "--log-every",
             "1", "--device", "cuda"]
    ops.reset_launches()
    loss = train.main(flags + ["--steps", "4"])
    assert np.isfinite(loss) and ops.LAUNCHES["psoft_matmul"] > 0
    assert checkpoint.all_steps(str(tmp_path)) == [2, 4]
    assert np.isfinite(train.main(flags + ["--steps", "6"]))
    assert checkpoint.all_steps(str(tmp_path)) == [2, 4, 6]
