"""The port's CUDA kernels against their plain PyTorch versions on the card
(fp32 tolerance 1e-4; bf16 2e-2, its absolute part scaled by the
output's RMS), plus a tiny paged serving run that must
launch every kernel.  Imports nothing of the reference package, so it runs
where JAX is not installed:

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
    prefix goes through all three kernels and returns every page."""
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
    assert all(n > 0 for n in ops.LAUNCHES.values()), ops.LAUNCHES
