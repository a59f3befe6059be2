"""The plain-Python planning of the port's Hopper kernels, on the CPU: the
decode kernel's split of each row's page table, the engine a psoft_matmul
launch takes, and the wrappers' CPU path (the plain versions, bit for bit).
No card is needed."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.kernels import ops, ref  # noqa: E402

#: W_res (K, N) of the seven linears of one llama32-3b layer
LLAMA32_3B_LINEARS = {"q": (3072, 3072), "k": (3072, 1024),
                      "v": (3072, 1024), "o": (3072, 3072),
                      "gate": (3072, 8192), "up": (3072, 8192),
                      "down": (8192, 3072)}
ALIGNED = [0x7F0000000000 + 256 * i for i in range(5)]


@pytest.mark.parametrize("b,kh,maxp", [
    (8, 8, 32), (1, 1, 1), (1, 8, 32), (2, 4, 30), (3, 8, 7), (64, 8, 32),
    (8, 8, 2048), (16, 2, 33)])
def test_decode_split_plan_covers_every_column_once(b, kh, maxp):
    pps, splits = ops.decode_split_plan(b, kh, maxp)
    assert pps >= 1 and splits >= 1
    cols = [c for s in range(splits)
            for c in range(s * pps, min((s + 1) * pps, maxp))]
    assert cols == list(range(maxp))
    # every split holds at least one column
    assert all(s * pps < maxp for s in range(splits))
    # the plan aims at DECODE_TARGET_BLOCKS: it stops doubling pps only
    # where doubling would fall short of the target
    blocks = b * kh * splits
    if pps > 1:
        assert blocks >= ops.DECODE_TARGET_BLOCKS
    if pps * 2 <= maxp:
        assert b * kh * -(-maxp // (2 * pps)) < ops.DECODE_TARGET_BLOCKS


def test_decode_split_plan_at_the_smoke_shape():
    """llama32-3b serving: 8 slots, 8 KV heads, 32 pages of 16: 4 pages a
    split, 512 blocks, about two per SM of an H100."""
    assert ops.decode_split_plan(8, 8, 32) == (4, 8)
    assert 8 * 8 * 8 >= ops.DECODE_TARGET_BLOCKS == 2 * 132


@pytest.mark.parametrize("name", sorted(LLAMA32_3B_LINEARS))
@pytest.mark.parametrize("transpose", [False, True])
def test_psoft_engine_is_wgmma_on_every_llama_linear(name, transpose):
    """Both orientations read the same W_res (K, N), A (K, r), B (r, N)."""
    k, n = LLAMA32_3B_LINEARS[name]
    x_cols = n if transpose else k
    assert x_cols % 8 == 0
    assert ops._psoft_engine(torch.bfloat16, k, n, 352, ALIGNED) == "wgmma"


@pytest.mark.parametrize("k,n,r,ptrs,engine", [
    (3072, 3072, 9, ALIGNED, "wmma"),        # r = 9: an 18-byte row
    (3072, 3072, 33, ALIGNED, "wmma"),
    (3076, 3072, 352, ALIGNED, "wmma"),      # K not a multiple of 8
    (3072, 1020, 352, ALIGNED, "wmma"),      # N not a multiple of 8
    (3072, 3072, 0, ALIGNED, "wmma"),        # no rank-r term
    (3072, 3072, 352, ALIGNED[:4] + [ALIGNED[4] + 8], "wmma"),  # misaligned
    (72, 200, 8, ALIGNED, "wgmma"),
    (3072, 3072, 352, ALIGNED, "wgmma")])
def test_psoft_engine_by_shape_and_alignment(k, n, r, ptrs, engine):
    assert ops._psoft_engine(torch.bfloat16, k, n, r, ptrs) == engine


@pytest.mark.parametrize("r", [9, 352])
def test_psoft_engine_is_simt_in_fp32(r):
    assert ops._psoft_engine(torch.float32, 3072, 3072, r, ALIGNED) == "simt"


def _normal(rng, shape, scale=1.0):
    return torch.from_numpy((rng.standard_normal(shape) * scale)
                            .astype(np.float32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_wrapper_on_the_cpu_is_the_plain_version(dtype):
    rng = np.random.default_rng(0)
    b, h, kh, d, pages, pg, maxp = 4, 6, 2, 32, 9, 8, 4
    args = [_normal(rng, (b, h, d)).to(dtype),
            _normal(rng, (pages, pg, kh, d), 0.5).to(dtype),
            _normal(rng, (pages, pg, kh, d), 0.5).to(dtype),
            torch.from_numpy(rng.integers(0, pages, (b, maxp))
                             .astype(np.int32)),
            torch.tensor([0, 1, 17, 32], dtype=torch.int32)]
    before = dict(ops.LAUNCHES)
    got = ops.paged_decode_attention(*args)
    assert torch.equal(got, ref.paged_decode_attention(*args))
    assert ops.LAUNCHES == before  # a CPU call is no launch


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("transpose", [False, True])
def test_psoft_wrapper_on_the_cpu_is_the_plain_version(dtype, transpose):
    rng = np.random.default_rng(1)
    m, k, n, r = 20, 24, 16, 8
    args = [_normal(rng, (m, n if transpose else k), 0.5).to(dtype),
            _normal(rng, (k, n), k ** -0.5).to(dtype),
            _normal(rng, (k, r), k ** -0.5).to(dtype),
            torch.eye(r) + _normal(rng, (r, r), 0.05),
            _normal(rng, (r, n), 0.5).to(dtype),
            1 + _normal(rng, (r,), 0.1), 1 + _normal(rng, (r,), 0.1)]
    before = dict(ops.PSOFT_ENGINE_LAUNCHES)
    got = ops._psoft_mm(*args, transpose)
    want = ref.psoft_matmul_parts(*args, transpose)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert ops.PSOFT_ENGINE_LAUNCHES == before
