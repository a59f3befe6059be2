"""The plain-Python planning of the port's Hopper kernels, on the CPU: the
decode kernel's split of each row's page table, the gather-delta kernel's
K, u and r splits, the prefill kernel's query tiles, the engine a
psoft_matmul or paged_prefill_attention launch takes, and the wrappers'
CPU path (the plain versions, bit for bit).  No card is needed."""
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


# ---------------------------------------------------------------------------
# gather_delta_matmul: the split plan
# ---------------------------------------------------------------------------

def _covered(rows, splits, total):
    """The rows each split covers, in order: [s * rows, min(total, (s + 1) *
    rows)); every split non-empty."""
    out = []
    for s in range(splits):
        span = list(range(s * rows, min(total, (s + 1) * rows)))
        assert span, f"split {s} of {splits} is empty"
        out += span
    return out


@pytest.mark.parametrize("b,k,n,r", [
    (8, 3072, 3072, 352), (8, 3072, 1024, 352), (8, 3072, 8192, 352),
    (8, 8192, 3072, 352), (1, 64, 96, 8), (3, 1000, 200, 8),
    (11, 3072, 1024, 136), (16, 520, 100, 352), (2, 600, 40, 600),
    (9, 8192, 3072, 352), (4, 64, 160, 4), (8, 3072, 3072, 0)])
def test_gather_delta_plan_covers_every_row_and_column_once(b, k, n, r):
    plan = ops.gather_delta_plan(b, k, n, r)
    assert _covered(plan.k_rows, plan.k_splits, k) == list(range(k))
    cols = ops.GATHER_DELTA_COLS
    tiles = -(-n // cols)
    assert _covered(cols, tiles, n) == list(range(n))
    groups = -(-b // ops.GATHER_DELTA_ROWS)
    assert _covered(ops.GATHER_DELTA_ROWS, groups, b) == list(range(b))
    assert plan.base_blocks == plan.k_splits * tiles * groups
    assert plan.k_splits == 1 or plan.k_rows >= ops.GATHER_DELTA_K_LANES
    assert plan.k_rows % ops.GATHER_DELTA_K_STEP == 0
    if r == 0:
        assert plan.u_blocks == plan.rank_blocks == plan.r_splits == 0
        assert plan.kernels == 2
        return
    assert _covered(plan.u_rows, plan.u_splits, k) == list(range(k))
    assert plan.u_rows % ops.GATHER_DELTA_K_STEP == 0
    assert plan.u_rows <= ops.GATHER_DELTA_U_ROWS
    assert _covered(plan.r_rows, plan.r_splits, r) == list(range(r))
    assert plan.r_rows <= ops.GATHER_DELTA_R_ROWS
    ucols, rcols = ops.GATHER_DELTA_U_COLS, ops.GATHER_DELTA_RANK_COLS
    assert _covered(ucols, -(-r // ucols), r) == list(range(r))
    assert _covered(rcols, -(-n // rcols), n) == list(range(n))
    assert plan.u_blocks == plan.u_splits * -(-r // ucols) * groups
    assert plan.rank_blocks == plan.r_splits * -(-n // rcols) * groups


@pytest.mark.parametrize("name", sorted(LLAMA32_3B_LINEARS))
def test_gather_delta_plan_fills_the_card_at_every_llama_linear(name):
    """Serving's 8 slots, PSOFT r = 352: the x-W blocks reach about two
    blocks per SM (the k and v linears included), in three launches, and K
    splits are no more than the target needs."""
    k, n = LLAMA32_3B_LINEARS[name]
    plan = ops.gather_delta_plan(8, k, n, 352)
    assert plan.kernels <= 3
    assert plan.base_blocks >= ops.GATHER_DELTA_TARGET_BLOCKS
    assert (plan.u_rows, plan.u_splits) == (256, k // 256)
    assert plan.r_splits == 11 and plan.r_rows == 32
    # each split within one 16-row step of the rows the target asks for
    tiles = -(-n // ops.GATHER_DELTA_COLS)
    ideal = -(-k // -(-ops.GATHER_DELTA_TARGET_BLOCKS // tiles))
    assert ideal - ops.GATHER_DELTA_K_STEP < plan.k_rows <= ideal


# ---------------------------------------------------------------------------
# paged_prefill_attention: the tile plan and the engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s", [1, 17, 64, 130])
@pytest.mark.parametrize("g", [1, 3, 4])
def test_prefill_tile_plan_covers_every_query_row_once(s, g):
    """Every flattened (position, group) row of a kv head in exactly one
    tile, in order; each tile's suffix key limit is one past its last
    position."""
    seen = []
    for t in range(ops.prefill_tile_plan(s, g)):
        rho0, rows, kend = ops.prefill_tile_rows(s, g, t)
        assert 0 < rows <= ops.PREFILL_TILE_ROWS
        span = [(rho // g, rho % g) for rho in range(rho0, rho0 + rows)]
        assert kend == span[-1][0] + 1
        seen += span
    assert seen == [(i, j) for i in range(s) for j in range(g)]


@pytest.mark.parametrize("d", [32, 64, 128])
def test_prefill_engine_is_mma_in_bf16_and_simt_in_fp32(d):
    assert ops._prefill_engine(torch.bfloat16, d) == "mma"
    assert ops._prefill_engine(torch.float32, d) == "simt"


@pytest.mark.parametrize("d", [16, 96, 256])
def test_prefill_engine_refuses_other_bf16_head_dims(d):
    with pytest.raises(ValueError, match=f"head_dim {d}"):
        ops._prefill_engine(torch.bfloat16, d)
    assert ops._prefill_engine(torch.float32, d) == "simt"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("empty_table", [False, True])
def test_prefill_wrapper_on_the_cpu_is_the_plain_version(dtype, empty_table):
    rng = np.random.default_rng(2)
    b, s, h, kh, d, pages, pg, maxp = 3, 17, 6, 2, 32, 7, 8, 3
    args = [_normal(rng, (b, s, h, d)).to(dtype),
            _normal(rng, (b, s, kh, d), 0.5).to(dtype),
            _normal(rng, (b, s, kh, d), 0.5).to(dtype),
            _normal(rng, (pages, pg, kh, d), 0.5).to(dtype),
            _normal(rng, (pages, pg, kh, d), 0.5).to(dtype),
            torch.from_numpy(rng.integers(0, pages, (b, maxp))
                             .astype(np.int32)),
            torch.tensor([0, 11, 24], dtype=torch.int32)]
    want = ref.paged_prefill_attention(*args)
    if empty_table:
        # padded to one trash column with prefix_len 0
        want = ref.paged_prefill_attention(
            *args[:5], torch.zeros((b, 1), dtype=torch.int32),
            torch.zeros_like(args[6]))
        args[5] = args[5][:, :0]
    before = dict(ops.LAUNCHES), dict(ops.PREFILL_ENGINE_LAUNCHES)
    got = ops.paged_prefill_attention(*args)
    assert torch.equal(got, want)
    assert (dict(ops.LAUNCHES), dict(ops.PREFILL_ENGINE_LAUNCHES)) == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,k,n,r,na", [(8, 96, 80, 16, 3), (11, 40, 24, 4, 2)])
def test_gather_delta_wrapper_on_the_cpu_is_the_plain_version(dtype, b, k, n,
                                                              r, na):
    rng = np.random.default_rng(3)
    x = _normal(rng, (b, k))
    w = _normal(rng, (k, n), k ** -0.5)
    left = _normal(rng, (na, k, r), k ** -0.5)
    right = _normal(rng, (na, r, n), 0.05)
    ids = torch.from_numpy(rng.integers(0, na, b).astype(np.int32))
    before = dict(ops.LAUNCHES)
    got = ops.gather_delta_matmul(x, w, left, right, ids, compute_dtype=dtype)
    want = ref.gather_delta_matmul(ids, x.to(dtype), w.to(dtype),
                                   left.to(dtype), right)
    assert got.dtype == dtype and torch.equal(got, want)
    assert ops.LAUNCHES == before
