"""The plain-Python planning of the port's Hopper kernels, on the CPU: the
decode kernel's split of each row's page table, the gather-delta kernel's
K, u and r splits, the prefill kernel's query tiles, the Cayley "smem"
engine's matrices and 4 x 4 tiles, the rotation kernel's column blocks,
depth chunks and row tiles, the engine a psoft_matmul,
paged_prefill_attention, cayley_neumann or blockdiag_rotate launch takes,
and the wrappers' CPU path (the plain versions, bit for bit).  No card is
needed."""
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
    (9, 8192, 3072, 352), (4, 64, 160, 4), (8, 3072, 3072, 0),
    (8, 24576, 6144, 128), (8, 6144, 24576, 128), (8, 14336, 4096, 128)])
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


@pytest.mark.parametrize("k,n", [(24576, 6144), (6144, 24576),
                                 (14336, 4096), (4096, 14336), (6144, 16384),
                                 (8192, 3072), (65536, 64)])
def test_gather_delta_split_fits_a_block_at_the_zoo_widths(k, n):
    """A K split's x slice, staged in shared memory (fp32 on the CUDA-core
    engine: 8 rows x 4 bytes a K row) beside the 64 KB ring, fits the 227
    KB a block may hold: starcoder2-15b's and nemotron-4-15b's down (K
    24576) asked for 3 splits of 8192 rows (320 KB) before the cap."""
    plan = ops.gather_delta_plan(8, k, n, 128)
    assert plan.k_rows <= ops.GATHER_DELTA_MAX_K_ROWS
    stage = plan.k_rows * ops.GATHER_DELTA_ROWS * 4
    assert stage + ops.GATHER_DELTA_RING_BYTES + 1024 <= ops.SMEM_BYTES
    tiles = -(-n // ops.GATHER_DELTA_COLS)
    assert plan.base_blocks == plan.k_splits * tiles
    assert plan.base_blocks >= ops.GATHER_DELTA_TARGET_BLOCKS
    # as few splits as the target or the cap ask for, each split rounded
    # down to whole 16-row steps
    need = max(-(-ops.GATHER_DELTA_TARGET_BLOCKS // tiles),
               -(-k // ops.GATHER_DELTA_MAX_K_ROWS))
    step = ops.GATHER_DELTA_K_STEP
    assert plan.k_rows == -(-k // need) // step * step
    assert plan.k_splits == -(-k // plan.k_rows)


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

@pytest.mark.parametrize("s", [1, 2, 4, 5, 6, 17, 64, 130])
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


@pytest.mark.parametrize("d", [16, 80, 96, 256, 5])
def test_prefill_engine_refuses_other_bf16_head_dims(d):
    """The "mma" engine is built for 32, 64 and 128 only: every other bf16
    head dim goes to "simt", which takes any D, as fp32 does."""
    assert d not in ops.PREFILL_MMA_HEAD_DIMS
    assert ops._prefill_engine(torch.bfloat16, d) == "simt"
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


# ---------------------------------------------------------------------------
# cayley_neumann: the engine and the "smem" engine's packing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("r,engine", [(2, "smem"), (8, "smem"), (32, "smem"),
                                      (46, "smem"), (128, "smem"),
                                      (129, "tc"), (352, "tc")])
def test_cayley_engine_by_r(r, engine):
    assert ops._cayley_engine(r) == engine


@pytest.mark.parametrize("n_mat,r", [(2688, 32), (7168, 32), (21504, 8),
                                     (57344, 8), (28, 128), (3, 46), (1, 8),
                                     (5, 100), (7, 2), (1, 127)])
def test_cayley_smem_plan_covers_every_matrix_and_cell_once(n_mat, r):
    """Blocks of ``per_block`` consecutive matrices cover the stack once;
    the 4 x 4 tiles cover every cell of the padded rp x rp matrix once; a
    block's tiles are at most four a thread, and its Q and S fit a block's
    shared memory."""
    plan = ops.cayley_smem_plan(n_mat, r)
    assert plan.rp % 4 == 0 and r <= plan.rp < r + 4
    assert plan.tiles == (plan.rp // 4) ** 2
    mats = [m for blk in range(plan.blocks)
            for m in range(blk * plan.per_block,
                           min(n_mat, (blk + 1) * plan.per_block))]
    assert mats == list(range(n_mat))
    assert (plan.blocks - 1) * plan.per_block < n_mat
    cells = sorted((i, j) for t in range(plan.tiles)
                   for i in ops.cayley_tile_cells(plan.rp, t)[0]
                   for j in ops.cayley_tile_cells(plan.rp, t)[1])
    assert cells == [(i, j) for i in range(plan.rp) for j in range(plan.rp)]
    assert plan.per_block * plan.tiles <= 4 * ops.CAYLEY_THREADS
    assert plan.per_block * 4 * ops._cayley_matrix_floats(r) <= \
        ops.SMEM_BYTES


def test_cayley_smem_plan_at_the_oft_and_boft_stacks():
    """OFT's blocks of 32 pack 4 matrices a block (one 4 x 4 tile per
    thread), BOFT's blocks of 8 pack 64."""
    assert ops.cayley_smem_plan(2688, 32).per_block == 4
    assert ops.cayley_smem_plan(21504, 8).per_block == 64
    assert ops.cayley_smem_plan(2, 128).per_block == 1


@pytest.mark.parametrize("terms", [0, 1, 5])
def test_cayley_wrapper_on_the_cpu_is_the_plain_version(terms):
    rng = np.random.default_rng(4)
    q = _normal(rng, (3, 10, 10), 0.1)
    q = q - q.transpose(1, 2)
    before = dict(ops.LAUNCHES), dict(ops.CAYLEY_ENGINE_LAUNCHES)
    got = ops._cayley(q, terms)
    want = ref.cayley_neumann_series(q, terms)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert (dict(ops.LAUNCHES), dict(ops.CAYLEY_ENGINE_LAUNCHES)) == before


# ---------------------------------------------------------------------------
# blockdiag_rotate: the engine and the grid
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("x_dtype,rots_dtype,b,aligned,engine", [
    (torch.bfloat16, torch.bfloat16, 32, True, "mma"),
    (torch.bfloat16, torch.bfloat16, 16, True, "mma"),
    (torch.bfloat16, torch.bfloat16, 256, True, "mma"),
    (torch.bfloat16, torch.bfloat16, 144, True, "mma"),
    (torch.bfloat16, torch.bfloat16, 8, True, "simt"),    # BOFT
    (torch.bfloat16, torch.bfloat16, 2, True, "simt"),    # GOFT, qGOFT
    (torch.bfloat16, torch.bfloat16, 48 + 8, True, "simt"),
    (torch.bfloat16, torch.bfloat16, 32, False, "simt"),  # misaligned
    (torch.bfloat16, torch.float32, 32, True, "simt"),    # fp32 rotations
    (torch.float32, torch.float32, 32, True, "simt"),
    (torch.float32, torch.float32, 256, True, "simt")])
def test_blockdiag_engine_by_dtype_block_and_alignment(x_dtype, rots_dtype, b,
                                                       aligned, engine):
    assert ops._blockdiag_engine(x_dtype, rots_dtype, b, aligned) == engine


@pytest.mark.parametrize("m,d,b", [
    (2048, 3072, 32), (2048, 8192, 32), (2048, 3072, 16), (2048, 3072, 8),
    (2048, 3072, 2), (2048, 3072, 256), (64, 512, 256), (33, 1024, 512),
    (20, 288, 144), (20, 272, 136), (17, 192, 48), (50, 96, 6),
    (1, 3072, 3072), (130, 3072, 256), (70, 256, 128)])
def test_blockdiag_plan_covers_every_row_column_and_depth_once(m, d, b):
    """Column blocks cover each output column once, each inside its own
    group and at most 128 wide; depth chunks of 64 cover a group's b rows
    once above b = 128 (one chunk at or below); the row tiles and each row
    block's tiles cover every row once."""
    plan = ops.blockdiag_plan(m, d, b)
    cols = []
    for cb in range(plan.col_blocks):
        g0, ng, c0, sw = ops.blockdiag_block_columns(d, b, cb)
        assert 0 < sw <= ops.BLOCKDIAG_COLS and ng >= 1
        assert ng == 1 or (c0 == 0 and sw == b)
        assert ng * sw <= ops.BLOCKDIAG_COLS
        cols += [(g0 + j) * b + c0 + c for j in range(ng) for c in range(sw)]
    assert cols == list(range(d))
    depth = ops.BLOCKDIAG_DEPTH if b > ops.BLOCKDIAG_COLS else b
    chunks = [k for ch in range(plan.chunks)
              for k in range(ch * depth, min(b, (ch + 1) * depth))]
    assert chunks == list(range(b))
    rows = [i for rb in range(plan.row_blocks)
            for t in range(rb * plan.tiles_per_block,
                           min(plan.row_tiles,
                               (rb + 1) * plan.tiles_per_block))
            for i in range(t * ops.BLOCKDIAG_ROWS,
                           min(m, (t + 1) * ops.BLOCKDIAG_ROWS))]
    assert rows == list(range(m))
    assert (plan.row_blocks - 1) * plan.tiles_per_block < plan.row_tiles


def test_blockdiag_plan_at_the_oft_shape():
    """OFT's rotation of a llama32-3b linear (2048 tokens, d 3072, b 32):
    4 groups a block, 24 column blocks, two row tiles a block (384 blocks,
    about three per SM of an H100); b = 256 walks 4 depth chunks of one
    row tile a block."""
    assert ops.blockdiag_plan(2048, 3072, 32) == (24, 1, 32, 2, 16)
    assert ops.blockdiag_plan(2048, 3072, 256) == (24, 4, 32, 1, 32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b", [2, 32, 256])
@pytest.mark.parametrize("transpose", [False, True])
def test_blockdiag_wrapper_on_the_cpu_is_the_plain_version(dtype, b,
                                                           transpose):
    rng = np.random.default_rng(5)
    x = _normal(rng, (9, 512)).to(dtype)
    rots = (torch.eye(b) + _normal(rng, (512 // b, b, b), 0.1)).to(dtype)
    before = dict(ops.LAUNCHES), dict(ops.BLOCKDIAG_ENGINE_LAUNCHES)
    got = ops.blockdiag_rotate(x, rots, transpose=transpose)
    assert torch.equal(got, ref.blockdiag_rotate(x, rots, transpose))
    assert (dict(ops.LAUNCHES), dict(ops.BLOCKDIAG_ENGINE_LAUNCHES)) == \
        before
