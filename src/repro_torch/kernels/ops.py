"""Wrappers of the port's hand-written Hopper kernels.

Each wrapper takes tensors on one device.  On the CPU it returns the plain
PyTorch version (:mod:`repro_torch.kernels.ref`); on a CUDA tensor it checks
device, dtype, shape and contiguity, allocates the outputs with
``torch.empty``, launches the kernel on the current stream and raises if the
launch failed.  Nothing gives way to the plain version when a build or a
launch fails.  The three training wrappers (:func:`psoft_matmul`,
:func:`cayley_neumann`, :func:`blockdiag_rotate`) are
``torch.autograd.Function``s whose backwards are exact: psoft_matmul's and
blockdiag_rotate's dx is the kernel's transposed launch.

:data:`LAUNCHES` counts kernel launches per wrapper (CPU calls are not
launches), so a run can show that its main path went through the kernels;
a wrapper counts one launch per call even where its C entry point starts
two or more CUDA kernels.  :data:`PSOFT_ENGINE_LAUNCHES`,
:data:`PREFILL_ENGINE_LAUNCHES`, :data:`CAYLEY_ENGINE_LAUNCHES` and
:data:`BLOCKDIAG_ENGINE_LAUNCHES` split psoft_matmul's,
paged_prefill_attention's, cayley_neumann's and blockdiag_rotate's launches
by the engine they took (:func:`_psoft_engine`, :func:`_prefill_engine`,
:func:`_cayley_engine`, :func:`_blockdiag_engine`).  The grids of the
decode, prefill, gather-delta, Cayley and rotation kernels are planned here
from shapes alone (:func:`decode_split_plan`, :func:`prefill_tile_plan`,
:func:`gather_delta_plan`, :func:`cayley_smem_plan`,
:func:`blockdiag_plan`): no wrapper reads a device value on the host.
"""
from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.kernels import build, ref

#: kernel launches per wrapper since the last :func:`reset_launches`
LAUNCHES: Dict[str, int] = {"paged_decode_attention": 0,
                            "paged_prefill_attention": 0,
                            "gather_delta_matmul": 0,
                            "psoft_matmul": 0,
                            "cayley_neumann": 0,
                            "blockdiag_rotate": 0}

#: psoft_matmul launches per engine since the last :func:`reset_launches`
#: (grouped launches included)
PSOFT_ENGINE_LAUNCHES: Dict[str, int] = {"wgmma": 0, "wmma": 0, "simt": 0}
#: the grouped psoft_matmul launches (an expert stack each) among them, per
#: engine
PSOFT_GROUPED_LAUNCHES: Dict[str, int] = {"wgmma": 0, "wmma": 0, "simt": 0}
#: paged_prefill_attention launches per engine since the last
#: :func:`reset_launches`
PREFILL_ENGINE_LAUNCHES: Dict[str, int] = {"mma": 0, "simt": 0}
#: cayley_neumann launches per engine since the last :func:`reset_launches`
CAYLEY_ENGINE_LAUNCHES: Dict[str, int] = {"smem": 0, "tc": 0}
#: blockdiag_rotate launches per engine since the last :func:`reset_launches`
BLOCKDIAG_ENGINE_LAUNCHES: Dict[str, int] = {"mma": 0, "simt": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_PSOFT_ENGINE_CODE = {"simt": 0, "wmma": 1, "wgmma": 2}
_PREFILL_ENGINE_CODE = {"simt": 0, "mma": 1}
_CAYLEY_ENGINE_CODE = {"smem": 0, "tc": 1}
_BLOCKDIAG_ENGINE_CODE = {"simt": 0, "mma": 1}

#: blocks the decode split and the gather-delta x-W blocks aim for: about
#: two per SM of an H100 (132 SMs)
DECODE_TARGET_BLOCKS = 2 * 132
GATHER_DELTA_TARGET_BLOCKS = DECODE_TARGET_BLOCKS
#: gather-delta tiles (csrc/gather_delta_matmul.cu): rows per row group,
#: output columns of an x-W block, rank columns of a u block, output
#: columns of a rank block
GATHER_DELTA_ROWS = 8
GATHER_DELTA_COLS = 64
GATHER_DELTA_U_COLS = 64
GATHER_DELTA_RANK_COLS = 256
#: K lanes of an x-W block (256 threads over 8 column lanes): a K split
#: holds at least this many rows
GATHER_DELTA_K_LANES = 32
#: a K split's rows are a multiple of this: whole 16-row tensor-core steps,
#: each split starting on 16 bytes of x
GATHER_DELTA_K_STEP = 16
#: most rows of K in one split: an x-W block stages its split of x in
#: shared memory beside its 64 KB cp.async ring, as fp32 (8 rows x 4 bytes
#: a K row) on the CUDA-core engine, so 4096 rows take 128 KB of the 227 KB
#: a block may hold (K 24576 in 3 splits of 8192 rows asked for 320 KB)
GATHER_DELTA_MAX_K_ROWS = 4096
#: the x-W block's ring (csrc/gather_delta_matmul.cu: kStages x kThreads x
#: kCols fp32)
GATHER_DELTA_RING_BYTES = 8 * 256 * 8 * 4
#: rows of K in a u block's slice and of r in a rank block's slice (tuned
#: on an H100 at the llama32-3b linears)
GATHER_DELTA_U_ROWS = 256
GATHER_DELTA_R_ROWS = 32
#: flattened (position, group) query rows of one prefill "mma" block
PREFILL_TILE_ROWS = 64
#: head dims the prefill "mma" engine is built for
PREFILL_MMA_HEAD_DIMS = (32, 64, 128)


def reset_launches() -> None:
    for counts in (LAUNCHES, PSOFT_ENGINE_LAUNCHES, PSOFT_GROUPED_LAUNCHES,
                   PREFILL_ENGINE_LAUNCHES, CAYLEY_ENGINE_LAUNCHES,
                   BLOCKDIAG_ENGINE_LAUNCHES):
        for k in counts:
            counts[k] = 0


def _launch(name: str, *args) -> None:
    lib = build.library(name)
    rc = lib.launch(*args)
    if rc != 0:
        msg = lib.repro_cuda_error_string(rc).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc} "
                           f"({msg})")
    LAUNCHES[name] += 1


def _on_cpu(*tensors: torch.Tensor) -> bool:
    """True when every tensor is on the CPU; raises on mixed devices and on
    devices other than the CPU and CUDA."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"tensors on different devices: {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev.type == "cpu"


def _float_arg(t: torch.Tensor, name: str, dtype: torch.dtype,
               ndim: int) -> int:
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if t.ndim != ndim:
        raise ValueError(f"{name}: expected {ndim}-D, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    return t.data_ptr()


def _index_arg(t: torch.Tensor, name: str, shape) -> torch.Tensor:
    """int32 contiguous copy (or the tensor itself) of an index tensor."""
    if t.dtype.is_floating_point or t.dtype.is_complex or \
            t.dtype == torch.bool:
        raise TypeError(f"{name}: integer tensor expected, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    return t.to(torch.int32).contiguous()


def _compute_code(dtype: torch.dtype) -> int:
    try:
        return _DTYPE_CODE[dtype]
    except KeyError:
        raise TypeError(f"kernels take float32 or bfloat16, not {dtype}") \
            from None


def _stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def decode_split_plan(b: int, kh: int, maxp: int) -> Tuple[int, int]:
    """(pages per split, splits) of the decode kernel's grid (B * KH,
    splits): the largest power of two ``pps <= maxp`` whose
    ``B * KH * ceil(maxp / pps)`` blocks still reach
    :data:`DECODE_TARGET_BLOCKS` (1 where none does).  The splits cover the
    table's ``maxp`` columns, the last one possibly short."""
    pps = 1
    while pps * 2 <= maxp and \
            b * kh * -(-maxp // (pps * 2)) >= DECODE_TARGET_BLOCKS:
        pps *= 2
    return pps, -(-maxp // pps)


def paged_decode_attention(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, page_table: torch.Tensor,
                           lengths: torch.Tensor, lse: bool = False):
    """One-token GQA over block-paged KV pools.

    q (B, H, D); pools (P, pg, KH, D); page_table (B, maxp); lengths (B,).
    Page ids outside [0, P) are clamped.  Returns (B, H, D) in q's dtype;
    with ``lse`` (out, each row's and head's fp32 log-sum-exp of its
    scaled scores (B, H), which the combine kernel writes: -inf for a row
    of length 0).  Any D: on the card the kernel copies pages by 16-byte
    rows where D times the element size is a multiple of 16 and the pools
    are 16-byte aligned, element by element otherwise."""
    if _on_cpu(q, k_pool, v_pool, page_table, lengths):
        return ref.paged_decode_attention(q, k_pool, v_pool, page_table,
                                          lengths, lse=lse)
    code = _compute_code(q.dtype)
    b, h, d = q.shape
    p, pg, kh, d2 = k_pool.shape
    if tuple(v_pool.shape) != tuple(k_pool.shape) or d2 != d or h % kh:
        raise ValueError(f"shapes q {tuple(q.shape)}, k_pool "
                         f"{tuple(k_pool.shape)}, v_pool {tuple(v_pool.shape)}")
    maxp = page_table.shape[-1]
    pt = _index_arg(page_table, "page_table", (b, maxp))
    ln = _index_arg(lengths, "lengths", (b,))
    if maxp == 0:
        raise ValueError("page_table needs at least one column")
    pps, splits = decode_split_plan(b, kh, maxp)
    # per split: the running max and sum and the unnormalized output
    part = torch.empty(b * h * splits * (d + 2), dtype=torch.float32,
                       device=q.device)
    out = torch.empty_like(q)
    lse_out = torch.empty((b, h), dtype=torch.float32, device=q.device) \
        if lse else None
    _launch("paged_decode_attention", code,
            _float_arg(q, "q", q.dtype, 3),
            _float_arg(k_pool, "k_pool", q.dtype, 4),
            _float_arg(v_pool, "v_pool", q.dtype, 4),
            pt.data_ptr(), ln.data_ptr(), out.data_ptr(), part.data_ptr(),
            None if lse_out is None else lse_out.data_ptr(),
            b, h, kh, d, p, pg, maxp, pps, _stream(q.device))
    return out if lse_out is None else (out, lse_out)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def prefill_tile_plan(s: int, g: int) -> int:
    """Blocks per (row, kv head) of the prefill "mma" engine: the S * G
    flattened query rows ``rho = i * G + g`` of one kv head, in tiles of
    :data:`PREFILL_TILE_ROWS` (see :func:`prefill_tile_rows`)."""
    return _cdiv(s * g, PREFILL_TILE_ROWS)


def prefill_tile_rows(s: int, g: int, tile: int) -> Tuple[int, int, int]:
    """(first flattened row, rows, suffix keys visible) of one prefill tile,
    as the kernel computes them: rows [rho0, rho0 + rows) with positions
    ``rho // g``; the suffix keys ``j < kend`` (the tile's last position + 1)
    are all any of its rows can see."""
    rho0 = tile * PREFILL_TILE_ROWS
    rows = min(PREFILL_TILE_ROWS, s * g - rho0)
    return rho0, rows, (rho0 + rows - 1) // g + 1


def _prefill_engine(dtype: torch.dtype, d: int) -> str:
    """The engine of a paged_prefill_attention launch on the card:
    ``"mma"`` (flash prefill on the tensor cores) in bf16 at the head dims
    it is built for (:data:`PREFILL_MMA_HEAD_DIMS`), ``"simt"`` (the first,
    CUDA-core design, any head dim) in fp32 and at every other bf16 head
    dim.  Neither engine ever stands in for the other."""
    if dtype == torch.float32:
        return "simt"
    if dtype == torch.bfloat16:
        return "mma" if d in PREFILL_MMA_HEAD_DIMS else "simt"
    raise TypeError(f"kernels take float32 or bfloat16, not {dtype}")


def paged_prefill_attention(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, k_pool: torch.Tensor,
                            v_pool: torch.Tensor, prefix_table: torch.Tensor,
                            prefix_len: torch.Tensor) -> torch.Tensor:
    """Suffix prefill: causal suffix over a block-paged prefix.

    q (B, S, H, D); k/v (B, S, KH, D) post-RoPE; pools (P, pg, KH, D);
    prefix_table (B, maxp); prefix_len (B,), any alignment.  An empty table
    is padded to one trash column with prefix_len 0.  On the card, bf16
    with D in :data:`PREFILL_MMA_HEAD_DIMS` runs on the "mma" engine (every
    tensor 16-byte aligned), everything else on "simt"
    (:func:`_prefill_engine`)."""
    b = q.shape[0]
    if prefix_table.shape[-1] == 0:
        prefix_table = torch.zeros((b, 1), dtype=torch.int32,
                                   device=prefix_table.device)
        prefix_len = torch.zeros_like(prefix_len)
    if _on_cpu(q, k, v, k_pool, v_pool, prefix_table, prefix_len):
        return ref.paged_prefill_attention(q, k, v, k_pool, v_pool,
                                           prefix_table, prefix_len)
    code = _compute_code(q.dtype)
    _, s, h, d = q.shape
    p, pg, kh, d2 = k_pool.shape
    if tuple(k.shape) != (b, s, kh, d) or tuple(v.shape) != (b, s, kh, d) \
            or tuple(v_pool.shape) != tuple(k_pool.shape) or d2 != d \
            or h % kh:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}, pools {tuple(k_pool.shape)}")
    maxp = prefix_table.shape[-1]
    pt = _index_arg(prefix_table, "prefix_table", (b, maxp))
    pl = _index_arg(prefix_len, "prefix_len", (b,))
    engine = _prefill_engine(q.dtype, d)
    ptrs = [_float_arg(q, "q", q.dtype, 4), _float_arg(k, "k", q.dtype, 4),
            _float_arg(v, "v", q.dtype, 4),
            _float_arg(k_pool, "k_pool", q.dtype, 4),
            _float_arg(v_pool, "v_pool", q.dtype, 4)]
    if engine == "mma" and any(ptr % 16 for ptr in ptrs):
        raise ValueError("q, k, v and the pools must be 16-byte aligned for "
                         "the bf16 prefill kernel")
    out = torch.empty_like(q)
    _launch("paged_prefill_attention", code, _PREFILL_ENGINE_CODE[engine],
            *ptrs, pt.data_ptr(), pl.data_ptr(), out.data_ptr(),
            b, s, h, kh, d, p, pg, maxp, prefill_tile_plan(s, h // kh),
            _stream(q.device))
    PREFILL_ENGINE_LAUNCHES[engine] += 1
    return out


class GatherDeltaPlan(NamedTuple):
    """The grids of one gather-delta call (csrc/gather_delta_matmul.cu).

    The u launch holds ``u_blocks`` blocks of the rank-r input
    ``u = x left[ids]`` (K slices of ``u_rows`` rows by
    :data:`GATHER_DELTA_U_COLS` rank columns); the output launch
    ``base_blocks`` blocks of ``x W`` (K splits of ``k_rows`` rows by
    :data:`GATHER_DELTA_COLS` output columns) and ``rank_blocks`` blocks of
    the rank-r term (slices of ``r_rows`` rows of r by
    :data:`GATHER_DELTA_RANK_COLS` output columns); the finish launch sums the
    ``k_splits + r_splits`` fp32 partial planes.  Every count covers all
    row groups of :data:`GATHER_DELTA_ROWS` rows."""
    k_rows: int
    k_splits: int
    u_rows: int
    u_splits: int
    r_rows: int
    r_splits: int
    base_blocks: int
    u_blocks: int
    rank_blocks: int
    kernels: int


def gather_delta_plan(b: int, k: int, n: int, r: int) -> GatherDeltaPlan:
    """The split of a gather-delta call x (b, k) . W (k, n) + rank r, from
    shapes alone (the host never reads ids):

    - K splits: as few as give :data:`GATHER_DELTA_TARGET_BLOCKS` x-W
      blocks over the 64-column tiles and row groups, each split at least
      :data:`GATHER_DELTA_K_LANES` rows and at most
      :data:`GATHER_DELTA_MAX_K_ROWS` (what a block stages in shared
      memory), rounded down to a multiple of :data:`GATHER_DELTA_K_STEP`
      (the last split takes the rest);
    - u slices: :data:`GATHER_DELTA_U_ROWS` rows each (every rank block
      sums one partial per slice);
    - r slices: :data:`GATHER_DELTA_R_ROWS` rows each.

    The last slice of each takes the rest.

    Each split's rows are ``[s * rows, min(total, (s + 1) * rows))``; no
    split is empty.  r = 0 has no u or rank blocks (two launches)."""
    groups = _cdiv(b, GATHER_DELTA_ROWS)
    tiles = _cdiv(n, GATHER_DELTA_COLS)
    k_splits = max(min(_cdiv(GATHER_DELTA_TARGET_BLOCKS, tiles * groups),
                       max(1, k // GATHER_DELTA_K_LANES)),
                   _cdiv(k, GATHER_DELTA_MAX_K_ROWS))
    step = GATHER_DELTA_K_STEP

    def rows(splits):
        return max(step, _cdiv(k, splits) // step * step)

    k_rows = rows(k_splits)
    k_splits = _cdiv(k, k_rows)
    if r == 0:
        return GatherDeltaPlan(k_rows, k_splits, k_rows, 0, 0, 0,
                               k_splits * tiles * groups, 0, 0, 2)
    u_tiles = _cdiv(r, GATHER_DELTA_U_COLS)
    u_rows = min(GATHER_DELTA_U_ROWS, _cdiv(k, step) * step)
    u_splits = _cdiv(k, u_rows)
    rank_tiles = _cdiv(n, GATHER_DELTA_RANK_COLS)
    r_rows = min(r, GATHER_DELTA_R_ROWS)
    r_splits = _cdiv(r, r_rows)
    return GatherDeltaPlan(
        k_rows, k_splits, u_rows, u_splits, r_rows, r_splits,
        k_splits * tiles * groups, u_splits * u_tiles * groups,
        r_splits * rank_tiles * groups, 3)


def gather_delta_matmul(x: torch.Tensor, w: torch.Tensor, left: torch.Tensor,
                        right: torch.Tensor, ids: torch.Tensor, *,
                        compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Per-row gathered low-rank delta matmul for decode.

    y[b] = x[b] @ W + (x[b] @ left[ids[b]]) @ right[ids[b]]; x (B, K),
    W (K, N), left (A, K, r), right (A, r, N).  x, W and left are cast to
    ``compute_dtype``; right stays fp32.  Adapter ids outside [0, A) are
    clamped.  Returns (B, N) in ``compute_dtype``.  On the card: three
    launches planned by :func:`gather_delta_plan`, fp32 partials in scratch
    this wrapper allocates."""
    x = x.to(compute_dtype)
    w = w.to(compute_dtype)
    left = left.to(compute_dtype)
    if _on_cpu(x, w, left, right, ids):
        return ref.gather_delta_matmul(ids, x, w, left, right)
    code = _compute_code(compute_dtype)
    bsz, kdim = x.shape
    a, kdim2, r = left.shape
    if tuple(w.shape[:1]) != (kdim,) or kdim2 != kdim or w.ndim != 2 \
            or tuple(right.shape) != (a, r, w.shape[1]):
        raise ValueError(f"shapes x {tuple(x.shape)}, w {tuple(w.shape)}, "
                         f"left {tuple(left.shape)}, right "
                         f"{tuple(right.shape)}")
    n = w.shape[1]
    idx = _index_arg(ids, "ids", (bsz,))
    plan = gather_delta_plan(bsz, kdim, n, r)
    f32 = torch.float32
    u_part = torch.empty((plan.u_splits, bsz, r), dtype=f32, device=x.device)
    part = torch.empty((plan.k_splits + plan.r_splits, bsz, n), dtype=f32,
                       device=x.device)
    y = torch.empty((bsz, n), dtype=compute_dtype, device=x.device)
    _launch("gather_delta_matmul", code,
            _float_arg(x, "x", compute_dtype, 2),
            _float_arg(w, "w", compute_dtype, 2),
            _float_arg(left, "left", compute_dtype, 3),
            _float_arg(right, "right", f32, 3),
            idx.data_ptr(), u_part.data_ptr(), part.data_ptr(), y.data_ptr(),
            bsz, kdim, n, r, a, plan.k_rows, plan.u_rows, max(plan.r_rows, 1),
            _stream(x.device))
    return y


# ---------------------------------------------------------------------------
# training path: the fused PSOFT linear and the Cayley-Neumann rotation
# ---------------------------------------------------------------------------

def _psoft_engine(dtype: torch.dtype, k: int, n: int, r: int,
                  ptrs: Sequence[int]) -> str:
    """The engine of a psoft_matmul launch on the card, from the dtype, the
    shapes (W_res (k, n), rank r) and the inputs' addresses ``ptrs``:
    ``"simt"`` in fp32 (exact fp32 on the CUDA cores); ``"wgmma"`` in bf16
    where TMA can read every operand in place (k, n and r > 0 multiples of
    8 elements, so every row pitch is a multiple of 16 bytes, and every
    pointer 16-byte aligned); ``"wmma"`` for any other bf16 shape.  The
    orientation does not enter: both read the same arrays, and neither does
    a group axis: with k, n and r multiples of 8 every group's slice of
    every array starts 16 bytes on from the last."""
    if dtype == torch.float32:
        return "simt"
    if r > 0 and k % 8 == 0 and n % 8 == 0 and r % 8 == 0 and \
            all(p % 16 == 0 for p in ptrs):
        return "wgmma"
    return "wmma"


def _psoft_mm(x: torch.Tensor, w_res: torch.Tensor, a: torch.Tensor,
              rot: torch.Tensor, b: torch.Tensor, s_in: torch.Tensor,
              s_out: torch.Tensor, transpose: bool):
    """One PSOFT-linear launch: (y, u, t) of
    :func:`repro_torch.kernels.ref.psoft_matmul_parts`.  ``transpose`` reads
    W_res, A, B and R transposed in place (x is then dy (M, N) and y is dx
    (M, K)).  A 3-D ``w_res`` (G, K, N) is an expert stack: every argument
    then leads with G (x (G, M, K|N), s_in and s_out (G, r)), and the
    grouped kernel takes the whole stack in one launch."""
    if _on_cpu(x, w_res, a, rot, b, s_in, s_out):
        return ref.psoft_matmul_parts(x, w_res, a, rot, b, s_in, s_out,
                                      transpose)
    code = _compute_code(x.dtype)
    f32 = torch.float32
    grouped = w_res.ndim == 3
    lead = tuple(w_res.shape[:1]) if grouped else ()
    kdim, n = w_res.shape[-2:]
    r = a.shape[-1]
    din, dout = (n, kdim) if transpose else (kdim, n)
    m = x.shape[-2]
    if w_res.ndim not in (2, 3) or tuple(x.shape) != lead + (m, din) \
            or tuple(a.shape) != lead + (kdim, r) \
            or tuple(b.shape) != lead + (r, n) \
            or tuple(rot.shape) != lead + (r, r) \
            or tuple(s_in.shape) != lead + (r,) \
            or tuple(s_out.shape) != lead + (r,):
        raise ValueError(f"shapes x {tuple(x.shape)}, w_res "
                         f"{tuple(w_res.shape)}, a {tuple(a.shape)}, rot "
                         f"{tuple(rot.shape)}, b {tuple(b.shape)}, scales "
                         f"{tuple(s_in.shape)} {tuple(s_out.shape)} "
                         f"(transpose={transpose})")
    nd = w_res.ndim
    ptrs = [_float_arg(x, "x", x.dtype, nd),
            _float_arg(w_res, "w_res", x.dtype, nd),
            _float_arg(a, "A", x.dtype, nd), _float_arg(rot, "rot", f32, nd),
            _float_arg(b, "B", x.dtype, nd)]
    engine = _psoft_engine(x.dtype, kdim, n, r, ptrs)
    u = torch.empty(lead + (m, r), dtype=f32, device=x.device)
    t = torch.empty(lead + (m, r), dtype=f32, device=x.device)
    # the wgmma engine's bf16 copy of v = t . s_out, for TMA to read
    v = torch.empty(lead + (m, r), dtype=x.dtype, device=x.device) \
        if engine == "wgmma" else None
    y = torch.empty(lead + (m, dout), dtype=x.dtype, device=x.device)
    _launch("psoft_matmul", code, _PSOFT_ENGINE_CODE[engine],
            int(transpose), *ptrs, _float_arg(s_in, "s_in", f32, nd - 1),
            _float_arg(s_out, "s_out", f32, nd - 1), u.data_ptr(),
            t.data_ptr(), None if v is None else v.data_ptr(), y.data_ptr(),
            lead[0] if grouped else 1, m, kdim, n, r, _stream(x.device))
    PSOFT_ENGINE_LAUNCHES[engine] += 1
    if grouped:
        PSOFT_GROUPED_LAUNCHES[engine] += 1
    return y, u, t


def _psoft_forward(x, w_res, a, rot, b, s_in, s_out):
    return _psoft_mm(x, w_res, a, rot, b, s_in, s_out, False)


#: the forward launch as an operator of its own,
#: ``torch.ops.repro_torch.psoft_matmul_forward``, so that a selective
#: checkpoint policy can name it and keep its outputs (the ``"minimal"``
#: remat policy, :func:`repro_torch.models.model._remat`): a recompute then
#: takes (y, u, t) from the forward instead of launching again
_LIBRARY = torch.library.Library("repro_torch", "DEF")
_LIBRARY.define("psoft_matmul_forward(Tensor x, Tensor w_res, Tensor a, "
                "Tensor rot, Tensor b, Tensor s_in, Tensor s_out) -> "
                "(Tensor, Tensor, Tensor)")
_LIBRARY.impl("psoft_matmul_forward", _psoft_forward,
              "CompositeExplicitAutograd")
PSOFT_FORWARD_OP = torch.ops.repro_torch.psoft_matmul_forward.default


class _PSoftMatmul(torch.autograd.Function):
    """y = x (W_res + A diag(alpha) R diag(beta) B), differentiable in every
    input.  The forward launch is :data:`PSOFT_FORWARD_OP`.  The backward's
    dx is the kernel's transposed launch (which also yields du4 = dy B^T
    and du2 = du3 R^T); the r-sized products for R, alpha and beta and,
    where asked for, the frozen factors' grads are plain torch products
    (batched over the group axis of an expert stack).  An input nothing
    asks a grad of gets None."""

    @staticmethod
    def forward(ctx, x, w_res, a, rot, b, alpha, beta):
        y, u1, u3 = PSOFT_FORWARD_OP(x, w_res, a, rot, b, alpha, beta)
        ctx.save_for_backward(x, w_res, a, rot, b, alpha, beta, u1, u3)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, w_res, a, rot, b, alpha, beta, u1, u3 = ctx.saved_tensors
        need_x, need_w, need_a, need_rot, need_b, need_al, need_be = \
            ctx.needs_input_grad
        dy = dy.contiguous()
        dx = dw = da = drot = db = dal = dbe = None
        # (r,) or (G, r) scales against (M, r) or (G, M, r) rows
        al, be = alpha.unsqueeze(-2), beta.unsqueeze(-2)
        if need_x or need_a or need_rot or need_al or need_be:
            dxk, du4, du2 = _psoft_mm(dy, w_res, a, rot, b, beta, alpha, True)
            dx = dxk if need_x else None
            du3 = du4 * be
            if need_rot:
                drot = (u1 * al).mT @ du3
            if need_al:
                dal = (du2 * u1).sum(-2)
            if need_be:
                dbe = (du4 * u3).sum(-2)
            if need_a:
                da = (x.float().mT @ (du2 * al)).to(a.dtype)
        if need_w:
            dw = (x.mT @ dy).to(w_res.dtype)
        if need_b:
            db = ((u3 * be).mT @ dy.float()).to(b.dtype)
        return dx, dw, da, drot, db, dal, dbe


def psoft_matmul(x: torch.Tensor, w_res: torch.Tensor, a: torch.Tensor,
                 rot: torch.Tensor, b: torch.Tensor,
                 alpha: Optional[torch.Tensor] = None,
                 beta: Optional[torch.Tensor] = None, *,
                 compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Fused PSOFT linear for 2-D x (tokens, d_in), or grouped: an expert
    stack of G linears (W_res (G, d_in, d_out), A, R, B, alpha and beta
    with the same leading G) applied to x (G, tokens, d_in), group g
    through linear g, in one launch set.

    y = x (W_res + A diag(alpha) R diag(beta) B): x, W_res, A and B are cast
    to ``compute_dtype`` (default x's), R, alpha and beta to fp32 (missing
    alpha/beta are ones); fp32 accumulation; y in the compute dtype.
    Differentiable in every input (see :class:`_PSoftMatmul`)."""
    cdt = compute_dtype or x.dtype
    f32 = torch.float32
    r = a.shape[-1]
    ones = None
    if alpha is None or beta is None:
        ones = torch.ones(a.shape[:-2] + (r,), dtype=f32, device=x.device)
    alpha = ones if alpha is None else alpha.to(f32)
    beta = ones if beta is None else beta.to(f32)
    return _PSoftMatmul.apply(
        x.to(cdt).contiguous(), w_res.to(cdt).contiguous(),
        a.to(cdt).contiguous(), rot.to(f32).contiguous(),
        b.to(cdt).contiguous(), alpha.contiguous(), beta.contiguous())


#: largest r of the "smem" Cayley engine: Q and S of one matrix, 2 r^2
#: fp32 with padded rows, in a block's shared memory, and at most four
#: 4 x 4 output tiles a thread
CAYLEY_SMEM_MAX_R = 128
#: threads of a "smem" Cayley block, each owning 4 x 4 output tiles
CAYLEY_THREADS = 256
#: shared memory a Hopper block can use
SMEM_BYTES = 232448


class CayleyPlan(NamedTuple):
    """The grid of one "smem" Cayley launch (csrc/cayley_neumann.cu): each
    matrix padded to ``rp`` (r rounded up to 4) and cut into ``tiles``
    4 x 4 output tiles; ``per_block`` consecutive matrices a block (enough
    tiles for its :data:`CAYLEY_THREADS` threads, within its shared
    memory); ``blocks`` blocks over the stack."""
    rp: int
    tiles: int
    per_block: int
    blocks: int


def _cayley_matrix_floats(r: int) -> int:
    """fp32 words one matrix takes in a "smem" block: Q and S at rp x
    (rp + 4), rounded up to 32 words plus 8 (neighbouring matrices start 8
    banks apart)."""
    rp = -(-r // 4) * 4
    return -(-(2 * rp * (rp + 4)) // 32) * 32 + 8


def cayley_smem_plan(n_mat: int, r: int) -> CayleyPlan:
    """Plan of the "smem" engine for ``n_mat`` matrices of r x r."""
    rp = -(-r // 4) * 4
    tiles = (rp // 4) ** 2
    per_block = max(1, CAYLEY_THREADS // tiles)
    per_block = max(1, min(per_block,
                           SMEM_BYTES // (4 * _cayley_matrix_floats(r))))
    return CayleyPlan(rp, tiles, per_block, _cdiv(n_mat, per_block))


def cayley_tile_cells(rp: int, tile: int) -> Tuple[Tuple[int, ...],
                                                   Tuple[int, ...]]:
    """(rows, columns) of 4 x 4 output tile ``tile`` of an rp x rp matrix,
    as the "smem" kernel assigns them: rows ``ti + rp/4 * i`` (a quarter
    warp's lanes share them), columns ``4 tj .. 4 tj + 3``."""
    tpr = rp // 4
    ti, tj = divmod(tile, tpr)
    return (tuple(ti + tpr * i for i in range(4)),
            tuple(4 * tj + c for c in range(4)))


def _cayley_engine(r: int) -> str:
    """The engine of a cayley_neumann launch on the card: ``"smem"`` (the
    whole series in shared memory, one launch a stack, exact fp32 on the
    CUDA cores) up to :data:`CAYLEY_SMEM_MAX_R`, ``"tc"`` (one 3xTF32
    tensor-core product a Horner step) above."""
    return "smem" if r <= CAYLEY_SMEM_MAX_R else "tc"


def _cayley(q: torch.Tensor, terms: int):
    """(R, series) of :func:`repro_torch.kernels.ref.cayley_neumann_series`
    for dense fp32 Q (..., r, r): one call per stack, the leading dims
    flattened into the kernel's layer axis, on :func:`_cayley_engine`'s
    engine."""
    if _on_cpu(q):
        return ref.cayley_neumann_series(q, terms)
    r = q.shape[-1]
    if q.ndim < 2 or q.shape[-2] != r or terms < 0:
        raise ValueError(f"q must be (..., r, r), got {tuple(q.shape)}; "
                         f"terms {terms}")
    engine = _cayley_engine(r)
    q3 = q.reshape(-1, r, r).contiguous()
    n_mat = q3.shape[0]
    series = torch.empty((terms, n_mat, r, r), dtype=torch.float32,
                         device=q.device)
    rot = torch.empty((n_mat, r, r), dtype=torch.float32, device=q.device)
    _launch("cayley_neumann", _CAYLEY_ENGINE_CODE[engine],
            _float_arg(q3, "q", torch.float32, 3), series.data_ptr(),
            rot.data_ptr(), n_mat, r, terms,
            cayley_smem_plan(n_mat, r).per_block, _stream(q.device))
    CAYLEY_ENGINE_LAUNCHES[engine] += 1
    return rot.reshape(q.shape), series.reshape((terms,) + tuple(q.shape))


class _CayleyNeumann(torch.autograd.Function):
    """R = (I - Q) sum_{k<=K} (-Q)^k with an exact backward: the reverse
    Horner recursion over the saved partial sums S_0 = I, S_1 .. S_K, in
    plain torch (the reference differentiates its jnp series instead).
    With G = dL/dR:  dS_K = (I - Q)^T G,  dQ = -G S_K^T;  then for
    k = K .. 1:  dQ -= dS_k S_{k-1}^T,  dS_{k-1} = -Q^T dS_k."""

    @staticmethod
    def forward(ctx, q, terms):
        rot, series = _cayley(q, terms)
        ctx.terms = terms
        ctx.save_for_backward(q, series)
        return rot

    @staticmethod
    def backward(ctx, g):
        q, series = ctx.saved_tensors
        terms = ctx.terms
        g = g.to(torch.float32)
        qt = q.transpose(-1, -2)
        eye = torch.eye(q.shape[-1], dtype=torch.float32, device=q.device)

        def s_at(k):
            return series[k - 1] if k > 0 else eye

        dq = -(g @ s_at(terms).transpose(-1, -2))
        ds = g - qt @ g
        for k in range(terms, 0, -1):
            dq = dq - ds @ s_at(k - 1).transpose(-1, -2)
            ds = -(qt @ ds)
        return dq.expand_as(q), None


def cayley_neumann(q: torch.Tensor, terms: int = 5) -> torch.Tensor:
    """Cayley-Neumann rotation of dense Q (..., r, r), fp32: one kernel
    launch for the whole leading (layer-stack) batch.  Differentiable in q
    (see :class:`_CayleyNeumann`)."""
    return _CayleyNeumann.apply(q.to(torch.float32), terms)


# ---------------------------------------------------------------------------
# the OFT family: block-diagonal input rotation
# ---------------------------------------------------------------------------

#: blockdiag_rotate tiles (csrc/blockdiag_rotate.cu): output columns a
#: block owns at most, depth chunk above that block size, rows of a tile
BLOCKDIAG_COLS = 128
BLOCKDIAG_DEPTH = 64
BLOCKDIAG_ROWS = 64
#: blocks the "mma" engine aims for: three of its 62 KB blocks per SM of an
#: H100 at b = 32
BLOCKDIAG_TARGET_BLOCKS = 3 * 132


def blockdiag_block_columns(d: int, b: int, cb: int
                            ) -> Tuple[int, int, int, int]:
    """(first group g0, groups ng, first column c0, width sw) of column
    block ``cb``, as both rotation engines split d: 128 // b whole groups a
    block up to b = 128 (each contributing its b columns), else one
    128-column slice [c0, c0 + sw) of one group."""
    nb = d // b
    if b <= BLOCKDIAG_COLS:
        gpb = BLOCKDIAG_COLS // b
        return cb * gpb, min(gpb, nb - cb * gpb), 0, b
    slices = _cdiv(b, BLOCKDIAG_COLS)
    c0 = cb % slices * BLOCKDIAG_COLS
    return cb // slices, 1, c0, min(BLOCKDIAG_COLS, b - c0)


class BlockdiagPlan(NamedTuple):
    """The grid of a blockdiag_rotate launch: ``col_blocks`` column blocks
    (:func:`blockdiag_block_columns`), each group's depth walked in
    ``chunks`` chunks of :data:`BLOCKDIAG_DEPTH` above 128 (one below);
    ``row_tiles`` tiles of :data:`BLOCKDIAG_ROWS` rows, ``tiles_per_block``
    of them a block of the "mma" engine (one a block on "simt"), in
    ``row_blocks`` row blocks."""
    col_blocks: int
    chunks: int
    row_tiles: int
    tiles_per_block: int
    row_blocks: int


def blockdiag_plan(m: int, d: int, b: int) -> BlockdiagPlan:
    """The "mma" engine's grid for x (m, d) and blocks of b: as few row
    tiles a block as keep :data:`BLOCKDIAG_TARGET_BLOCKS` blocks, counting
    each depth chunk as a tile (one row tile a block at 4 chunks)."""
    nb = d // b
    col_blocks = _cdiv(nb, BLOCKDIAG_COLS // b) if b <= BLOCKDIAG_COLS \
        else nb * _cdiv(b, BLOCKDIAG_COLS)
    chunks = 1 if b <= BLOCKDIAG_COLS else _cdiv(b, BLOCKDIAG_DEPTH)
    row_tiles = _cdiv(m, BLOCKDIAG_ROWS)
    tpb = max(1, min(row_tiles, _cdiv(row_tiles * col_blocks,
                                      BLOCKDIAG_TARGET_BLOCKS) // chunks))
    return BlockdiagPlan(col_blocks, chunks, row_tiles, tpb,
                         _cdiv(row_tiles, tpb))


def _blockdiag_engine(x_dtype: torch.dtype, rots_dtype: torch.dtype, b: int,
                      aligned: bool) -> str:
    """The engine of a blockdiag_rotate launch on the card: ``"mma"``
    (bf16 products on the tensor cores) for bf16 x and rotations, b a
    multiple of 16 and 16-byte aligned arrays; ``"simt"`` (exact fp32 on
    the CUDA cores) for everything else.  Both take any b that divides d;
    neither ever stands in for the other."""
    if x_dtype == rots_dtype == torch.bfloat16 and b % 16 == 0 and aligned:
        return "mma"
    return "simt"


def _rotate(x: torch.Tensor, rots: torch.Tensor,
            transpose: bool) -> torch.Tensor:
    """One blockdiag_rotate launch: x (M, d) by rots (d/b, b, b)."""
    if _on_cpu(x, rots):
        return ref.blockdiag_rotate(x, rots, transpose)
    code = _compute_code(x.dtype)
    if rots.dtype not in (torch.float32, x.dtype):
        raise TypeError(f"rots: dtype {rots.dtype}, expected float32 or "
                        f"x's {x.dtype}")
    m, d = x.shape
    if rots.ndim != 3 or rots.shape[1] != rots.shape[2] or \
            rots.shape[0] * rots.shape[2] != d:
        raise ValueError(f"shapes x {tuple(x.shape)}, rots "
                         f"{tuple(rots.shape)}: rots must be (d/b, b, b)")
    b = rots.shape[2]
    y = torch.empty_like(x)
    ptrs = [_float_arg(x, "x", x.dtype, 2),
            _float_arg(rots, "rots", rots.dtype, 3), y.data_ptr()]
    engine = _blockdiag_engine(x.dtype, rots.dtype, b,
                               all(p % 16 == 0 for p in ptrs))
    _launch("blockdiag_rotate", code, _compute_code(rots.dtype),
            _BLOCKDIAG_ENGINE_CODE[engine], int(transpose), *ptrs, m, d, b,
            blockdiag_plan(m, d, b).tiles_per_block, _stream(x.device))
    BLOCKDIAG_ENGINE_LAUNCHES[engine] += 1
    return y


class _BlockdiagRotate(torch.autograd.Function):
    """y_g = x_g R_g (R_g^T when transposed) for every block g.  dx is the
    kernel's launch with the other orientation, and only where autograd
    asks for it; dR_g = x_g^T dy_g (dy_g^T x_g when transposed) is a plain
    batched fp32 product, as XLA differentiates the reference's einsum."""

    @staticmethod
    def forward(ctx, x, rots, transpose):
        ctx.transpose = transpose
        ctx.save_for_backward(x, rots)
        return _rotate(x, rots, transpose)

    @staticmethod
    def backward(ctx, dy):
        x, rots = ctx.saved_tensors
        need_x, need_rots, _ = ctx.needs_input_grad
        dy = dy.contiguous()
        dx = drots = None
        if need_x:
            dx = _rotate(dy, rots, not ctx.transpose)
        if need_rots:
            m = x.shape[0]
            nb, b = rots.shape[0], rots.shape[-1]
            xg = x.float().reshape(m, nb, b).transpose(0, 1)
            dyg = dy.float().reshape(m, nb, b).transpose(0, 1)
            if ctx.transpose:
                xg, dyg = dyg, xg
            drots = (xg.transpose(1, 2) @ dyg).to(rots.dtype)
        return dx, drots, None


def blockdiag_rotate(x: torch.Tensor, rots: torch.Tensor, *,
                     transpose: bool = False) -> torch.Tensor:
    """Block-diagonal rotation of 2-D x (M, d) by rots (d/b, b, b):
    ``y[:, g*b:(g+1)*b] = x[:, g*b:(g+1)*b] @ R_g`` (``R_g^T`` with
    ``transpose``).  rots in fp32 or x's dtype, fp32 accumulation, y in x's
    dtype.  Differentiable in x and rots (see :class:`_BlockdiagRotate`)."""
    return _BlockdiagRotate.apply(x.contiguous(), rots.contiguous(),
                                  transpose)
