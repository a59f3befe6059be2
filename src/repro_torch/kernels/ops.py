"""Wrappers of the port's hand-written Hopper kernels.

Each wrapper takes tensors on one device.  On the CPU it returns the plain
PyTorch version (:mod:`repro_torch.kernels.ref`); on a CUDA tensor it checks
device, dtype, shape and contiguity, allocates the outputs with
``torch.empty``, launches the kernel on the current stream and raises if the
launch failed.  Nothing gives way to the plain version when a build or a
launch fails.

:data:`LAUNCHES` counts kernel launches per wrapper (CPU calls are not
launches), so a run can show that its main path went through the kernels.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from repro_torch.kernels import build, ref

#: kernel launches per wrapper since the last :func:`reset_launches`
LAUNCHES: Dict[str, int] = {"paged_decode_attention": 0,
                            "paged_prefill_attention": 0,
                            "gather_delta_matmul": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


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


def paged_decode_attention(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, page_table: torch.Tensor,
                           lengths: torch.Tensor) -> torch.Tensor:
    """One-token GQA over block-paged KV pools.

    q (B, H, D); pools (P, pg, KH, D); page_table (B, maxp); lengths (B,).
    Page ids outside [0, P) are clamped.  Returns (B, H, D) in q's dtype."""
    if _on_cpu(q, k_pool, v_pool, page_table, lengths):
        return ref.paged_decode_attention(q, k_pool, v_pool, page_table,
                                          lengths)
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
    out = torch.empty_like(q)
    _launch("paged_decode_attention", code,
            _float_arg(q, "q", q.dtype, 3),
            _float_arg(k_pool, "k_pool", q.dtype, 4),
            _float_arg(v_pool, "v_pool", q.dtype, 4),
            pt.data_ptr(), ln.data_ptr(), out.data_ptr(),
            b, h, kh, d, p, pg, maxp, _stream(q.device))
    return out


def paged_prefill_attention(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, k_pool: torch.Tensor,
                            v_pool: torch.Tensor, prefix_table: torch.Tensor,
                            prefix_len: torch.Tensor) -> torch.Tensor:
    """Suffix prefill: causal suffix over a block-paged prefix.

    q (B, S, H, D); k/v (B, S, KH, D) post-RoPE; pools (P, pg, KH, D);
    prefix_table (B, maxp); prefix_len (B,), any alignment.  An empty table
    is padded to one trash column with prefix_len 0."""
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
    out = torch.empty_like(q)
    _launch("paged_prefill_attention", code,
            _float_arg(q, "q", q.dtype, 4), _float_arg(k, "k", q.dtype, 4),
            _float_arg(v, "v", q.dtype, 4),
            _float_arg(k_pool, "k_pool", q.dtype, 4),
            _float_arg(v_pool, "v_pool", q.dtype, 4),
            pt.data_ptr(), pl.data_ptr(), out.data_ptr(),
            b, s, h, kh, d, p, pg, maxp, _stream(q.device))
    return out


def gather_delta_matmul(x: torch.Tensor, w: torch.Tensor, left: torch.Tensor,
                        right: torch.Tensor, ids: torch.Tensor, *,
                        compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Per-row gathered low-rank delta matmul for decode.

    y[b] = x[b] @ W + (x[b] @ left[ids[b]]) @ right[ids[b]]; x (B, K),
    W (K, N), left (A, K, r), right (A, r, N).  x, W and left are cast to
    ``compute_dtype``; right stays fp32.  Adapter ids outside [0, A) are
    clamped.  Returns (B, N) in ``compute_dtype``."""
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
    u = torch.empty((bsz, r), dtype=torch.float32, device=x.device)
    y = torch.empty((bsz, n), dtype=compute_dtype, device=x.device)
    _launch("gather_delta_matmul", code,
            _float_arg(x, "x", compute_dtype, 2),
            _float_arg(w, "w", compute_dtype, 2),
            _float_arg(left, "left", compute_dtype, 3),
            _float_arg(right, "right", torch.float32, 3),
            idx.data_ptr(), u.data_ptr(), y.data_ptr(),
            bsz, kdim, n, r, a, _stream(x.device))
    return y
