#!/usr/bin/env python3
"""On-card check of the PyTorch port (``src/repro_torch``): multi-tenant
paged PSOFT serving, and fine-tuning with PSOFT and every baseline method
of the paper, on one NVIDIA GPU.

    python3 chip_smoke.py [--layers N] [--profile] [--out PATH]

Phases, each of which raises (non-zero exit) on a failed check:

1. device: needs ``torch.cuda.is_available()``; prints the card's name and
   power limit (nvidia-smi) and builds the six CUDA kernels from the
   checkout's sources (nvcc, in parallel), printing the build time and
   each kernel's registers, shared memory and spills (``-Xptxas -v``); the
   redesigned kernels (split decode, the Hopper GEMM engine and its fp32
   rotation, the three gather-delta launches, the tensor-core prefill) must
   not spill;
2. kernels: at llama32-3b shapes, bf16 and fp32, each kernel against its
   plain PyTorch version on the card, with edge cases, and each limit shown
   to reject a known fault (a dropped last page, a dropped middle page in
   every row longer than one decode split, a dropped prefix tail, the
   causal diagonal masked, the prefix chunk holding the last prefix token
   dropped, a row on the wrong adapter, the last K split of W dropped, the
   rank-r term on only the first row of each adapter, a dropped rank-r
   term or its partial last depth step, a Horner step short, a block
   rotation replaced by I or transposed); every bf16 psoft_matmul check on
   the wgmma engine and every bf16 prefill on the tensor-core ("mma")
   engine, fp32 on the CUDA cores; the training wrappers' grads against
   autograd of the plain
   versions; one JSON line per kernel with its time, the plain version's,
   a library yardstick's and the least time the card could take (bytes
   over 3.35 TB/s or flops over the peak for the dtype, whichever is
   larger); psoft_matmul's three launches timed apart (torch.profiler) with
   the output product's share of the bf16 peak; gather_delta_matmul's time
   per linear beside its own byte bound;
3. serve: llama32-3b at full width (28 layers unless ``--layers`` cuts
   depth; widths are never cut), seven PSOFT linears per layer in bf16,
   random weights from a seed, two adapters sharing the frozen factors;
   ~24 requests through ``ServeEngine(slots=8, page_size=16,
   max_len=512)``; checks completion, page accounting, prefix
   hits, that every serving kernel launched (gather_delta_matmul exactly 7
   per layer per decode step, every prefill on the "mma" engine), and
   run-to-run token identity;
4. card vs CPU: the same ``tiny`` (fp32) engine run on the card and on the
   CPU gives identical greedy tokens and admissions, every card prefill on
   the fp32 ("simt") engine;
5. train: the serve phase's llama32-3b params (same depth) split by the
   PEFT mask, ``remat_policy="full"``, 8 x 256 synthetic tokens a step,
   one warm-up and 5 timed steps of ``make_train_step``; checks finite
   losses and grad norms, frozen leaves bit-identical, every trainable leaf
   moved, and exact launches on every step (psoft_matmul 3x per PSOFT
   linear: forward, remat recompute, backward, every one on the wgmma
   engine; cayley_neumann once per linear stack);
6. train card vs CPU: ``tiny`` (fp32), 5 steps from one state on the card
   and on the CPU agree within 1e-4 relative, and the tuned tree's logits
   equal its merged tree's on the card;
7. OFT train: llama32-3b at full width (depth as in 3), OFT with blocks of
   32 on all seven linears, random weights (no SVD) with ``q`` nudged off
   zero, the same traffic and checks as 5; blockdiag_rotate launches
   exactly 3x per linear but for layer 0's q, k and v (no dx: their input
   depends on no trainable), cayley_neumann once per linear stack;
8. baselines: BOFT (b 8, m 2), GOFT, qGOFT, PiSSA (r 8), DoRA (r 8) and
   LoRA-XS (r 136) at full width and 2 layers, one warm-up and 2 timed
   steps each, the same checks (exact blockdiag_rotate and cayley_neumann
   counts for the OFT family), each run freed before the next;
9. baselines card vs CPU: ``tiny`` (fp32), 3 steps of OFT and of GOFT on
   the card and on the CPU agree within 1e-4 relative, and merge.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""
from __future__ import annotations

import argparse
import gc
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12            # H100 SXM HBM3
PEAK_FLOPS = {"bfloat16": 989e12,     # dense tensor-core bf16
              "float32": 67e12}       # fp32 outside the tensor cores
#: |got - want| <= atol + TOL * |want|, elementwise; atol is TOL for fp32
#: and TOL * rms(want) for bf16, so the bf16 limit stays well below a
#: typical output whatever the inputs' scale (bf16 output rounding alone
#: reaches 2**-8 * |want|)
TOL = {"bfloat16": 2e-2, "float32": 1e-4}
#: cycles the stream spins while the host enqueues a timed batch (~0.5 s)
HOLD_CYCLES = 1_000_000_000
REPLACES = {
    "paged_decode_attention":
        "src/repro/kernels/paged_decode_attention.py:69",
    "paged_prefill_attention":
        "src/repro/kernels/paged_prefill_attention.py:96",
    "gather_delta_matmul": "src/repro/kernels/gather_delta_matmul.py:39",
    "psoft_matmul": "src/repro/kernels/psoft_matmul.py:50",
    "cayley_neumann": "src/repro/kernels/cayley_kernel.py:31",
    "blockdiag_rotate": "src/repro/kernels/blockdiag_rotate.py:34",
}
SERVE_KERNELS = ("paged_decode_attention", "paged_prefill_attention",
                 "gather_delta_matmul")
TRAIN_KERNELS = ("psoft_matmul", "cayley_neumann")
#: the paper's baselines (benchmarks/common.py's method_cfgs at the
#: paper's ranks): OFT trains at full depth, the others at METHOD_LAYERS
BASELINES = {"oft": dict(oft_block_size=32),
             "boft": dict(boft_blocks=8, boft_factors=2),
             "goft": {}, "qgoft": {}, "pissa": dict(rank=8),
             "dora": dict(rank=8), "lora_xs": dict(rank=136)}
METHOD_LAYERS, METHOD_STEPS = 2, 2
#: llama32-3b training shapes: 8 sequences of 256 tokens, PSOFT r = 352
TRAIN_TOKENS, TRAIN_BATCH, TRAIN_SEQ, RANK = 2048, 8, 256, 352


class CheckFailed(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise CheckFailed(what)


def gpu_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def ptxas_summary(log: str):
    """Per kernel of an ``nvcc -Xptxas -v`` log: its mangled name, its
    registers, static shared memory and spill bytes."""
    import re
    out = []
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            out.append(dict(entry=m.group(1), registers=None, smem=0,
                            spill_stores=0, spill_loads=0))
            continue
        if not out:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out[-1].update(spill_stores=int(m.group(1)),
                           spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[-1]["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            out[-1]["smem"] = int(sm.group(1)) if sm else 0
    return out


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

def time_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` per call: CUDA events around each call,
    the 50 MB L2 cache flushed before every call (the serving loop meets
    each layer's weights and pages cold).  The stream is held busy while
    the host enqueues every timed call, so the events see the device work
    and not the host's launch overhead; a hold the host outlasted is
    retried four times longer."""
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    hold = HOLD_CYCLES
    for _ in range(3):
        starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
        ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
        hold_start = torch.cuda.Event(enable_timing=True)
        hold_end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hold_start.record()
        torch.cuda._sleep(hold)
        hold_end.record()
        for i in range(iters):
            flush.zero_()
            starts[i].record()
            fn()
            ends[i].record()
        enqueue_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        if enqueue_ms < hold_start.elapsed_time(hold_end):
            return sum(s.elapsed_time(e)
                       for s, e in zip(starts, ends)) / iters
        hold *= 4
    raise CheckFailed(f"timing: enqueueing took {enqueue_ms:.1f} ms, longer "
                      f"than every stream hold")


def bound(nbytes: float, flops: float, dtype: str):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def decode_inputs(torch, dtype, gen, lengths):
    """llama32-3b decode: 8 slots, 24 heads over 8 KV heads, head_dim 128,
    pages of 16, max_len 512.  Rows 2 and 3 share their first pages
    (aliased prefix), ids are scattered over the pool, row lengths include
    0 and 1."""
    b, h, kh, d, pg, maxp = len(lengths), 24, 8, 128, 16, 32
    pages = 1 + b * maxp
    q = torch.randn((b, h, d), generator=gen, device="cuda").to(dtype)
    kp = (torch.randn((pages, pg, kh, d), generator=gen, device="cuda")
          * 0.5).to(dtype)
    vp = (torch.randn((pages, pg, kh, d), generator=gen, device="cuda")
          * 0.5).to(dtype)
    table = (torch.randperm(pages - 1, generator=gen, device="cuda")[
        :b * maxp] + 1).reshape(b, maxp).to(torch.int32)
    table[3, :3] = table[2, :3]
    ln = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    return q, kp, vp, table, ln


def prefill_inputs(torch, dtype, gen, prefix, s):
    """llama32-3b prefill group: 4 rows of a 64-token suffix bucket over a
    full-width prefix table; prefixes of two full pages, none, one ending
    mid-page."""
    b, h, kh, d, pg, maxp = len(prefix), 24, 8, 128, 16, 32
    pages = 1 + b * maxp
    q = torch.randn((b, s, h, d), generator=gen, device="cuda").to(dtype)
    k = (torch.randn((b, s, kh, d), generator=gen, device="cuda")
         * 0.5).to(dtype)
    v = (torch.randn((b, s, kh, d), generator=gen, device="cuda")
         * 0.5).to(dtype)
    kp = (torch.randn((pages, pg, kh, d), generator=gen, device="cuda")
          * 0.5).to(dtype)
    vp = (torch.randn((pages, pg, kh, d), generator=gen, device="cuda")
          * 0.5).to(dtype)
    table = (torch.randperm(pages - 1, generator=gen, device="cuda")[
        :b * maxp] + 1).reshape(b, maxp).to(torch.int32)
    table[3, :2] = table[0, :2]
    plen = torch.tensor(prefix, dtype=torch.int32, device="cuda")
    return q, k, v, kp, vp, table, plen


#: K -> N of the seven banked linears of one llama32-3b layer
LLAMA_LINEARS = (("q", 3072, 3072), ("k", 3072, 1024), ("v", 3072, 1024),
                 ("o", 3072, 3072), ("gate", 3072, 8192),
                 ("up", 3072, 8192), ("down", 8192, 3072))


def delta_inputs(torch, dtype, gen, k, n, ids, r=352, a=3):
    x = torch.randn((len(ids), k), generator=gen, device="cuda").to(dtype)
    w = (torch.randn((k, n), generator=gen, device="cuda")
         / k ** 0.5).to(dtype)
    left = (torch.randn((a, k, r), generator=gen, device="cuda")
            / k ** 0.5).to(dtype)
    right = torch.randn((a, r, n), generator=gen, device="cuda") * 0.01
    idt = torch.tensor(ids, dtype=torch.int32, device="cuda")
    return x, w, left, right, idt


def over_limit(torch, got, want, dname, scaled=None):
    """(|got - want|, mask of the elements beyond the dtype's limit).  The
    absolute part is TOL * rms(want) where ``scaled`` (default: for bf16),
    else TOL; gradients, sums over thousands of products whatever their
    dtype, are held to the scaled limit."""
    want = want.float()
    err = (got.float() - want).abs()
    tol = TOL[dname]
    if scaled is None:
        scaled = dname == "bfloat16"
    atol = tol * float(want.square().mean().sqrt()) if scaled else tol
    return err, err > atol + tol * want.abs()


def max_err(torch, got, want, dname, what, scaled=None):
    err, bad = over_limit(torch, got, want, dname, scaled)
    check(not bool(bad.any()),
          f"{what}: {int(bad.sum())} elements outside the {dname} limit "
          f"(max abs err {float(err.max())})")
    return float(err.max())


def must_reject(torch, wrong, want, dname, rows, what, scaled=None):
    """The limit must catch a known fault in every row of ``rows``."""
    _, bad = over_limit(torch, wrong, want, dname, scaled)
    missed = [r for r in rows if not bool(bad[r].any())]
    check(not missed, f"{what}: the {dname} limit misses the fault in rows "
                      f"{missed}")


def last_page_dropped(lengths, pg):
    """Each length cut back to the start of its last (partial) page."""
    return lengths - ((lengths - 1).clamp_min(0) % pg + 1) * (lengths > 0)


def middle_page_dropped(table, lengths, pg, rows):
    """(table, lengths) without the middle page (index npages // 2, a full
    page) of each row of ``rows``: later columns shift left by one, the
    length falls by pg."""
    table, lengths = table.clone(), lengths.clone()
    for i in rows:
        j = -(-int(lengths[i]) // pg) // 2
        table[i, j:-1] = table[i, j + 1:].clone()
        lengths[i] -= pg
    return table, lengths


def distinct_slots(table, lengths, pg) -> int:
    """KV slots a paged kernel must read: distinct (page, offset) pairs
    under the rows' valid tokens (rows that share pages read them once)."""
    seen = set()
    for row, n in zip(table.tolist(), lengths.tolist()):
        seen.update((row[t // pg], t % pg) for t in range(n))
    return len(seen)


def table_entries(lengths, pg) -> int:
    """Page-table entries the kernel reads: ceil(len / pg) per row."""
    return sum(-(-n // pg) for n in lengths.tolist())


#: keys per chunk of the bf16 prefill kernel (csrc/paged_prefill_attention.cu)
PREFILL_CHUNK_KEYS = 64


def prefill_diagonal_masked(torch, ref, q, k, v, kp, vp, table, plen):
    """The plain prefill with the causal diagonal masked (query i sees the
    suffix keys j < i only): a planted fault."""
    b, s, h, d = q.shape
    pg, kh, maxp = kp.shape[1], kp.shape[2], table.shape[1]
    flat = table.reshape(-1).long()
    kc = torch.cat([kp[flat].reshape(b, maxp * pg, kh, d), k], 1).float()
    vc = torch.cat([vp[flat].reshape(b, maxp * pg, kh, d), v], 1).float()
    qg = q.reshape(b, s, kh, h // kh, d).float()
    scores = torch.einsum("bskgd,btkd->bskgt", qg, kc) / math.sqrt(d)
    spre = maxp * pg
    pre = (torch.arange(spre, device=q.device)[None, None, :]
           < plen.reshape(-1, 1, 1).long()).expand(b, s, spre)
    ar = torch.arange(s, device=q.device)
    suf = (ar[:, None] > ar[None, :])[None].expand(b, s, s)
    ok = torch.cat([pre, suf], -1)[:, :, None, None, :]
    p = ref._masked_softmax_weights(scores, ok)
    out = torch.einsum("bskgt,btkd->bskgd", p, vc) / \
        p.sum(-1, keepdim=True).clamp_min(1e-30)
    return out.reshape(b, s, h, d).to(q.dtype)


def first_of_each_adapter(ids, group):
    """Rows that are the first of their adapter in their row group of
    ``group`` rows (the kernel's row groups)."""
    first, seen = [], set()
    for i, a in enumerate(ids):
        if i % group == 0:
            seen = set()
        if a not in seen:
            first.append(i)
            seen.add(a)
    return first


def kernel_phase(torch, ops, ref, F):
    """Correctness at every dtype and edge case; timing in bf16 (the serving
    dtype) at the main path's shapes."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    results = {}
    dec_lengths = [0, 1, 77, 130, 256, 300, 511, 45]
    pre_prefix, pre_s = [32, 0, 45, 32], 64
    delta_ids = [0, 1, 2, 1, 0, 2, 2, 1]
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).replace("torch.", "")
        errs = {}
        # decode: lengths 0 and 1, shared and scattered page ids
        args = decode_inputs(torch, dtype, gen, dec_lengths)
        got = ops.paged_decode_attention(*args)
        torch.cuda.synchronize()
        check(bool((got[0] == 0).all()), "decode: a length-0 row must be 0")
        want = ref.paged_decode_attention(*args)
        errs["paged_decode_attention"] = max_err(
            torch, got, want, dname, f"paged_decode_attention {dname}")
        q, kp, vp, table, ln = args
        must_reject(torch, ref.paged_decode_attention(
            q, kp, vp, table, last_page_dropped(ln, 16)), want, dname,
            [i for i, n in enumerate(dec_lengths) if n > 0],
            "paged_decode_attention, each row's last page dropped")
        split = ops.decode_split_plan(len(dec_lengths), 8, 32)[0] * 16
        long_rows = [i for i, n in enumerate(dec_lengths) if n > split]
        must_reject(torch, ref.paged_decode_attention(
            q, kp, vp, *middle_page_dropped(table, ln, 16, long_rows)),
            want, dname, long_rows,
            "paged_decode_attention, a middle page dropped in each row "
            "longer than one split")
        # prefill: mid-page prefix, no prefix, aliased pages; then an empty
        # prefix table and a single suffix token; bf16 on the tensor-core
        # engine, fp32 on the CUDA cores
        engine = "mma" if dtype == torch.bfloat16 else "simt"
        ops.reset_launches()
        args = prefill_inputs(torch, dtype, gen, pre_prefix, pre_s)
        want = ref.paged_prefill_attention(*args)
        e = max_err(torch, ops.paged_prefill_attention(*args), want, dname,
                    f"paged_prefill_attention {dname}")
        q, k, v, kp, vp, table, plen = args
        pre_rows = [i for i, n in enumerate(pre_prefix) if n > 0]
        must_reject(torch, ref.paged_prefill_attention(
            q, k, v, kp, vp, table, last_page_dropped(plen, 16)),
            want, dname, pre_rows,
            "paged_prefill_attention, each prefix's last page dropped")
        must_reject(torch, ref.paged_prefill_attention(
            q, k, v, kp, vp, table,
            last_page_dropped(plen, PREFILL_CHUNK_KEYS)), want, dname,
            pre_rows, "paged_prefill_attention, the prefix chunk holding "
                      "each prefix's last token dropped")
        must_reject(torch, prefill_diagonal_masked(
            torch, ref, q, k, v, kp, vp, table, plen), want, dname,
            range(len(pre_prefix)),
            "paged_prefill_attention, the causal diagonal masked")
        empty = table[:, :0]
        e = max(e, max_err(
            torch, ops.paged_prefill_attention(q, k, v, kp, vp, empty, plen),
            ref.paged_prefill_attention(q, k, v, kp, vp, table[:, :1],
                                        torch.zeros_like(plen)),
            dname, f"paged_prefill_attention empty table {dname}"))
        one = [t[:, :1].contiguous() for t in (q, k, v)]
        e = max(e, max_err(
            torch, ops.paged_prefill_attention(*one, kp, vp, table, plen),
            ref.paged_prefill_attention(*one, kp, vp, table, plen), dname,
            f"paged_prefill_attention one suffix token {dname}"))
        check(ops.PREFILL_ENGINE_LAUNCHES[engine] == 3 ==
              ops.LAUNCHES["paged_prefill_attention"],
              f"paged_prefill_attention {dname}: ran on "
              f"{ops.PREFILL_ENGINE_LAUNCHES}, expected the {engine} engine")
        errs["paged_prefill_attention"] = e
        # gather-delta: every llama32-3b linear shape, rows on different
        # adapters
        e = 0.0
        for name, kdim, n in LLAMA_LINEARS:
            x, w, left, right, idt = delta_inputs(torch, dtype, gen, kdim, n,
                                                  delta_ids)
            got = ops.gather_delta_matmul(x, w, left, right, idt,
                                          compute_dtype=dtype)
            want = ref.gather_delta_matmul(idt, x, w, left, right)
            e = max(e, max_err(torch, got, want, dname,
                               f"gather_delta_matmul {name} {dname}"))
            must_reject(torch, ref.gather_delta_matmul(
                (idt + 1) % left.shape[0], x, w, left, right), want, dname,
                range(len(delta_ids)),
                f"gather_delta_matmul {name}, each row on the wrong adapter")
            plan = ops.gather_delta_plan(len(delta_ids), kdim, n,
                                         left.shape[2])
            w_cut = w.clone()
            w_cut[(plan.k_splits - 1) * plan.k_rows:] = 0
            must_reject(torch, ref.gather_delta_matmul(
                idt, x, w_cut, left, right), want, dname,
                range(len(delta_ids)),
                f"gather_delta_matmul {name}, the last K split's rows of W "
                f"dropped")
            first = first_of_each_adapter(delta_ids, ops.GATHER_DELTA_ROWS)
            one_each = ref.gather_delta_matmul(idt, x, w, left, right * 0)
            one_each[first] = want[first]
            must_reject(torch, one_each, want, dname,
                        [i for i in range(len(delta_ids)) if i not in first],
                        f"gather_delta_matmul {name}, the rank-r term on only "
                        f"the first row of each adapter")
        errs["gather_delta_matmul"] = e
        torch.cuda.synchronize()
        for kname, err in errs.items():
            results.setdefault(kname, {})[f"max_err_{dname}"] = err

    # timing, bf16 at the main path's shapes
    dt, dname = torch.bfloat16, "bfloat16"
    elt = 2
    q, kp, vp, table, ln = decode_inputs(torch, dt, gen, dec_lengths)
    h, kh, d = 24, 8, 128
    tok = sum(dec_lengths)
    # q in, out back, each distinct K/V slot once, the table entries read
    nbytes = (2 * q.numel() * elt
              + 2 * distinct_slots(table, ln, 16) * kh * d * elt
              + table_entries(ln, 16) * 4 + ln.numel() * 4)
    flops = 4 * tok * h * d
    # SDPA over the same K/V gathered contiguous beforehand (untimed)
    maxlen = max(dec_lengths)
    kg = ref_gather(torch, kp, table, maxlen, h // kh)
    vg = ref_gather(torch, vp, table, maxlen, h // kh)
    mask = (torch.arange(maxlen, device="cuda")[None, :]
            < ln[:, None].long())[:, None, None, :]
    qs = q[:, :, None, :]
    results["paged_decode_attention"].update(
        ms=time_ms(torch, lambda: ops.paged_decode_attention(
            q, kp, vp, table, ln)),
        plain_ms=time_ms(torch, lambda: ref.paged_decode_attention(
            q, kp, vp, table, ln)),
        library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
            qs, kg, vg, attn_mask=mask)),
        library="torch.nn.functional.scaled_dot_product_attention over "
                "K/V gathered contiguous and expanded to all heads "
                "beforehand (untimed)",
        bytes=nbytes, flops=flops,
        shape=f"B={len(dec_lengths)} H={h} KH={kh} D={d} pg=16 maxp=32 "
              f"lengths={dec_lengths}")

    args = prefill_inputs(torch, dt, gen, pre_prefix, pre_s)
    q, k, v, kp, vp, table, plen = args
    b, s = len(pre_prefix), pre_s
    pre_tok = sum(pre_prefix)
    nbytes = (2 * q.numel() * elt + (k.numel() + v.numel()) * elt
              + 2 * distinct_slots(table, plen, 16) * kh * d * elt
              + table_entries(plen, 16) * 4 + b * 4)
    flops = 4 * h * d * (s * pre_tok + b * s * (s + 1) // 2)
    spre = table.shape[1] * 16
    g = h // kh
    kc = torch.cat([ref_gather(torch, kp, table, spre, g),
                    k.transpose(1, 2).repeat_interleave(g, dim=1)], 2)
    vc = torch.cat([ref_gather(torch, vp, table, spre, g),
                    v.transpose(1, 2).repeat_interleave(g, dim=1)], 2)
    ar = torch.arange(s, device="cuda")
    pmask = torch.arange(spre, device="cuda")[None, None, :] < \
        plen[:, None, None].long()
    cmask = (ar[:, None] >= ar[None, :])[None].expand(b, s, s)
    amask = torch.cat([pmask.expand(b, s, spre), cmask], -1)[:, None]
    qt = q.transpose(1, 2)
    results["paged_prefill_attention"].update(
        ms=time_ms(torch, lambda: ops.paged_prefill_attention(*args)),
        plain_ms=time_ms(torch, lambda: ref.paged_prefill_attention(*args)),
        library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kc, vc, attn_mask=amask)),
        library="torch.nn.functional.scaled_dot_product_attention over "
                "prefix + suffix K/V gathered contiguous and expanded to all "
                "heads beforehand (untimed)",
        bytes=nbytes, flops=flops,
        shape=f"B={b} S={s} H={h} KH={kh} D={d} pg=16 maxp=32 "
              f"prefix={pre_prefix}")

    tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bytes=0, flops=0)
    per_shape = {}
    distinct = len(set(delta_ids))
    r, bsz = 352, len(delta_ids)
    for name, kdim, n in LLAMA_LINEARS:
        x, w, left, right, idt = delta_inputs(torch, dt, gen, kdim, n,
                                              delta_ids)
        one = dict(
            ms=time_ms(torch, lambda: ops.gather_delta_matmul(
                x, w, left, right, idt, compute_dtype=dt)),
            plain_ms=time_ms(torch, lambda: ref.gather_delta_matmul(
                idt, x, w, left, right)),
            library_ms=time_ms(torch, lambda: torch.matmul(x, w)),
            bytes=(bsz * kdim * elt + kdim * n * elt
                   + distinct * kdim * r * elt + distinct * r * n * 4
                   + bsz * 4 + bsz * n * elt),
            flops=2 * bsz * (kdim * n + kdim * r + r * n))
        one["bound_ms"], one["bound_by"] = bound(one["bytes"], one["flops"],
                                                 dname)
        one["bound_share"] = one["bound_ms"] / one["ms"]
        per_shape[name] = one
        for key in tot:
            tot[key] += one[key]
    results["gather_delta_matmul"].update(
        tot, library="torch.matmul(x, W) alone (no adapter term)",
        per_linear=per_shape,
        shape="one llama32-3b layer's seven banked linears (q k v o gate up "
              f"down), B={bsz}, r={r}, 3 bank columns, ids={delta_ids}")
    for kname, res in results.items():
        res["bound_ms"], res["bound_by"] = bound(res["bytes"], res["flops"],
                                                 dname)
    return results


def ref_gather(torch, pool, table, length, groups):
    """(B, H, length, D) contiguous K or V of each row, each KV head
    repeated for its ``groups`` query heads (yardstick input)."""
    b, maxp = table.shape
    g = pool[table.reshape(-1).long()].reshape(b, maxp * pool.shape[1],
                                               *pool.shape[2:])
    g = g[:, :length].transpose(1, 2)
    return g.repeat_interleave(groups, dim=1).contiguous()


# ---------------------------------------------------------------------------
# phase 3 / 4: serving
# ---------------------------------------------------------------------------

#: PSOFT's trainable leaves
PSOFT_TRAINABLES = ("q", "alpha", "beta")


def nudged(torch, tree, keys, seed, scale, device="cuda"):
    """An adapter of ``tree``: the leaves named ``keys`` of every linear
    moved by seeded noise (new tensors); every other leaf (frozen factors,
    norms, embeddings) is SHARED, never copied."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def rec(node):
        if isinstance(node, dict) and not any(isinstance(v, dict)
                                              for v in node.values()):
            return {k: v + (torch.randn(v.shape, generator=gen,
                                        device=device) * scale
                            ).to(v.dtype) if k in keys else v
                    for k, v in node.items()}
        if isinstance(node, dict):
            return {k: rec(v) for k, v in node.items()}
        return node
    return rec(tree)


def workload(vocab: int, n: int, seed: int):
    """~n requests over base and two adapters; half share a 40-token system
    prompt (more than two pages of 16)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    system = rng.integers(0, vocab, 40).astype(np.int32)
    adapters = ("base", "tuned_a", "tuned_b")
    out = []
    for uid in range(n):
        user = rng.integers(0, vocab, int(rng.integers(8, 72))).astype(
            np.int32)
        prompt = np.concatenate([system, user]) if uid % 2 == 0 else user
        out.append((uid, prompt, int(rng.integers(16, 48)),
                    adapters[uid % 3]))
    return out


def serve_once(torch, serve, params, adapters, cfg, reqs, device, **kw):
    eng = serve.ServeEngine(params, cfg, device=device, **kw)
    for name, tree in adapters.items():
        eng.register_adapter(name, tree)
    t0 = time.perf_counter()
    eng._banked_tree()
    if device == "cuda":
        torch.cuda.synchronize()
    bank_s = time.perf_counter() - t0
    done = eng.run([serve.Request(uid=u, prompt=p, max_new_tokens=n,
                                  adapter=a) for u, p, n, a in reqs],
                   max_steps=4096)
    return eng, done, bank_s


def serve_phase(torch, args, configs, model, serve, ops, gpu_line):
    cfg = configs.get_config("llama32-3b")
    full = cfg.num_layers
    if args.layers and args.layers != full:
        cfg = cfg.replace(num_layers=args.layers)
        print(f"serve: depth cut to {args.layers} of {full} layers "
              f"(widths unchanged)")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = model.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    print(f"serve: init_params llama32-3b {cfg.num_layers} layers, PSOFT r="
          f"{cfg.peft.rank} on 7 linears per layer (one batched fp32 "
          f"torch.linalg.svd per linear stack on the card): "
          f"{init_s:.1f} s")
    adapters = {"tuned_a": nudged(torch, params, PSOFT_TRAINABLES, 1, 0.01),
                "tuned_b": nudged(torch, params, PSOFT_TRAINABLES, 2, 0.01)}
    a, b = adapters["tuned_a"]["layers"]["attn"]["q"], \
        params["layers"]["attn"]["q"]
    check(a["w_res"] is b["w_res"] and a["A"] is b["A"] and a["B"] is b["B"],
          "adapters must share the frozen tensors")
    reqs = workload(cfg.vocab_size, 24, seed=0)
    kw = dict(slots=8, page_size=16, max_len=512)
    ops.reset_launches()
    eng, done, bank_s = serve_once(torch, serve, params, adapters, cfg, reqs,
                                   "cuda", **kw)
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    stats = dict(eng.last_run_stats)
    kv_stats = dict(eng.kv.stats)
    check(len(done) == len(reqs), "every request comes back")
    check(all(r.done and len(r.generated) == r.max_new_tokens
              for r in done), "every request finishes with max_new_tokens")
    check(eng.kv.pages_in_use() == 0, "every page is returned")
    check(kv_stats["prefix_hits"] > 0, "shared prefixes are aliased")
    for name in SERVE_KERNELS:
        check(launches[name] > 0, f"kernel {name} launched on the main path")
    per_step = 7 * cfg.num_layers
    check(launches["gather_delta_matmul"] == per_step * stats["decode_steps"],
          f"gather_delta_matmul launched {launches['gather_delta_matmul']} "
          f"times in {stats['decode_steps']} decode steps, expected exactly "
          f"{per_step} a step")
    prefill_engines = dict(ops.PREFILL_ENGINE_LAUNCHES)
    check(prefill_engines["mma"] == launches["paged_prefill_attention"]
          and prefill_engines["simt"] == 0,
          f"every bf16 prefill on the tensor-core engine ({prefill_engines})")
    toks = {r.uid: list(r.generated) for r in done}
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    del eng, done
    torch.cuda.empty_cache()
    _, again, _ = serve_once(torch, serve, params, adapters, cfg, reqs,
                             "cuda", **kw)
    check({r.uid: list(r.generated) for r in again} == toks,
          "a second identical run gives identical tokens")
    del again
    profile = profile_serve(torch, serve, params, adapters, cfg, reqs, kw,
                            stats) if args.profile else None
    del adapters
    torch.cuda.empty_cache()
    tok_s = stats["decode_tokens"] / stats["decode_s"]
    step_ms = 1e3 * stats["decode_s"] / stats["decode_steps"]
    result = dict(
        layers=cfg.num_layers, requests=len(reqs), init_s=init_s,
        bank_build_s=bank_s, prefill_calls=stats["prefill_calls"],
        prefill_s=stats["prefill_s"], decode_steps=stats["decode_steps"],
        decode_tokens=stats["decode_tokens"], decode_s=stats["decode_s"],
        decode_tokens_per_s=tok_s, mean_decode_step_ms=step_ms,
        engine_steps=stats["steps"], launches=launches,
        prefill_engines=prefill_engines, kv=kv_stats,
        peak_memory_gib=peak_gb, gpu=gpu_line, profile=profile,
        launches_per_decode_step={
            k: launches[k] / stats["decode_steps"]
            for k in ("paged_decode_attention", "gather_delta_matmul")},
        prefill_launches_per_call=launches["paged_prefill_attention"]
        / stats["prefill_calls"])
    print(f"serve: {len(reqs)} requests, {stats['decode_steps']} decode "
          f"steps, {tok_s:.1f} decode tokens/s, {step_ms:.2f} ms mean "
          f"decode step, {stats['prefill_calls']} prefill calls in "
          f"{stats['prefill_s']:.2f} s, prefix hits {kv_stats['prefix_hits']}"
          f", peak {peak_gb:.1f} GiB [{gpu_line}]")
    print(f"serve: launches {launches}; per decode step "
          f"{result['launches_per_decode_step']}, prefill-kernel launches "
          f"per prefill call {result['prefill_launches_per_call']:.2f}, by "
          f"engine {prefill_engines}")
    return result, params


#: ranges the serve profile marks around the engine's prefill and decode
SERVE_RANGES = {"prefill": "chip_smoke.prefill_group",
                "decode": "chip_smoke.decode_step"}
#: the port's serving kernels in each range, as the profile names their
#: CUDA functions: launched through ctypes, they are not attributed to the
#: range they ran in, so each range's device time adds them
RANGE_KERNELS = {
    "prefill": ("prefill_mma_kernel", "paged_prefill_attention_kernel"),
    "decode": ("gather_u_kernel", "gather_out_kernel",
               "gather_finish_kernel", "decode_split_kernel",
               "decode_combine_kernel")}


def marked(torch, fn, label):
    """``fn`` inside a ``torch.profiler.record_function(label)`` range."""
    def run(*a, **k):
        with torch.profiler.record_function(label):
            return fn(*a, **k)
    return run


def profile_serve(torch, serve, params, adapters, cfg, reqs, kw, stats):
    """One more run under torch.profiler: device time by kernel name, the
    device's busy share of the UNPROFILED run's prefill + decode time
    (``stats``; the profiler itself slows the host), and the device time of
    each decode step: the PyTorch kernels launched inside the engine's
    decode call (a profiler range) plus the port's decode kernels."""
    from torch.profiler import ProfilerActivity, profile
    eng = serve.ServeEngine(params, cfg, device="cuda", **kw)
    for name, tree in adapters.items():
        eng.register_adapter(name, tree)
    eng._banked_tree()
    eng._prefill_group = marked(torch, eng._prefill_group,
                                SERVE_RANGES["prefill"])
    eng._decode_live = marked(torch, eng._decode_live,
                              SERVE_RANGES["decode"])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.run([serve.Request(uid=u, prompt=p, max_new_tokens=n, adapter=a)
                 for u, p, n, a in reqs], max_steps=4096)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    events = prof.key_averages()
    # kernel rows only: operator rows repeat their kernels' device time, and
    # the marked ranges' device-side rows span their kernels
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in events
            if str(e.device_type).endswith("CUDA")
            and e.self_device_time_total > 0
            and e.key not in SERVE_RANGES.values()]
    rows.sort(key=lambda r: -r[1])
    if not rows:
        print("profile: the trace holds no device time (not measured)")
        return None
    device_ms = sum(r[1] for r in rows)
    run_ms = 1e3 * (stats["prefill_s"] + stats["decode_s"])
    ranges = {}
    for what, label in SERVE_RANGES.items():
        hits = [e for e in events if e.key == label
                and str(e.device_type).endswith("CPU")]
        if hits and hits[0].device_time_total > 0:
            torch_ms = hits[0].device_time_total / 1e3
            port_ms = sum(ms for k, ms, _ in rows
                          if any(p in k for p in RANGE_KERNELS[what]))
            ranges[what] = dict(device_ms=torch_ms + port_ms,
                                torch_ms=torch_ms, port_kernels_ms=port_ms,
                                calls=hits[0].count)
    decode = ranges.get("decode")
    out = dict(profiled_wall_ms=wall_s * 1e3, device_ms=device_ms,
               unprofiled_run_ms=run_ms, device_busy_share=device_ms / run_ms,
               ranges=ranges,
               decode_step_device_ms=decode["device_ms"] / decode["calls"]
               if decode else None,
               unprofiled_decode_step_ms=1e3 * stats["decode_s"]
               / stats["decode_steps"],
               top=[dict(name=k[:90], ms=ms, calls=n) for k, ms, n in rows[:15]],
               serving_kernels=[dict(name=k[:90], ms=ms, calls=n)
                                for k, ms, n in rows
                                if any(p in k for names in
                                       RANGE_KERNELS.values()
                                       for p in names)])
    print(f"profile: device busy {device_ms:.0f} ms; the unprofiled run's "
          f"prefill + decode took {run_ms:.0f} ms "
          f"({100 * out['device_busy_share']:.1f}% busy; profiled wall "
          f"{out['profiled_wall_ms']:.0f} ms)")
    if decode:
        pre = ranges.get("prefill", {})
        print(f"profile: decode steps {decode['calls']}, "
              f"{out['decode_step_device_ms']:.2f} ms of device time a step "
              f"({decode['torch_ms']:.1f} ms of PyTorch kernels and "
              f"{decode['port_kernels_ms']:.1f} ms of the port's in all) "
              f"against {out['unprofiled_decode_step_ms']:.2f} ms a step "
              f"unprofiled; prefill calls {pre.get('calls')}, "
              f"{pre.get('device_ms', 0.0):.1f} ms of device time in all; "
              f"{device_ms - decode['device_ms'] - pre.get('device_ms', 0.0):.1f}"
              f" ms of device time in neither")
    else:
        print("profile: the decode range holds no device time (decode step "
              "device time not measured)")
    for r in out["top"]:
        print(f"profile:   {r['ms']:9.2f} ms  {r['calls']:6d}x  {r['name']}")
    for r in out["serving_kernels"]:
        print(f"profile: serving kernel {r['ms']:9.2f} ms  {r['calls']:6d}x  "
              f"{r['name']}")
    return out


def card_vs_cpu_phase(torch, configs, model, serve, ops):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = configs.get_config("tiny")
    params = model.init_params(cfg, seed=0, device="cpu")
    adapters = {"tuned_a": nudged(torch, params, PSOFT_TRAINABLES, 1, 0.05,
                                  "cpu"),
                "tuned_b": nudged(torch, params, PSOFT_TRAINABLES, 2, 0.05,
                                  "cpu")}
    reqs = workload(cfg.vocab_size, 12, seed=1)
    kw = dict(slots=4, page_size=16, max_len=192)

    def to_cuda(tree):
        if isinstance(tree, dict):
            return {k: to_cuda(v) for k, v in tree.items()}
        return tree.to("cuda")

    outs = {}
    for dev, p, ad in (("cpu", params, adapters),
                       ("cuda", to_cuda(params),
                        {k: to_cuda(v) for k, v in adapters.items()})):
        ops.reset_launches()
        eng, done, _ = serve_once(torch, serve, p, ad, cfg, reqs, dev, **kw)
        outs[dev] = ({r.uid: list(r.generated) for r in done},
                     [(e.step, e.slot, e.uid, e.prefix_tokens)
                      for e in eng.admission_events])
    engines = dict(ops.PREFILL_ENGINE_LAUNCHES)
    check(engines["simt"] == ops.LAUNCHES["paged_prefill_attention"] > 0
          and engines["mma"] == 0,
          f"tiny: every fp32 prefill on the card on the simt engine "
          f"({engines})")
    check(outs["cuda"][0] == outs["cpu"][0],
          "tiny: card and CPU give the same greedy tokens")
    check(outs["cuda"][1] == outs["cpu"][1],
          "tiny: card and CPU give the same admissions")
    n_tok = sum(len(t) for t in outs["cpu"][0].values())
    print(f"card vs cpu: tiny fp32, {len(reqs)} requests, {n_tok} tokens "
          f"and {len(outs['cpu'][1])} admissions identical; card prefills "
          f"by engine {engines}")
    return dict(requests=len(reqs), tokens=n_tok, prefill_engines=engines)


# ---------------------------------------------------------------------------
# phase 2, training kernels: psoft_matmul and cayley_neumann
# ---------------------------------------------------------------------------

def psoft_inputs(torch, dtype, gen, m, k, n, r=RANK, transpose=False):
    """One PSOFT linear at the scales of an SVD split of W ~ N(0, 1/k): A's
    columns of unit norm, B's rows of norm ~2.4 (the top singular values of
    a k x n Gaussian), R near the identity, alpha and beta near 1."""
    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale
    x = randn(m, n if transpose else k, scale=0.5).to(dtype)
    w = randn(k, n, scale=k ** -0.5).to(dtype)
    a = randn(k, r, scale=k ** -0.5).to(dtype)
    b = randn(r, n, scale=2.4 * n ** -0.5).to(dtype)
    rot = torch.eye(r, device="cuda") + randn(r, r, scale=0.1 * r ** -0.5)
    s_in = 1 + randn(r, scale=0.1)
    s_out = 1 + randn(r, scale=0.1)
    return x, w, a, rot, b, s_in, s_out


#: psoft_matmul's launches on the wgmma engine, by a part of the kernel's
#: name (spaces removed) as the profiler shows it
PSOFT_LAUNCH_NAMES = (("projection", "gemm_kernel<1,"),
                      ("rotate", "rotate_kernel"),
                      ("output", "gemm_kernel<2,"))


def launch_split_ms(torch, fn, calls: int = 5):
    """Device ms per call of each launch of PSOFT_LAUNCH_NAMES, from
    torch.profiler over ``calls`` calls of ``fn`` one after another (L2
    warm, unlike time_ms); None where the trace holds no device time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {k: 0.0 for k, _ in PSOFT_LAUNCH_NAMES}
    for e in prof.key_averages():
        for k, pat in PSOFT_LAUNCH_NAMES:
            if pat in e.key.replace(" ", ""):
                out[k] += e.self_device_time_total / 1e3 / calls
    return out if all(out.values()) else None


def psoft_bytes_flops(m, k, n, r, elt):
    """Each input read once (x, W_res, A, B in the compute dtype; R, alpha,
    beta fp32), each output written once (y; u and t, kept for the
    backward, fp32); the factored product's flops."""
    nbytes = ((m * k + k * n + k * r + r * n + m * n) * elt
              + (r * r + 2 * r) * 4 + 2 * m * r * 4)
    return nbytes, 2 * m * (k * n + k * r + r * r + r * n)


def cayley_inputs(torch, gen, n_mat, r, scale):
    q = torch.randn((n_mat, r, r), generator=gen, device="cuda") * scale
    return q - q.transpose(1, 2)


def psoft_grad_phase(torch, ops, ref, gen):
    """The public autograd wrapper ``ops.psoft_matmul`` forward and backward
    in bf16 at one layer's seven linears (M = 2048, r = 352): the grads the
    training step takes (x, R, alpha, beta; the factors are frozen) against
    autograd of the plain version in fp32 on the same values.  dx is bf16
    (the bf16 limit); the r-sized grads are fp32 (the fp32 limit, scaled).
    Each limit rejects a planted fault (in every sampled row of dx and d_R,
    somewhere in the vectors): dx without its rank-r term, d_R without
    beta, d_alpha with alpha and beta swapped in the transposed launch,
    d_beta without alpha."""
    m, r, f32 = TRAIN_TOKENS, RANK, torch.float32
    errs = {"dx": 0.0, "d_rot": 0.0, "d_alpha": 0.0, "d_beta": 0.0}
    for name, kdim, n in LLAMA_LINEARS:
        x, w, a, rot, b, al, be = psoft_inputs(torch, torch.bfloat16, gen,
                                               m, kdim, n)
        dy = (torch.randn((m, n), generator=gen, device="cuda")
              * 0.5).to(torch.bfloat16)
        leaves = [x.clone().requires_grad_(True), w, a,
                  rot.clone().requires_grad_(True), b,
                  al.clone().requires_grad_(True),
                  be.clone().requires_grad_(True)]
        y = ops.psoft_matmul(*leaves)
        got = torch.autograd.grad(y, [leaves[i] for i in (0, 3, 5, 6)], dy)
        twins = [t.detach().float().requires_grad_(i in (0, 3, 5, 6))
                 for i, t in enumerate(leaves)]
        want = torch.autograd.grad(ref.psoft_matmul(*twins),
                                   [twins[i] for i in (0, 3, 5, 6)],
                                   dy.float())
        torch.cuda.synchronize()
        with torch.no_grad():
            x32, w32, a32, b32, dy32 = (t.float() for t in (x, w, a, b, dy))
            u1 = x32 @ a32
            du4 = dy32 @ b32.T
            faults = (
                dy32 @ w32.T,                                   # dx
                (u1 * al).T @ du4,                              # d_R
                (u1 * ((du4 * al) @ rot.T)).sum(0),             # d_alpha
                (du4 * (u1 @ rot)).sum(0),                      # d_beta
            )
        for (key, dname, scaled, fault), g, wnt in zip(
                (("dx", "bfloat16", None, "rank-r term dropped"),
                 ("d_rot", "float32", True, "beta left out"),
                 ("d_alpha", "float32", True,
                  "alpha and beta swapped in the transposed launch"),
                 ("d_beta", "float32", True, "alpha left out")),
                got, want):
            what = f"psoft_matmul grad {key} {name} bf16"
            check(g.dtype == (torch.bfloat16 if key == "dx" else f32),
                  f"{what}: dtype {g.dtype}")
            errs[key] = max(errs[key], max_err(torch, g, wnt, dname, what,
                                               scaled))
            wrong = faults[("dx", "d_rot", "d_alpha", "d_beta").index(key)]
            if wnt.ndim == 1:
                # a vector is one row: the fault must show in it somewhere
                wrong, wnt, rows = wrong[None], wnt[None], [0]
            else:
                rows = range(0, wnt.shape[0], 97 if key == "dx" else 7)
            must_reject(torch, wrong, wnt, dname, rows, f"{what}, {fault}",
                        scaled)
        del x, w, a, rot, b, dy, leaves, twins, got, want, faults, u1, du4
    return errs


def cayley_grad_phase(torch, ops, ref, gen, n_mat, r, terms):
    """The public autograd wrapper ``ops.cayley_neumann``'s reverse-Horner
    grad at one linear stack against autograd of the plain series (fp32,
    scaled limit); the limit rejects the grad of a series one Horner step
    short."""
    q = cayley_inputs(torch, gen, n_mat, r, 0.03)
    g_out = torch.randn((n_mat, r, r), generator=gen, device="cuda")
    q1, q2, q3 = (q.clone().requires_grad_(True) for _ in range(3))
    got, = torch.autograd.grad(ops.cayley_neumann(q1, terms), q1, g_out)
    want, = torch.autograd.grad(ref.cayley_neumann(q2, terms), q2, g_out)
    short, = torch.autograd.grad(ref.cayley_neumann(q3, terms - 1), q3,
                                 g_out)
    torch.cuda.synchronize()
    e = max_err(torch, got, want, "float32", "cayley_neumann grad dQ",
                scaled=True)
    must_reject(torch, short.reshape(-1, r), want.reshape(-1, r), "float32",
                range(0, n_mat * r, 13),
                "cayley_neumann grad, one Horner step short", scaled=True)
    return e


def train_kernel_phase(torch, ops, ref):
    """psoft_matmul forward and transposed (backward) launch at one
    llama32-3b layer's seven linears (M = 2048 tokens, r = 352), bf16 and
    fp32, and its autograd wrapper's grads in bf16; cayley_neumann at one
    linear stack (28, 352, 352), K = 5, and its wrapper's grad.  Each
    against its plain version, each limit shown to reject a known fault;
    timed in the training dtypes (bf16 linears, fp32 rotation)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    m, r = TRAIN_TOKENS, RANK
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).replace("torch.", "")
        e = 0.0
        for name, kdim, n in LLAMA_LINEARS:
            for transpose in (False, True):
                args = psoft_inputs(torch, dtype, gen, m, kdim, n,
                                    transpose=transpose)
                ops.reset_launches()
                got = ops._psoft_mm(*args, transpose)
                want = ref.psoft_matmul_parts(*args, transpose)
                torch.cuda.synchronize()
                what = f"psoft_matmul {name} {dname}" + \
                    (" transposed" if transpose else "")
                engine = "wgmma" if dtype == torch.bfloat16 else "simt"
                check(ops.PSOFT_ENGINE_LAUNCHES[engine] == 1,
                      f"{what}: ran on {ops.PSOFT_ENGINE_LAUNCHES}, "
                      f"expected the {engine} engine")
                e = max(e, max_err(torch, got[0], want[0], dname, what))
                # u and t are fp32 in both dtypes (bf16 products are
                # exact in fp32): the fp32 limit
                for g, w, part in zip(got[1:], want[1:], ("u", "t")):
                    max_err(torch, g, w, "float32", f"{what} {part}")
                x, w_res, a, rot, b, s_in, s_out = args
                no_rank = ref.psoft_matmul_parts(
                    x, w_res, a, rot, b, s_in, s_out * 0, transpose)[0]
                must_reject(torch, no_rank, want[0], dname,
                            range(0, m, 97), f"{what}, rank-r term dropped")
                # the partial last depth step (r = 352 = 5.5 x 64) dropped
                cut = s_out.clone()
                cut[320:] = 0
                short = ref.psoft_matmul_parts(
                    x, w_res, a, rot, b, s_in, cut, transpose)[0]
                must_reject(torch, short, want[0], dname, range(0, m, 97),
                            f"{what}, rank-r term cut to its first 320 "
                            f"columns")
                del got, want, no_rank, short, args
        errs[f"max_err_{dname}"] = e
    errs["grad_max_err"] = psoft_grad_phase(torch, ops, ref, gen)
    results = {"psoft_matmul": errs}

    # cayley: Q at a scale where the 5th power is far above the limit
    n_mat, terms = 28, 5
    q = cayley_inputs(torch, gen, n_mat, r, 0.03)
    rot, series = ops._cayley(q, terms)
    want, want_series = ref.cayley_neumann_series(q, terms)
    torch.cuda.synchronize()
    e = max_err(torch, rot, want, "float32", "cayley_neumann R")
    max_err(torch, series, want_series, "float32", "cayley_neumann series")
    short = ref.cayley_neumann(q, terms - 1)
    must_reject(torch, short.reshape(-1, r), want.reshape(-1, r), "float32",
                range(0, n_mat * r, 13),
                "cayley_neumann, one Horner step short")
    fifth = float((want - short).abs().max())
    results["cayley_neumann"] = {
        "max_err_float32": e, "fault_max_abs": fifth,
        "grad_max_err": cayley_grad_phase(torch, ops, ref, gen, n_mat, r,
                                          terms)}

    # timing: bf16 linears at the main path's shapes
    dt, elt = torch.bfloat16, 2
    tot = dict(ms=0.0, backward_ms=0.0, plain_ms=0.0, library_ms=0.0,
               bytes=0, flops=0)
    per_linear = {}
    for name, kdim, n in LLAMA_LINEARS:
        x, w_res, a, rot, b, al, be = psoft_inputs(torch, dt, gen, m, kdim,
                                                   n)
        dy = (torch.randn((m, n), generator=gen, device="cuda")
              * 0.5).to(dt)
        merged = (w_res.float() + (a.float() * al) @ rot @
                  (b.float() * be[:, None])).to(dt)
        nbytes, flops = psoft_bytes_flops(m, kdim, n, r, elt)
        split = {
            "forward": launch_split_ms(torch, lambda: ops._psoft_mm(
                x, w_res, a, rot, b, al, be, False)),
            "transposed": launch_split_ms(torch, lambda: ops._psoft_mm(
                dy, w_res, a, rot, b, be, al, True))}
        # the output product's useful flops: [x | v] . [W' ; P_out]
        share = {k: None if v is None else
                 2 * m * (kdim + r) * n / (v["output"] * 1e-3)
                 / PEAK_FLOPS["bfloat16"] for k, v in split.items()}
        one = dict(
            ms=time_ms(torch, lambda: ops._psoft_mm(
                x, w_res, a, rot, b, al, be, False)),
            backward_ms=time_ms(torch, lambda: ops._psoft_mm(
                dy, w_res, a, rot, b, be, al, True)),
            plain_ms=time_ms(torch, lambda: ref.psoft_matmul_parts(
                x, w_res, a, rot, b, al, be)),
            library_ms=time_ms(torch, lambda: torch.matmul(x, merged)),
            bytes=nbytes, flops=flops, launch_ms=split,
            output_peak_share=share)
        one["bound_ms"], one["bound_by"] = bound(nbytes, flops, "bfloat16")
        per_linear[name] = one
        for key in tot:
            tot[key] += one[key]
        del x, w_res, a, rot, b, dy, merged
    results["psoft_matmul"].update(
        tot, per_linear=per_linear,
        library="torch.matmul(x, W_final), the merged weight precomputed "
                "(untimed)",
        shape=f"one llama32-3b layer's seven linears (q k v o gate up "
              f"down), M={m} tokens, r={r}, bf16; ms is the forward launch, "
              f"backward_ms the transposed (dx) launch")
    q = cayley_inputs(torch, gen, n_mat, r, 0.01)
    nbytes = (2 + terms) * n_mat * r * r * 4   # Q in; R and S_1..S_K out
    flops = terms * 2 * r ** 3 * n_mat         # K products per matrix
    results["cayley_neumann"].update(
        ms=time_ms(torch, lambda: ops._cayley(q, terms)),
        plain_ms=time_ms(torch, lambda: ref.cayley_neumann_series(q, terms)),
        library_ms=None, library="none: no single PyTorch call computes "
                                 "the truncated series",
        bytes=nbytes, flops=flops,
        shape=f"one linear stack: L={n_mat}, r={r}, K={terms}, fp32")
    res = results["cayley_neumann"]
    res["bound_ms"], res["bound_by"] = bound(nbytes, flops, "float32")
    tot = results["psoft_matmul"]
    tot["bound_ms"] = sum(v["bound_ms"] for v in per_linear.values())
    tot["bound_by"] = "operations" if all(
        v["bound_by"] == "operations" for v in per_linear.values()) \
        else "bytes"
    return results


# ---------------------------------------------------------------------------
# phase 2, the OFT family's kernel: blockdiag_rotate
# ---------------------------------------------------------------------------

def blockdiag_inputs(torch, dtype, gen, m, d, b):
    """x (M, d) and blocks I + N(0, 0.25/b) in x's dtype, as the OFT
    family's apply casts its rotations (the kernel takes any matrix; the
    noise keeps R_g far from I and from R_g^T, so both planted faults
    move every kernel block's output)."""
    x = (torch.randn((m, d), generator=gen, device="cuda") * 0.5).to(dtype)
    eye = torch.eye(b, device="cuda")
    rots = eye + torch.randn((d // b, b, b), generator=gen,
                             device="cuda") * (0.5 / b ** 0.5)
    return x, rots.to(dtype)


def row_blocks(t, b):
    """The last group's columns of every 64-row block (one kernel block's
    slice of it) as one row each: (M / 64, 64 * b)."""
    return t[:, -b:].reshape(-1, 64 * b)


def blockdiag_kernel_phase(torch, ops, ref):
    """blockdiag_rotate against its plain version at M = 2048 tokens, d in
    {3072, 8192} (the llama32-3b linears' inputs), b in {32, 8, 2} (OFT,
    BOFT, GOFT), bf16 and fp32, forward and transposed.  Each limit must
    reject two planted faults: the last group's rotation replaced by I (in
    every 64-row block) and every R_g transposed (in every sampled row).
    The autograd wrapper's grads of x and rots at (2048, 3072, b = 32)
    against autograd of the plain version in fp32 on the same values, each
    limit rejecting a wrong-orientation dx and a transposed dR.  Timed in
    bf16 at every (d, b) of the path; the headline is OFT's (3072, 32)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    m = TRAIN_TOKENS
    res = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).replace("torch.", "")
        e = 0.0
        for d in (3072, 8192):
            for b in (32, 8, 2):
                x, rots = blockdiag_inputs(torch, dtype, gen, m, d, b)
                ident = rots.clone()
                ident[-1] = torch.eye(b, device="cuda").to(dtype)
                for transpose in (False, True):
                    what = f"blockdiag_rotate d={d} b={b} {dname}" + \
                        (" transposed" if transpose else "")
                    got = ops._rotate(x, rots, transpose)
                    torch.cuda.synchronize()
                    want = ref.blockdiag_rotate(x, rots, transpose)
                    e = max(e, max_err(torch, got, want, dname, what))
                    must_reject(torch, row_blocks(ref.blockdiag_rotate(
                        x, ident, transpose), b), row_blocks(want, b),
                        dname, range(m // 64),
                        f"{what}, the last rotation replaced by I")
                    must_reject(torch, ref.blockdiag_rotate(
                        x, rots, not transpose), want, dname,
                        range(0, m, 97), f"{what}, every R_g transposed")
                del x, rots, ident, got, want
        res[f"max_err_{dname}"] = e
    res["grad_max_err"] = blockdiag_grad_phase(torch, ops, ref, gen)

    per_shape = {}
    elt = 2
    for d in (3072, 8192):
        for b in (32, 8, 2):
            x, rots = blockdiag_inputs(torch, torch.bfloat16, gen, m, d, b)
            xv = x.view(m, d // b, b).transpose(0, 1)
            nbytes = 2 * m * d * elt + d * b * elt    # x, y; rots once
            flops = 2 * m * d * b
            one = dict(
                ms=time_ms(torch, lambda: ops._rotate(x, rots, False)),
                transposed_ms=time_ms(torch,
                                      lambda: ops._rotate(x, rots, True)),
                plain_ms=time_ms(torch,
                                 lambda: ref.blockdiag_rotate(x, rots)),
                library_ms=time_ms(torch, lambda: torch.bmm(xv, rots)),
                bytes=nbytes, flops=flops)
            one["bound_ms"], one["bound_by"] = bound(nbytes, flops,
                                                     "bfloat16")
            per_shape[f"d={d} b={b}"] = one
            del x, rots, xv
    res.update(per_shape["d=3072 b=32"], per_shape=per_shape,
               library="torch.bmm over the (d/b, M, b) view of x",
               shape=f"M={m} tokens, d=3072, b=32 (OFT on q k v o gate up), "
                     f"bf16 x and rotations; ms is the forward launch, "
                     f"transposed_ms the backward's dx launch")
    return {"blockdiag_rotate": res}


def blockdiag_grad_phase(torch, ops, ref, gen):
    """``ops.blockdiag_rotate``'s grads of x and rots (the main path's
    backward: dx by the transposed launch, dR by a batched fp32 product),
    bf16 and fp32, against autograd of the plain version in fp32; the
    grads of rots are sums over 2048 products, held to the scaled limit."""
    m, d, b = TRAIN_TOKENS, 3072, 32
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).replace("torch.", "")
        x, rots = blockdiag_inputs(torch, dtype, gen, m, d, b)
        dy = (torch.randn((m, d), generator=gen, device="cuda")
              * 0.5).to(dtype)
        leaves = [x.clone().requires_grad_(True),
                  rots.clone().requires_grad_(True)]
        got = torch.autograd.grad(ops.blockdiag_rotate(*leaves), leaves, dy)
        twins = [t.detach().float().requires_grad_(True) for t in (x, rots)]
        want = torch.autograd.grad(ref.blockdiag_rotate(*twins), twins,
                                   dy.float())
        torch.cuda.synchronize()
        with torch.no_grad():
            xg = x.float().reshape(m, d // b, b).transpose(0, 1)
            dyg = dy.float().reshape(m, d // b, b).transpose(0, 1)
            faults = (ref.blockdiag_rotate(dy, rots),          # not R^T
                      dyg.transpose(1, 2) @ xg)                 # dR^T
        for key, g, wnt, fault, leaf in zip(
                ("dx", "d_rots"), got, want, faults, (x, rots)):
            what = f"blockdiag_rotate grad {key} {dname}"
            check(g.dtype == leaf.dtype, f"{what}: dtype {g.dtype}")
            errs[f"{key}_{dname}"] = max_err(torch, g, wnt, dname, what,
                                             scaled=True)
            rows = range(0, wnt.shape[0], 97) if key == "dx" else \
                range(0, wnt.shape[0], 5)
            must_reject(torch, fault.reshape(wnt.shape[0], -1),
                        wnt.reshape(wnt.shape[0], -1), dname, rows,
                        f"{what}, wrong orientation", scaled=True)
        del x, rots, dy, leaves, twins, got, want, faults, xg, dyg
    return errs


# ---------------------------------------------------------------------------
# phase 5 / 6: training
# ---------------------------------------------------------------------------

def free_cycles(torch) -> float:
    """GiB of device memory a ``gc.collect()`` frees now: what earlier
    phases left in reference cycles (a later peak is then the phase's own,
    not a matter of when Python's collector happens to run)."""
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    gc.collect()
    torch.cuda.empty_cache()
    return (held - torch.cuda.memory_allocated()) / 2**30


def run_train(torch, configs, trainer, data, tree, ops, cfg, params,
              timed: int, expected, what: str, profile=False):
    """``1 + timed`` steps of ``make_train_step`` on ``params`` (split by
    the PEFT mask; the first step is a warm-up), 8 x 256 synthetic tokens a
    step.  Checks finite losses and grad norms, frozen leaves bit-identical,
    every trainable leaf moved, and each kernel's launches in every step
    equal to ``expected[kernel]``.  The caller drops its own references to
    ``params``, so that the run's end frees them."""
    tc = configs.TrainConfig(steps=100, learning_rate=1e-4)
    state = trainer.train_state_from_params(params, cfg, tc)
    del params
    frozen = tree.tree_leaves(state.frozen)
    t0 = time.perf_counter()
    frozen_before = [t.cpu() for t in frozen]
    trainable_before = [t.clone() for t in
                        tree.tree_leaves(state.trainable)]
    copy_s = time.perf_counter() - t0
    n_train = sum(t.numel() for t in trainable_before)
    n_frozen = sum(t.numel() for t in frozen)
    ds = data.SyntheticLMDataset(cfg, TRAIN_BATCH, TRAIN_SEQ)
    batches = [ds.batch_at(i) for i in range(timed + 1)]
    step = trainer.make_train_step(cfg, tc)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    losses, gnorms, step_ms, per_step = [], [], [], []
    for i, batch in enumerate(batches):
        before = dict(ops.LAUNCHES)
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        dt_ms = (time.perf_counter() - t0) * 1e3
        per_step.append({k: ops.LAUNCHES[k] - before[k]
                         for k in ops.LAUNCHES})
        losses.append(float(metrics["loss"]))
        gnorms.append(float(metrics["grad_norm"]))
        if i:
            step_ms.append(dt_ms)
        else:
            warm_ms = dt_ms
    launches = dict(ops.LAUNCHES)
    engines = dict(ops.PSOFT_ENGINE_LAUNCHES)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    check(all(math.isfinite(v) for v in losses + gnorms),
          f"{what}: finite losses {losses} and grad norms {gnorms}")
    check(all(g > 0 for g in gnorms), f"{what}: grad norms {gnorms} > 0")
    for i, cnt in enumerate(per_step):
        for k, (n, why) in expected.items():
            check(cnt[k] == n, f"{what} step {i}: {k} launched {cnt[k]} "
                               f"times, expected {n} ({why})")
    t0 = time.perf_counter()
    after = tree.tree_leaves(state.frozen)
    check(len(after) == len(frozen_before) and all(
        a is b for a, b in zip(after, frozen)),
        f"{what}: frozen leaves kept")
    check(all(torch.equal(b, a.cpu()) for b, a in zip(frozen_before, after)),
          f"{what}: every frozen leaf bit-identical after the steps")
    moved = [bool((a != b).any()) for a, b in zip(
        tree.tree_leaves(state.trainable), trainable_before)]
    check(all(moved), f"{what}: every trainable leaf moved "
                      f"({moved.count(False)} did not)")
    verify_s = time.perf_counter() - t0
    mean_ms = sum(step_ms) / len(step_ms)
    result = dict(
        layers=cfg.num_layers, method=cfg.peft.method,
        tokens_per_step=TRAIN_TOKENS, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
        remat=cfg.remat_policy, trainable_params=n_train,
        frozen_params=n_frozen, warmup_step_ms=warm_ms, step_ms=step_ms,
        mean_step_ms=mean_ms, min_step_ms=min(step_ms),
        max_step_ms=max(step_ms),
        tokens_per_s=TRAIN_TOKENS / (mean_ms / 1e3),
        peak_memory_gib=peak_gib, losses=losses, grad_norms=gnorms,
        launches=launches, launches_per_step=per_step[-1],
        psoft_engines=engines,
        frozen_copy_s=copy_s, verify_s=verify_s,
        profile=profile_train(torch, step, state, batches[0])
        if profile else None)
    print(f"{what}: llama32-3b {cfg.num_layers} layers, "
          f"{cfg.peft.method}, remat {cfg.remat_policy}, {TRAIN_BATCH}x"
          f"{TRAIN_SEQ} tokens a step, {n_train} trainable / {n_frozen} "
          f"frozen params; step ms mean {mean_ms:.1f} min "
          f"{min(step_ms):.1f} max {max(step_ms):.1f} (warm-up "
          f"{warm_ms:.1f}), {result['tokens_per_s']:.0f} tokens/s, peak "
          f"{peak_gib:.1f} GiB")
    print(f"{what}: losses {[round(v, 4) for v in losses]}, grad norms "
          f"{[round(v, 4) for v in gnorms]}; launches per step "
          f"{ {k: v for k, v in per_step[-1].items() if v} }")
    return result


def train_phase(torch, args, configs, trainer, data, tree, ops, params,
                gpu_line):
    """PSOFT fine-tuning at full width on the serve phase's params."""
    gc_freed_gib = free_cycles(torch)
    cfg = configs.get_config("llama32-3b", remat_policy="full")
    if args.layers:
        cfg = cfg.replace(num_layers=args.layers)
    linears = 7 * cfg.num_layers
    expected = {
        "psoft_matmul": (3 * linears, "forward, remat recompute and "
                                      "backward of every PSOFT linear"),
        "cayley_neumann": (7, "one per linear stack"),
        "blockdiag_rotate": (0, "no OFT linear")}
    result = run_train(torch, configs, trainer, data, tree, ops, cfg,
                       params, 5, expected, "train", args.profile)
    engines = result["psoft_engines"]
    check(engines["wgmma"] == result["launches"]["psoft_matmul"]
          and engines["wmma"] == engines["simt"] == 0,
          f"train: every bf16 psoft_matmul call on the wgmma engine "
          f"({engines})")
    print(f"train: psoft_matmul launches by engine {engines}")
    result.update(gc_freed_gib=gc_freed_gib, gpu=gpu_line)
    print(f"train: a gc.collect before it freed {gc_freed_gib:.2f} GiB "
          f"[{gpu_line}]")
    return result


def rotations_per_step(cfg, per_linear) -> int:
    """blockdiag_rotate launches a train step needs: three per rotation of
    the forward (the forward, the remat recompute, the backward's dx) but
    for the first rotation of layer 0's q, k and v, whose input depends on
    no trainable (the frozen embedding), so autograd asks no dx of it.
    ``per_linear(d_in)``: the rotations of one linear."""
    d, f = cfg.d_model, cfg.d_ff
    return 3 * cfg.num_layers * (6 * per_linear(d) + per_linear(f)) - 3


def method_config(configs, method, layers):
    cfg = configs.get_config("llama32-3b", remat_policy="full",
                             num_layers=layers)
    return cfg.replace(peft=cfg.peft.replace(method=method,
                                             **BASELINES[method]))


def expected_baseline_launches(cfg):
    """Exact launches a step of each method of the OFT family; none for
    the LoRA family, whose products are plain torch."""
    method, pc = cfg.peft.method, cfg.peft
    levels = {"oft": lambda n: 1, "boft": lambda n: pc.boft_factors,
              "goft": lambda n: max(1, int(math.log2(n))),
              "qgoft": lambda n: max(1, int(math.log2(n)))}
    rot = rotations_per_step(cfg, levels[method]) if method in levels else 0
    cayley = 7 if method in ("oft", "boft") else 0
    return {"blockdiag_rotate": (rot, "3 per rotation, but no dx for the "
                                      "first of layer 0's q, k, v"),
            "cayley_neumann": (cayley, "one per linear stack"),
            "psoft_matmul": (0, "no PSOFT linear")}


def oft_train_phase(torch, args, configs, model, trainer, data, tree, ops,
                    gpu_line):
    """OFT fine-tuning at full width: llama32-3b (28 layers unless
    ``--layers`` cuts depth), OFT with blocks of 32 on all seven linears,
    random weights from a seed (no SVD), q moved off zero by a seeded
    nudge; 1 warm-up and 5 timed steps."""
    gc_freed_gib = free_cycles(torch)
    cfg = method_config(configs, "oft", args.layers or 28)
    t0 = time.perf_counter()
    params = nudged(torch, model.init_params(cfg, seed=3, device="cuda"),
                    ("q",), 4, 0.01)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    result = run_train(torch, configs, trainer, data, tree, ops, cfg,
                       params, 5, expected_baseline_launches(cfg),
                       "oft train", args.profile)
    del params
    result.update(init_s=init_s, gc_freed_gib=gc_freed_gib, gpu=gpu_line)
    print(f"oft train: init_params {init_s:.1f} s; a gc.collect before it "
          f"freed {gc_freed_gib:.2f} GiB [{gpu_line}]")
    return result


def baselines_phase(torch, args, configs, model, trainer, data, tree, ops,
                    gpu_line):
    """The six other baselines at full width and METHOD_LAYERS layers (or
    fewer with ``--layers``), METHOD_STEPS timed steps each after one
    warm-up, each run's tensors freed before the next."""
    layers = min(METHOD_LAYERS, args.layers or METHOD_LAYERS)
    out = {}
    for method in ("boft", "goft", "qgoft", "pissa", "dora", "lora_xs"):
        free_cycles(torch)
        cfg = method_config(configs, method, layers)
        t0 = time.perf_counter()
        params = model.init_params(cfg, seed=5, device="cuda")
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        out[method] = run_train(torch, configs, trainer, data, tree, ops,
                                cfg, params, METHOD_STEPS,
                                expected_baseline_launches(cfg),
                                f"{method} train")
        del params
        out[method].update(init_s=init_s, gpu=gpu_line)
    torch.cuda.empty_cache()
    return out


def profile_train(torch, step, state, batch):
    """One more step under torch.profiler: device time by kernel name."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA")
            and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    if not rows:
        print("profile: the train trace holds no device time (not measured)")
        return None
    device_ms = sum(r[1] for r in rows)
    out = dict(profiled_wall_ms=wall_ms, device_ms=device_ms,
               top=[dict(name=k[:90], ms=ms, calls=n)
                    for k, ms, n in rows[:15]])
    print(f"profile: train step device busy {device_ms:.1f} ms of a "
          f"profiled {wall_ms:.1f} ms step")
    for r in out["top"]:
        print(f"profile:   {r['ms']:9.2f} ms  {r['calls']:6d}x  {r['name']}")
    return out


def train_card_vs_cpu_phase(torch, configs, model, trainer, data, tree,
                            peft, method="psoft", steps=5):
    """tiny fp32: ``steps`` steps of ``method`` from one state on the card
    and on the CPU (losses within 1e-4 relative), then the tuned tree's
    logits against its merged tree's on the card."""
    cfg = configs.get_config("tiny")
    cfg = cfg.replace(peft=cfg.peft.replace(method=method))
    tc = configs.TrainConfig(steps=10, learning_rate=1e-2, warmup_ratio=0.2)
    cpu = trainer.init_train_state(cfg, tc, seed=0, device="cpu")
    gpu = tree.tree_map(lambda t: t.to("cuda"), cpu)
    ds = data.SyntheticLMDataset(cfg, 4, 32)
    step = trainer.make_train_step(cfg, tc)
    losses = {"cpu": [], "cuda": []}
    for i in range(steps):
        batch = ds.batch_at(i)
        cpu, mc = step(cpu, batch)
        gpu, mg = step(gpu, batch)
        losses["cpu"].append(float(mc["loss"]))
        losses["cuda"].append(float(mg["loss"]))
    rel = [abs(a - b) / abs(b) for a, b in zip(losses["cuda"],
                                               losses["cpu"])]
    check(max(rel) <= 1e-4, f"tiny {method} train: card and CPU losses "
                            f"within 1e-4 relative ({losses})")
    tuned = trainer.adapter_params(gpu)
    merged = peft.merge_tree(tuned, cfg.peft)
    batch = {k: torch.as_tensor(v, device="cuda")
             for k, v in ds.batch_at(9).items()}
    with torch.no_grad():
        got = model.forward_logits(merged, batch, cfg)
        want = model.forward_logits(tuned, batch, cfg)
    err = max_err(torch, got, want, "float32",
                  f"tiny {method} train: merged vs unmerged logits on the "
                  f"card")
    print(f"train card vs cpu: tiny fp32 {method}, {steps} steps, losses "
          f"{losses['cuda']} (max relative gap {max(rel):.2e}); "
          f"merged-vs-unmerged logits max abs err {err:.2e}")
    return dict(method=method, losses=losses, max_rel_gap=max(rel),
                merge_max_err=err)


# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=0,
                    help="cut llama32-3b depth to this many layers "
                         "(default: all 28)")
    ap.add_argument("--profile", action="store_true",
                    help="profile one more full-width run (torch.profiler)")
    ap.add_argument("--out", default="",
                    help="also write the full results as JSON here")
    args = ap.parse_args(argv)
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: src/repro_torch is missing: run from a checkout "
              "of the repository", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False: this check "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    import torch.nn.functional as F

    from repro_torch import configs
    from repro_torch.core import peft
    from repro_torch.data import pipeline as data
    from repro_torch.kernels import build, ops, ref
    from repro_torch.models import model
    from repro_torch import serve
    from repro_torch.train import trainer
    from repro_torch import tree

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gpu_line = gpu_name_and_power()
    kind = torch.cuda.get_device_name(0)
    print(f"device: {kind}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}; python {sys.version.split()[0]}")
    print(gpu_line)
    t0 = time.perf_counter()
    built = build.build()
    print(f"build: {len(built)} kernel libraries compiled in "
          f"{time.perf_counter() - t0:.1f} s (nvcc, sm_90a, in parallel)")
    ptxas = {name: ptxas_summary(log)
             for name, log in build.BUILD_LOGS.items()}
    for name, log in build.BUILD_LOGS.items():
        for line in log.splitlines():
            if "warning" in line.lower() or "Performance Loss" in line:
                print(f"build: {name}: {line.strip()}")
    for name, entries in ptxas.items():
        for e in entries:
            print(f"build: {name}: {e['entry']}: {e['registers']} registers"
                  f", {e['smem']} bytes static smem, spill stores "
                  f"{e['spill_stores']} / loads {e['spill_loads']}")
    redesigned = ptxas.get("paged_decode_attention", []) + \
        ptxas.get("gather_delta_matmul", []) + [
            e for e in ptxas.get("psoft_matmul", [])
            if "gemm_kernel" in e["entry"] and "hopper" in e["entry"]
            or "rotate_kernel" in e["entry"]] + [
            e for e in ptxas.get("paged_prefill_attention", [])
            if "prefill_mma_kernel" in e["entry"]]
    for e in redesigned:
        check(e["spill_stores"] == 0 and e["spill_loads"] == 0,
              f"build: {e['entry']} spills registers")

    phase_s = {"build": time.perf_counter() - t0}
    t0 = time.perf_counter()
    kernels = kernel_phase(torch, ops, ref, F)
    kernels.update(train_kernel_phase(torch, ops, ref))
    kernels.update(blockdiag_kernel_phase(torch, ops, ref))
    phase_s["kernels"] = time.perf_counter() - t0
    print(f"kernels: phase took {phase_s['kernels']:.1f} s")
    for name, res in kernels.items():
        print(json.dumps({"kernel": name,
                          "max_err_bf16": res.get("max_err_bfloat16"),
                          "max_err_fp32": res["max_err_float32"],
                          "grad_max_err": res.get("grad_max_err"),
                          "kernel_ms": res["ms"], "plain_ms": res["plain_ms"],
                          "library_ms": res["library_ms"],
                          "library": res["library"],
                          "bound_ms": res["bound_ms"],
                          "bound_by": res["bound_by"],
                          "bytes": res["bytes"], "flops": res["flops"],
                          "shape": res["shape"], "gpu": gpu_line}))
    pm = kernels["psoft_matmul"]
    print(f"kernels: psoft_matmul per linear (forward / transposed ms, "
          f"bound ms): " + ", ".join(
              f"{k} {v['ms']:.3f}/{v['backward_ms']:.3f} "
              f"({v['bound_ms']:.3f})" for k, v in pm["per_linear"].items()))
    for k, v in pm["per_linear"].items():
        for orient, sp in v["launch_ms"].items():
            if sp is None:
                print(f"kernels: psoft_matmul {k} {orient}: launch split "
                      f"not measured (no device time in the trace)")
                continue
            print(f"kernels: psoft_matmul {k} {orient} launches (profiled, "
                  f"L2 warm): projection {sp['projection']:.4f} ms, rotate "
                  f"{sp['rotate']:.4f} ms, output {sp['output']:.4f} ms "
                  f"({100 * v['output_peak_share'][orient]:.1f}% of the "
                  f"bf16 peak)")
    dec = kernels["paged_decode_attention"]
    print(f"kernels: paged_decode_attention {dec['ms']:.4f} ms against "
          f"SDPA's {dec['library_ms']:.4f} ms in the same run")
    pre = kernels["paged_prefill_attention"]
    print(f"kernels: paged_prefill_attention {pre['ms']:.4f} ms against "
          f"SDPA's {pre['library_ms']:.4f} ms in the same run")
    gd = kernels["gather_delta_matmul"]
    print(f"kernels: gather_delta_matmul {gd['ms']:.4f} ms a layer against "
          f"a {gd['bound_ms']:.4f} ms byte bound "
          f"({100 * gd['bound_ms'] / gd['ms']:.1f}%) and "
          f"{gd['library_ms']:.4f} ms for torch.matmul(x, W) alone")
    print(f"kernels: gather_delta_matmul per linear (ms, bound ms, share of "
          f"its bound): " + ", ".join(
              f"{k} {v['ms']:.4f} ({v['bound_ms']:.4f}, "
              f"{100 * v['bound_share']:.1f}%)"
              for k, v in gd["per_linear"].items()))
    print(f"kernels: blockdiag_rotate (forward / transposed / plain / bmm "
          f"ms, bound ms): " + ", ".join(
              f"{k} {v['ms']:.4f}/{v['transposed_ms']:.4f}/"
              f"{v['plain_ms']:.4f}/{v['library_ms']:.4f} "
              f"({v['bound_ms']:.4f})"
              for k, v in kernels["blockdiag_rotate"]["per_shape"].items()))
    t0 = time.perf_counter()
    served, params = serve_phase(torch, args, configs, model, serve, ops,
                                 gpu_line)
    phase_s["serve"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    cross = card_vs_cpu_phase(torch, configs, model, serve, ops)
    phase_s["card_vs_cpu"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    trained = train_phase(torch, args, configs, trainer, data, tree, ops,
                          params, gpu_line)
    del params
    torch.cuda.empty_cache()
    phase_s["train"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    train_cross = train_card_vs_cpu_phase(torch, configs, model, trainer,
                                          data, tree, peft)
    phase_s["train_card_vs_cpu"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    oft_trained = oft_train_phase(torch, args, configs, model, trainer,
                                  data, tree, ops, gpu_line)
    phase_s["oft_train"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    baselines = baselines_phase(torch, args, configs, model, trainer, data,
                                tree, ops, gpu_line)
    phase_s["baselines"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    baseline_cross = [train_card_vs_cpu_phase(
        torch, configs, model, trainer, data, tree, peft, method, 3)
        for method in ("oft", "goft")]
    phase_s["baselines_card_vs_cpu"] = time.perf_counter() - t0
    print(f"phases: {', '.join(f'{k} {v:.1f} s' for k, v in phase_s.items())}"
          f" [{gpu_line}]")

    main_path = {**{k: served["launches"][k] for k in SERVE_KERNELS},
                 **{k: trained["launches"][k] for k in TRAIN_KERNELS},
                 "blockdiag_rotate":
                     oft_trained["launches"]["blockdiag_rotate"]}
    line = {"kernels": [
        {"name": name, "route": "cuda",
         "source": f"src/repro_torch/kernels/csrc/{name}.cu",
         "replaces": REPLACES[name],
         "launches": main_path[name],
         "max_abs_err": res.get("max_err_bfloat16",
                                res["max_err_float32"]),
         "ms": res["ms"], "plain_ms": res["plain_ms"],
         "bound_ms": res["bound_ms"], "bound_by": res["bound_by"],
         "library_ms": res["library_ms"]}
        for name, res in kernels.items()]}
    if args.out:
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(dict(gpu=gpu_line, kind=kind,
                                       kernels=kernels, serve=served,
                                       card_vs_cpu=cross, train=trained,
                                       train_card_vs_cpu=train_cross,
                                       oft_train=oft_trained,
                                       baselines=baselines,
                                       baselines_card_vs_cpu=baseline_cross,
                                       phase_s=phase_s), indent=1))
    print(gpu_line)
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
