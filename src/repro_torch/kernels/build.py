"""Build the port's CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, under ``build/kernels/`` at the root
of the checkout.  All sources compile in parallel (one ``nvcc`` each,
started together).  A library's file name carries a hash of its sources and
flags, so an unchanged kernel is not rebuilt.  Nothing here runs when the
module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("paged_decode_attention", "paged_prefill_attention",
           "gather_delta_matmul", "psoft_matmul", "cayley_neumann",
           "blockdiag_rotate")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
#: C entry point and argument types per source; every entry point returns
#: ``cudaGetLastError()`` as an int
ENTRY_POINTS = {
    "paged_decode_attention": (
        "paged_decode_attention_launch",
        [_I] + [_P] * 7 + [_I] * 8 + [_P]),
    "paged_prefill_attention": (
        "paged_prefill_attention_launch",
        [_I, _I] + [_P] * 8 + [_I] * 9 + [_P]),
    "gather_delta_matmul": (
        "gather_delta_matmul_launch",
        [_I] + [_P] * 8 + [_I] * 8 + [_P]),
    "psoft_matmul": (
        "psoft_matmul_launch",
        [_I, _I, _I] + [_P] * 11 + [_I] * 4 + [_P]),
    "cayley_neumann": (
        "cayley_neumann_launch",
        [_P, _P, _P] + [_I] * 3 + [_P]),
    "blockdiag_rotate": (
        "blockdiag_rotate_launch",
        [_I, _I, _I, _P, _P, _P] + [_I] * 3 + [_P]),
}

#: loaded libraries by source name (a loaded library lives as long as the
#: process, so this cache is process-wide by nature)
_LOADED: Dict[str, ctypes.CDLL] = {}
#: compiler output of the builds this process ran, by source name
BUILD_LOGS: Dict[str, str] = {}


def nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, /usr/local/cuda/bin, then $PATH."""
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME or put nvcc on PATH)")
    return found


def _library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in (CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))):
        h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Sequence[str] = SOURCES) -> Dict[str, float]:
    """Compile every library of ``names`` not built yet, all at once.
    Returns seconds per source compiled (empty when all were cached);
    raises with the compiler's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = [n for n in names if not _library_path(n).exists()]
    if not todo:
        return {}
    compiler = nvcc()
    procs: List = []
    t0 = time.perf_counter()
    for name in todo:
        out = _library_path(name)
        tmp = out.with_suffix(f".tmp{os.getpid()}")
        cmd = [compiler, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    seconds: Dict[str, float] = {}
    failed = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        BUILD_LOGS[name] = log
        if proc.returncode != 0:
            failed.append(f"--- {name} (exit {proc.returncode}) ---\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return seconds


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building every kernel
    first if this one is missing.  Its C signatures are set once, here."""
    lib = _LOADED.get(name)
    if lib is None:
        path = _library_path(name)
        if not path.exists():
            build()
        lib = ctypes.CDLL(str(path))
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        fn_name, argtypes = ENTRY_POINTS[name]
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        lib.launch = fn
        _LOADED[name] = lib
    return lib
