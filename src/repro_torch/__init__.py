"""PyTorch/CUDA port of the PSOFT stack on one NVIDIA H100: multi-tenant
paged PSOFT serving (slice 1), PEFT-masked PSOFT fine-tuning with its
checkpoints (slice 2), every baseline method of the paper's PEFT registry
(slice 3), Hopper designs of the six kernels (slices 4-6), streaming
serving (slice 7): per-request sampling on the reference's counter-based
threefry stream, ``run_stream`` with SLO-aware preemption, chunked
prefill, and the :mod:`repro_torch.obs` Tracker every layer reports
through; speculative decoding with ``n > 1`` parallel completions
(slice 8); and the live adapter lifecycle: hot-swap banks that register,
update and unregister adapters mid-run, and serve-while-train through
``AdapterFeed`` (slice 9); the MoE family (slice 10); the SSM (Mamba2)
and hybrid families on the engine's dense per-slot cache (slice 11); and
the VLM and audio encoder-decoder families (slice 12).
:mod:`repro_torch.examples` holds the runnable twins of the reference's
main-path examples.

The reference package ``repro`` (JAX/Pallas) stays the source of truth; this
package mirrors its module names and its scan-stacked ``(L, ...)`` parameter
layout, so a parameter tree converts 1:1 (:mod:`repro_torch.interop`).
Every entry point takes ``device=`` and defaults to ``"cuda"``; with no GPU
the default raises instead of falling back to the CPU.
"""
import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a :class:`torch.device`, refusing a CUDA device when no
    GPU is present (there is no silent CPU fallback)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            f"False; pass device='cpu' to run the plain PyTorch path")
    return dev
