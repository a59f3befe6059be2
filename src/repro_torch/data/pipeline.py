"""Deterministic synthetic LM data: the reference's Markov-chain token
sequences (with a VLM's patch embeddings or an encoder-decoder's source
frames), in numpy, and a background-thread prefetch over any iterator.

Batch ``step`` is a pure function of (seed, step, host), so the port draws
exactly the reference's batches for the same seed; the trainer moves them to
its device.  The task is a fixed random Markov chain over the vocabulary:
low-entropy transitions make convergence measurable.
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np

import torch

from repro_torch.configs.base import DataConfig, InputShape, ModelConfig


class SyntheticLMDataset:
    """Markov-chain token sequences; ``batch_at(step)`` -> batch dict of
    int32 ``tokens`` and ``labels`` (B, S), plus ``patch_embeds`` or
    ``src_embeds`` for the VLM and encoder-decoder families."""

    def __init__(self, cfg: ModelConfig, batch: int, seq_len: int,
                 data_cfg: Optional[DataConfig] = None):
        self.cfg = cfg
        self.dc = data_cfg or DataConfig()
        if batch % self.dc.num_hosts:
            raise ValueError(f"batch {batch} does not split over "
                             f"{self.dc.num_hosts} hosts")
        self.local_batch = batch // self.dc.num_hosts
        self.seq_len = seq_len
        rng = np.random.default_rng(self.dc.seed)
        v = cfg.vocab_size
        # sparse transition table: each token has `branching` successors
        self.succ = rng.integers(0, v, size=(v, self.dc.branching),
                                 dtype=np.int32)

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(
            (self.dc.seed, step, self.dc.host_id, 0xBEEF))
        b, s, v = self.local_batch, self.seq_len, self.cfg.vocab_size
        toks = np.empty((b, s + 1), np.int32)
        toks[:, 0] = rng.integers(0, v, size=b)
        choices = rng.integers(0, self.dc.branching, size=(b, s))
        for t in range(s):
            toks[:, t + 1] = self.succ[toks[:, t], choices[:, t]]
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        batch.update(_modality_extras(self.cfg, b, s, rng))
        return batch

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


def _modality_extras(cfg: ModelConfig, b: int, s: int, rng) -> Dict:
    """The stub frontends' inputs, drawn after the tokens from the same
    generator: a VLM's ``patch_embeds`` (B, num_patch_tokens, d_model) and
    an encoder-decoder's ``src_embeds`` (B, S, d_model), fp32."""
    out = {}
    if cfg.family == "vlm" and cfg.num_patch_tokens:
        out["patch_embeds"] = rng.standard_normal(
            (b, cfg.num_patch_tokens, cfg.d_model)).astype(np.float32)
    if cfg.is_encoder_decoder:
        out["src_embeds"] = rng.standard_normal(
            (b, s, cfg.d_model)).astype(np.float32)
    return out


def prefetch_iterator(it: Iterator, depth: int = 2) -> Iterator:
    """``it``'s items in order, drawn ahead on a background thread into a
    queue of at most ``depth`` (hides host-side batch generation behind the
    step); ends when ``it`` does."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = object()

    def worker():
        try:
            for item in it:
                q.put(item)
        finally:
            q.put(stop)

    threading.Thread(target=worker, daemon=True).start()
    while True:
        item = q.get()
        if item is stop:
            return
        yield item


# ---------------------------------------------------------------------------
# abstract inputs of a shape (the dry-run)
# ---------------------------------------------------------------------------

def make_input_specs(cfg: ModelConfig, shape: InputShape
                     ) -> Dict[str, torch.Tensor]:
    """Meta tensors standing in for every model input of ``shape``:
    train and prefill a token batch (prefill without labels; a VLM's patch
    embeddings in front of fewer tokens), decode one new token a row; an
    encoder-decoder splits the token budget evenly between source frames
    and target tokens."""
    b, s = shape.global_batch, shape.seq_len
    act = torch.float32 if cfg.dtype == "float32" else torch.bfloat16

    def spec(dims, dtype=torch.int32):
        return torch.empty(dims, dtype=dtype, device="meta")
    if shape.kind == "decode":
        return {"tokens": spec((b, 1))}
    if cfg.is_encoder_decoder:
        half = s // 2
        return {"src_embeds": spec((b, half, cfg.d_model), act),
                "tokens": spec((b, half)), "labels": spec((b, half))}
    specs = {"tokens": spec((b, s)), "labels": spec((b, s))}
    if cfg.family == "vlm" and cfg.num_patch_tokens:
        st = s - cfg.num_patch_tokens
        specs = {"tokens": spec((b, st)), "labels": spec((b, st)),
                 "patch_embeds": spec((b, cfg.num_patch_tokens, cfg.d_model),
                                      act)}
    if shape.kind == "prefill":
        specs.pop("labels", None)
    return specs
