"""Serving engine of the port: multi-tenant continuous batching over a
block-paged KV cache, greedy decoding, strict-FIFO ``run()``.

The engine merges the base tree once (PSOFT adapters fold into plain
weights) and stacks every registered adapter's update into a per-linear
bank (:func:`repro_torch.core.registry.stack_deltas`), built once when a run
starts.  Prefill and decode pass a per-row ``adapter_ids`` vector down to
every banked linear, so one decode step serves slots on different adapters.
KV lives in refcounted pages (:class:`repro_torch.serve.kv_cache
.PagedKVCache`); admissions whose prompt prefix hashes to resident pages
alias them and prefill only their suffix.

This is the reference engine's ``run()`` subset: paged cache only, every
request arrives at step 0, admission is strict FIFO with worst-case page
reservation, no preemption, greedy argmax.  Streaming, preemption, chunked
prefill, speculative decode, ``n > 1``, sampling parameters, the tracker and
the hot-swap lifecycle are later slices of the port.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig, PEFTConfig, torch_dtype
from repro_torch.core import peft as peft_lib, registry
from repro_torch.models import model as model_lib
from repro_torch.serve.kv_cache import OutOfPages, PagedKVCache, TRASH_PAGE

#: adapter name every request uses unless it asks for another
BASE_ADAPTER = "base"

#: logical linears the bank path serves
_LINEAR_MODULES = frozenset({"q", "k", "v", "o", "gate", "up", "down"})


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray              # (S,) int32
    max_new_tokens: int = 16
    adapter: str = BASE_ADAPTER
    generated: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    #: "length" once max_new_tokens / max_len is reached; None otherwise
    finish_reason: Optional[str] = None
    #: run() hit max_steps before this request finished
    truncated: bool = False
    arrival_step: int = 0
    admit_step: Optional[int] = None
    finish_step: Optional[int] = None

    @property
    def queueing_delay(self) -> Optional[int]:
        if self.admit_step is None:
            return None
        return self.admit_step - self.arrival_step


@dataclasses.dataclass(frozen=True)
class AdmissionEvent:
    """One slot fill: ``prefix_tokens`` is the resident KV the prefill
    skipped (aliased shared-prefix pages); non-empty ``others`` shows the
    slot was refilled while other slots were mid-decode."""
    step: int
    slot: int
    uid: int
    adapter: str
    resumed: bool
    prefix_tokens: int
    queueing_delay: Optional[int]
    others: Tuple[int, ...]


def _bank_tree(node, raws, pcs, names, cdt, path):
    """``node`` of the merged base tree with a bank stacked from the
    adapters' matching subtrees ``raws`` (PEFT configs ``pcs``, adapter
    ``names`` in bank order) on every linear they update.  A module-level
    function, so that no closure ties the tree it builds to the engine."""
    if isinstance(node, dict):
        module = path[-1] if path else None
        if set(node) == {"w"} and module in _LINEAR_MODULES \
                and node["w"].ndim >= 2:
            bank = registry.stack_deltas(
                node["w"], [(raw, pc, module) for raw, pc in zip(raws, pcs)])
            if bank is None:
                return node
            if "left" in bank:
                bank["left"] = bank["left"].to(cdt)
            return {"w": node["w"], "bank": bank}
        return {k: _bank_tree(v, [r[k] for r in raws], pcs, names, cdt,
                              path + (k,))
                for k, v in node.items()}
    # a non-linear leaf is shared by every slot: refuse adapters that
    # changed it
    for name, leaf in zip(names[1:], raws[1:]):
        if not torch.equal(leaf, node):
            raise ValueError(
                f"adapter {name!r} differs from base at non-linear param "
                f"{'/'.join(path)}; per-slot serving only covers "
                f"linear-module updates")
    return node


class ServeEngine:
    """Fixed-slot continuous batcher over the paged decode step.

    ``params`` is the (PEFT-wrapped) tree served as the ``"base"`` adapter;
    :meth:`register_adapter` adds fine-tunes of the same architecture.
    ``device`` holds the KV pools and every per-step tensor, and must be
    where ``params`` live."""

    def __init__(self, params, cfg: ModelConfig, max_len: int = 256,
                 slots: int = 4, page_size: int = 16,
                 num_pages: Optional[int] = None, device="cuda"):
        if cfg.family != "dense":
            raise ValueError(f"the port serves the dense family only, not "
                             f"{cfg.family!r}")
        self.device = resolve_device(device)
        if params["embed"]["w"].device.type != self.device.type:
            raise ValueError(f"params live on {params['embed']['w'].device}, "
                             f"engine device is {self.device}")
        # serving config: every linear is a plain {"w"} (+ bank) once merged
        self.cfg = dataclasses.replace(
            cfg, peft=PEFTConfig(method="none", target_modules=()))
        self.base_peft = cfg.peft
        self._sources: Dict[str, Tuple[object, PEFTConfig]] = {
            BASE_ADAPTER: (params, cfg.peft)}
        self._order: List[str] = [BASE_ADAPTER]      # bank index -> name
        self._merged_base = peft_lib.merge_tree(params, cfg.peft)
        self._tree = None                            # built at run start
        self.max_len = max_len
        self.slots = slots
        self.kv = PagedKVCache(self.cfg, slots, max_len, page_size=page_size,
                               num_pages=num_pages, device=self.device)
        self.positions = np.zeros((slots,), np.int32)
        self.active: List[Optional[Request]] = [None] * slots
        self.admission_events: List[AdmissionEvent] = []
        #: host-clock totals of the last run: prefill calls and decode steps
        #: (each ends in the token transfer, so the device work is included)
        self.last_run_stats: Dict[str, float] = {}
        self._stats: Dict[str, float] = {}

    # -- adapters ----------------------------------------------------------
    def register_adapter(self, name: str, params,
                         peft_cfg: Optional[PEFTConfig] = None) -> None:
        """Add one fine-tuned tree by name (before :meth:`run`; the bank is
        rebuilt at the next run start).  ``peft_cfg`` defaults to the
        engine's construction-time PEFT config."""
        if name in self._sources:
            raise ValueError(f"adapter {name!r} is already registered")
        self._sources[name] = (params, peft_cfg or self.base_peft)
        self._order.append(name)
        self._tree = None

    def list_adapters(self) -> List[str]:
        return sorted(self._order)

    def _adapter_id(self, name: str) -> int:
        try:
            return self._order.index(name)
        except ValueError:
            raise KeyError(f"unknown adapter {name!r}; registered: "
                           f"{self.list_adapters()}") from None

    def _banked_tree(self):
        """Merged base tree with a stacked adapter bank on every linear an
        adapter updates.  The bank's ``left`` factors are stored in the
        compute dtype: every consumer casts them to it before use."""
        if self._tree is None:
            entries = [self._sources[n] for n in self._order]
            self._tree = _bank_tree(
                self._merged_base, [raw for raw, _ in entries],
                [pc for _, pc in entries], self._order,
                torch_dtype(self.cfg.dtype), ())
        return self._tree

    # -- admission ---------------------------------------------------------
    def _bucket(self, plen: int) -> int:
        """Right-pad prefill length to a multiple of 8, the reference's
        default (pads are never attended: logits read the last real
        token)."""
        return min(self.max_len, -(-plen // 8) * 8)

    @staticmethod
    def _kv_key(r: Request) -> str:
        return f"{r.adapter}#1"

    def _validate(self, r: Request) -> None:
        self._adapter_id(r.adapter)
        if not 0 < len(r.prompt) < self.max_len:
            raise ValueError(
                f"request {r.uid}: prompt length {len(r.prompt)} must be in "
                f"[1, max_len) = [1, {self.max_len})")
        reserve = min(len(r.prompt) + r.max_new_tokens, self.max_len)
        need = -(-reserve // self.kv.page_size)
        if need > self.kv.num_pages - 1:
            raise ValueError(
                f"request {r.uid}: worst-case footprint of {need} pages "
                f"exceeds the pool ({self.kv.num_pages - 1} pages)")

    def _admit(self, step: int, queue: List[Request]) -> None:
        """Fill free slots from the head of the queue (strict FIFO: a head
        that does not fit the page pool waits for frees), then prefill the
        admissions in one call per padding bucket."""
        admitted = []
        for slot in range(self.slots):
            if not queue:
                break
            if self.active[slot] is not None:
                continue
            r = queue[0]
            seq = np.asarray(r.prompt, np.int32)
            reserve = min(len(seq) + r.max_new_tokens, self.max_len)
            try:
                prefix = self.kv.admit(slot, seq, self._kv_key(r),
                                       reserve_tokens=reserve)
            except OutOfPages:
                break
            queue.pop(0)
            admitted.append((slot, r, prefix, seq))
        if not admitted:
            return
        groups: Dict[int, list] = {}
        for entry in admitted:
            groups.setdefault(self._bucket(len(entry[3]) - entry[2]),
                              []).append(entry)
        for bucket, group in groups.items():
            t0 = time.perf_counter()
            nxt = self._prefill_group(bucket, group)
            self._stats["prefill_s"] += time.perf_counter() - t0
            self._stats["prefill_calls"] += 1
            for j, (slot, r, prefix, seq) in enumerate(group):
                others = tuple(q.uid for i, q in enumerate(self.active)
                               if q is not None and i != slot)
                self.active[slot] = r
                r.admit_step = step
                r.generated.append(int(nxt[j]))
                self.positions[slot] = len(seq)
                self.admission_events.append(AdmissionEvent(
                    step=step, slot=slot, uid=r.uid, adapter=r.adapter,
                    resumed=False, prefix_tokens=int(prefix),
                    queueing_delay=r.queueing_delay, others=others))

    def _prefill_group(self, bucket: int, group) -> np.ndarray:
        """One paged prefill over a bucket's admissions; returns each row's
        greedy first token."""
        kv = self.kv
        g = len(group)
        toks = np.zeros((g, bucket), np.int32)
        lens = np.zeros((g,), np.int32)
        prefs = np.zeros((g,), np.int32)
        ids = np.zeros((g,), np.int32)
        rows = np.zeros((g, kv.pages_per_slot), np.int32)
        for j, (slot, r, prefix, seq) in enumerate(group):
            suffix = seq[prefix:]
            toks[j, :len(suffix)] = suffix
            lens[j] = len(suffix)
            prefs[j] = prefix
            ids[j] = self._adapter_id(r.adapter)
            rows[j] = kv.tables[slot]
        # the prefix table is either empty (no aliasing in the group: the
        # exact chunked path) or the full table masked by prefix_len
        n_pref = kv.pages_per_slot if prefs.max() else 0
        dev = self.device
        cache = {"k": kv.pools["k"], "v": kv.pools["v"],
                 "page_table": kv.table_tensor(rows),
                 "prefix_table": kv.table_tensor(rows[:, :n_pref])}
        logits, _ = model_lib.paged_prefill(
            self._tree, {"tokens": torch.from_numpy(toks).to(dev)}, cache,
            self.cfg, torch.from_numpy(lens).to(dev),
            torch.from_numpy(prefs).to(dev),
            adapter_ids=torch.from_numpy(ids).to(dev))
        nxt = self._greedy(logits)
        for slot, r, _prefix, seq in group:
            kv.commit_prompt(slot, seq, self._kv_key(r))
        return nxt

    def _greedy(self, logits: torch.Tensor) -> np.ndarray:
        """Argmax over the real vocabulary of each row's last position: one
        device-to-host transfer per step."""
        return logits[:, -1, :self.cfg.vocab_size].argmax(-1).cpu().numpy()

    # -- decode --------------------------------------------------------------
    def _decode_live(self, live: List[int]) -> np.ndarray:
        """One decode step over every slot; dead slots ride as ghosts
        (token 0, adapter 0, position 0, all-trash table)."""
        toks = np.zeros((self.slots, 1), np.int32)
        ids = np.zeros((self.slots,), np.int32)
        positions = np.zeros((self.slots,), np.int32)
        for i in live:
            r = self.active[i]
            toks[i, 0] = r.generated[-1]
            ids[i] = self._adapter_id(r.adapter)
            positions[i] = self.positions[i]
        for i in range(self.slots):
            if self.active[i] is None and \
                    not (self.kv.tables[i] == TRASH_PAGE).all():
                raise RuntimeError(
                    f"dead slot {i} still maps pages "
                    f"{self.kv.tables[i].tolist()}; its ghost write would "
                    f"corrupt live KV")
        dev = self.device
        cache = {"k": self.kv.pools["k"], "v": self.kv.pools["v"],
                 "page_table": self.kv.table_tensor()}
        logits, _ = model_lib.decode_step(
            self._tree, {"tokens": torch.from_numpy(toks).to(dev)}, cache,
            torch.from_numpy(positions).to(dev), self.cfg,
            adapter_ids=torch.from_numpy(ids).to(dev))
        return self._greedy(logits)

    def _finish_slot(self, slot: int, finished: List[Request],
                     step: int) -> None:
        r = self.active[slot]
        r.done = True
        r.finish_reason = "length"
        r.finish_step = step
        finished.append(r)
        self.active[slot] = None
        self.positions[slot] = 0
        self.kv.free_slot(slot)

    def _finish_admitted(self, finished: List[Request], step: int,
                         queue: List[Request]) -> None:
        """Finish slots whose prefill token already completed the request
        (``max_new_tokens == 1``) and refill them before decoding."""
        while True:
            ended = False
            for i, r in enumerate(self.active):
                if r is not None and len(r.generated) >= r.max_new_tokens:
                    self._finish_slot(i, finished, step)
                    ended = True
            if not ended:
                return
            self._admit(step, queue)

    def run(self, requests: List[Request], max_steps: int = 512
            ) -> List[Request]:
        """Serve ``requests`` to completion (or ``max_steps``) in strict
        FIFO order.  Every request comes back: finished ones ``done``, the
        rest ``truncated`` with their partial output, pages freed."""
        seen = set()
        for r in requests:
            self._validate(r)
            if r.uid in seen:
                raise ValueError(f"duplicate request uid {r.uid}")
            seen.add(r.uid)
        for r in requests:
            r.generated, r.done, r.truncated = [], False, False
            r.finish_reason = r.admit_step = r.finish_step = None
            r.arrival_step = 0
        self._banked_tree()
        self._stats = dict(prefill_s=0.0, prefill_calls=0, decode_s=0.0,
                           decode_steps=0, decode_tokens=0)
        queue = list(requests)
        finished: List[Request] = []
        steps = 0
        while (queue or any(r is not None for r in self.active)) \
                and steps < max_steps:
            steps += 1
            self._admit(steps, queue)
            self._finish_admitted(finished, steps, queue)
            live = [i for i, r in enumerate(self.active) if r is not None]
            if not live:
                if queue:
                    raise OutOfPages(
                        f"request {queue[0].uid} (prompt "
                        f"{len(queue[0].prompt)} tokens) cannot fit an idle "
                        f"pool of {self.kv.num_pages - 1} pages")
                continue
            t0 = time.perf_counter()
            toks = self._decode_live(live)
            self._stats["decode_s"] += time.perf_counter() - t0
            self._stats["decode_steps"] += 1
            self._stats["decode_tokens"] += len(live)
            for i in live:
                r = self.active[i]
                r.generated.append(int(toks[i]))
                self.positions[i] += 1
                if len(r.generated) >= r.max_new_tokens \
                        or self.positions[i] >= self.max_len - 1:
                    self._finish_slot(i, finished, steps)
        self.last_run_stats = dict(self._stats, steps=steps)
        for i, r in enumerate(self.active):
            if r is not None:
                r.truncated = True
                finished.append(r)
                self.active[i] = None
                self.positions[i] = 0
                self.kv.free_slot(i)
        for r in queue:
            r.truncated = True
            finished.append(r)
        return finished
