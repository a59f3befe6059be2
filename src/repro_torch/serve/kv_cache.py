"""Block-paged KV cache: free-list page allocator, refcounted page tables
and content-hash shared-prefix reuse.

The device side is a pair of pools ``{"k","v"}: (L, num_pages, page_size,
KH, hd)`` (:func:`repro_torch.models.model.init_cache`) on the engine's
device; every slot owns an ordered list of page ids, its row of ``tables``.
The host side (this class, numpy) is the allocator, a copy of the
reference's:

* **free list**: pages are popped at admission (the FIFO ``run()``
  reserves the request's worst-case footprint, so its decode never faults)
  and pushed back when their last reference drops.  Page 0 is the TRASH page: unallocated
  table entries point at it and right-pad prefill writes land in it.
* **refcounts**: prefix pages are shared across slots; only the last owner
  frees a page.
* **prefix registry**: after a prompt is prefilled, each FULL prompt page is
  registered under the cumulative hash of (adapter, prompt[:page_end]); a
  later admission whose prompt chains through resident hashes aliases those
  pages instead of re-prefilling them.
* **copy-on-extend**: sharing is capped at ``(len(prompt) - 1) // page``
  pages, so every admission prefills >= 1 suffix token and the page a slot
  writes into is always its own.
* **retention**: registered pages whose refcount drops to 0 stay resident
  and are evicted only when the free list runs dry.  Eviction is
  priority-aware: each outstanding suspension (:meth:`PagedKVCache
  .suspend_slot`) pins its pages at the request's priority, and retained
  pages evict lowest-pin-priority first; within a priority level the TAIL
  of a suspended chain evicts before its head (resume's prefix aliasing
  walks the cumulative hash chain from token 0); remaining ties break LRU.
  Pins are per suspension: a page shared by several suspended sequences
  stays privileged until the last dependent resumes or is abandoned
  (:meth:`PagedKVCache.release_pin`).
* **suspend / resume** (preemption): ``suspend_slot`` releases a slot's
  pages while registering every *full* page of its prompt+generated
  sequence in the retained pool; ``resume_slot`` is an ``admit`` of the
  full sequence, so a resumed request re-aliases everything still resident
  and re-prefills only the evicted tail.
* **growth on demand**: a preempting engine reserves only the prompt (or
  the first prefill chunk) at admission and grows a slot's table through
  :meth:`PagedKVCache.ensure_position`; its :class:`OutOfPages` is what
  triggers a decode-time suspension.
* **rollback**: speculative decode grows a slot's table to cover its draft
  window and returns the rejected tail's whole pages through
  :meth:`PagedKVCache.truncate_slot`.

Allocation failure raises :class:`OutOfPages` (built by
:meth:`PagedKVCache.oom`, which also gauges the pool pressure on the
cache's tracker).
"""
from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as model_lib
from repro_torch.obs import NOOP, Tracker

#: reserved page id no slot ever owns; masked / unallocated refs land here
TRASH_PAGE = 0


class OutOfPages(RuntimeError):
    """Every non-trash page is referenced; admission must wait for frees.

    ``referenced`` / ``resident`` / ``retained`` carry the pool pressure at
    raise time (None when the raiser had no pool in hand); the same counts
    are gauged as ``kv/oom_*`` on the cache's tracker."""

    def __init__(self, msg: str, referenced: Optional[int] = None,
                 resident: Optional[int] = None,
                 retained: Optional[int] = None):
        super().__init__(msg)
        self.referenced = referenced
        self.resident = resident
        self.retained = retained


class PagedKVCache:
    """Host-side page allocator over device-side paged KV pools."""

    def __init__(self, cfg: ModelConfig, slots: int, max_len: int,
                 page_size: int = 16, num_pages: int = None,
                 device="cuda"):
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.page_size = int(page_size)
        self.pages_per_slot = -(-max_len // self.page_size)
        if num_pages is None:
            num_pages = 1 + slots * self.pages_per_slot
        if num_pages < 2:
            raise ValueError("need at least one non-trash page")
        self.num_pages = int(num_pages)
        self.slots = slots
        self.max_len = max_len
        #: {"k","v"}: (L, num_pages, page_size, KH, hd) device pools
        self.pools = model_lib.init_cache(cfg, slots, max_len,
                                          page_size=self.page_size,
                                          num_pages=self.num_pages,
                                          device=device)
        #: per-slot page lists, position-ordered; TRASH_PAGE = unallocated
        self.tables = np.zeros((slots, self.pages_per_slot), np.int32)
        self.n_pages = np.zeros((slots,), np.int32)
        self._owned: List[List[int]] = [[] for _ in range(slots)]
        self.refcount = np.zeros((self.num_pages,), np.int32)
        self._free: List[int] = list(range(self.num_pages - 1, 0, -1))
        self._hash_to_page: Dict[str, int] = {}
        self._page_to_hash: Dict[int, str] = {}
        #: refcount-0 registered pages kept resident, least recent first
        self._reusable: "OrderedDict[int, None]" = OrderedDict()
        #: eviction pins, one per outstanding suspension: token ->
        #: (priority, {page id -> position in the suspended chain})
        self._pins: Dict[int, Tuple[int, Dict[int, int]]] = {}
        self._next_pin = 0
        self.stats = {"prefix_queries": 0, "prefix_hits": 0,
                      "pages_aliased": 0, "pages_allocated": 0,
                      "evictions": 0, "suspends": 0, "resumes": 0}
        #: metrics backend (repro_torch.obs); the engine shares its own via
        #: :meth:`set_tracker`.  ``_obs`` gates per-call metric work
        self.tracker: Tracker = NOOP
        self._obs = False

    def set_tracker(self, tracker: Tracker) -> None:
        self.tracker = tracker
        self._obs = not tracker.is_noop

    # -- observability -----------------------------------------------------
    def observe_pool(self, step: Optional[int] = None) -> None:
        """Gauge the pool's occupancy and pressure (host-side counters)."""
        tr = self.tracker
        in_use = self.pages_in_use()
        tr.gauge("kv/pages_in_use", in_use, step=step)
        tr.gauge("kv/pages_retained", len(self._reusable), step=step)
        tr.gauge("kv/pool_pressure", in_use / (self.num_pages - 1),
                 step=step)

    def conservation(self) -> Dict[str, int]:
        """Allocator conservation snapshot: every non-trash page is exactly
        one of free / referenced / retained (``conserved`` 0 means a leak
        or a double free)."""
        in_use = self.pages_in_use()
        snap = {"free": len(self._free), "in_use": in_use,
                "retained": len(self._reusable),
                "total": self.num_pages - 1}
        snap["conserved"] = int(
            snap["free"] + in_use + snap["retained"] == snap["total"])
        return snap

    def record_conservation(self, step: Optional[int] = None) -> None:
        """Gauge a :meth:`conservation` snapshot."""
        for k, v in self.conservation().items():
            self.tracker.gauge(f"kv/conservation_{k}", v, step=step)

    def oom(self, msg: str) -> OutOfPages:
        """An :class:`OutOfPages` carrying the pool pressure at raise time,
        gauging the same counts on the tracker (raise sites do ``raise
        self.oom(...)``, so caught-and-retried OOMs leave a trail)."""
        referenced = self.pages_in_use()
        resident = self.pages_resident()
        retained = len(self._reusable)
        tr = self.tracker
        tr.count("kv/out_of_pages")
        tr.gauge("kv/oom_referenced", referenced)
        tr.gauge("kv/oom_resident", resident)
        tr.gauge("kv/oom_retained", retained)
        return OutOfPages(msg, referenced=referenced, resident=resident,
                          retained=retained)

    # -- hashing -----------------------------------------------------------
    def _page_hashes(self, prompt: np.ndarray, adapter_key: str) -> List[str]:
        """Cumulative content hash per FULL page of ``prompt``."""
        hasher = hashlib.blake2b(repr(adapter_key).encode())
        out = []
        for i in range(len(prompt) // self.page_size):
            page = np.ascontiguousarray(
                prompt[i * self.page_size:(i + 1) * self.page_size],
                dtype=np.int32)
            hasher.update(page.tobytes())
            out.append(hasher.hexdigest())
        return out

    # -- allocation --------------------------------------------------------
    def _evict_key(self, q: int) -> Tuple[int, int]:
        """Eviction order of retained page ``q``: lowest pin priority first,
        and within a level tail-of-chain first.  Unpinned pages are (0, 0);
        ``min`` over the insertion-ordered dict breaks ties LRU."""
        level, pos = 0, None
        for prio, pages in self._pins.values():
            i = pages.get(q)
            if i is None:
                continue
            level = max(level, prio)
            pos = i if pos is None else min(pos, i)
        return (level, -(pos or 0))

    def _unpin_page(self, p: int) -> None:
        """Drop ``p`` from every pin: its content died (evicted or freed
        unregistered)."""
        for _prio, pages in self._pins.values():
            pages.pop(p, None)

    def _alloc(self) -> int:
        if self._free:
            p = self._free.pop()
        elif self._reusable:
            p = min(self._reusable, key=self._evict_key)
            self._reusable.pop(p)
            self._unpin_page(p)
            h = self._page_to_hash.pop(p, None)
            if h is not None:
                self._hash_to_page.pop(h, None)
            self.stats["evictions"] += 1
            if self._obs:
                self.tracker.count("kv/evictions")
        else:
            raise self.oom(
                f"all {self.num_pages - 1} KV pages referenced "
                f"({self.pages_in_use()} live, "
                f"{self.pages_resident()} resident, 0 retained)")
        self.refcount[p] = 1
        self.stats["pages_allocated"] += 1
        return p

    def _acquire(self, p: int) -> None:
        if self.refcount[p] == 0:
            self._reusable.pop(p, None)
        self.refcount[p] += 1

    def _release(self, p: int) -> None:
        self.refcount[p] -= 1
        if self.refcount[p] > 0:
            return
        if p in self._page_to_hash:
            self._reusable[p] = None     # stays resident for prefix hits
        else:
            self._unpin_page(p)
            self._free.append(p)

    # -- slot lifecycle ----------------------------------------------------
    def admit(self, slot: int, prompt: np.ndarray, adapter_key: str,
              reserve_tokens: int = None,
              alloc_tokens: Optional[int] = None) -> int:
        """Build ``slot``'s page table for ``prompt``: alias every resident
        shared-prefix page, allocate fresh pages for the rest.

        ``reserve_tokens`` (default: the prompt length) is the footprint
        allocated up front: the FIFO ``run()`` reserves the worst case
        ``min(len + max_new, max_len)``; the preempting engine reserves only
        the prompt and grows via :meth:`ensure_position`.
        ``alloc_tokens`` (chunked prefill; only with the default
        ``reserve_tokens``) caps the up-front allocation at the aliased
        prefix plus that many suffix tokens.

        Returns the aliased prefix length in tokens (a page multiple, capped
        so >= 1 suffix token remains to prefill).  Raises
        :class:`OutOfPages` with no state change if the fresh pages don't
        fit."""
        if self.n_pages[slot] != 0 or self._owned[slot]:
            raise RuntimeError(f"slot {slot} not freed before re-admission")
        n = len(prompt)
        if n > self.pages_per_slot * self.page_size:
            raise ValueError(f"prompt of {n} tokens exceeds slot capacity "
                             f"{self.pages_per_slot * self.page_size}")
        reserve = n if reserve_tokens is None else max(n, reserve_tokens)
        reserve = min(reserve, self.pages_per_slot * self.page_size)
        hashes = self._page_hashes(prompt, adapter_key)
        shared: List[int] = []
        self.stats["prefix_queries"] += 1
        for i in range(min(len(hashes), (n - 1) // self.page_size)):
            p = self._hash_to_page.get(hashes[i])
            if p is None:
                break
            shared.append(p)
        if alloc_tokens is not None and reserve_tokens is None:
            # chunked prefill: fresh pages for the first chunk only
            reserve = min(reserve,
                          len(shared) * self.page_size + alloc_tokens)
        need = -(-reserve // self.page_size)
        # acquire the aliases BEFORE allocating: a retained prefix page sits
        # in the eviction pool and must not be handed out again
        for p in shared:
            self._acquire(p)
        # capacity check before touching the eviction pool: a failing admit
        # must not flush retained pages it then can't use
        n_fresh = need - len(shared)
        if n_fresh > len(self._free) + len(self._reusable):
            for p in shared:
                self._release(p)
            raise self.oom(
                f"{n_fresh} pages needed, "
                f"{len(self._free) + len(self._reusable)} allocatable "
                f"({self.pages_in_use()} of {self.num_pages - 1} referenced, "
                f"{self.pages_resident()} resident, "
                f"{len(self._reusable)} retained)")
        fresh = [self._alloc() for _ in range(n_fresh)]
        if shared:
            self.stats["prefix_hits"] += 1
            self.stats["pages_aliased"] += len(shared)
        if self._obs:
            # hit/miss in TOKENS: aliased-prefix tokens never re-prefill
            self.tracker.count("kv/prefix_hit_tokens",
                               len(shared) * self.page_size)
            self.tracker.count("kv/prefix_miss_tokens",
                               n - len(shared) * self.page_size)
            self.observe_pool()
        row = shared + fresh
        self.tables[slot, :len(row)] = row
        self.n_pages[slot] = len(row)
        self._owned[slot] = list(row)
        return len(shared) * self.page_size

    def _register_pages(self, slot: int, tokens: np.ndarray,
                        adapter_key: str) -> List[int]:
        """Register ``slot``'s pages fully covered by ``tokens`` under their
        cumulative hashes; returns the page ids covered."""
        covered = []
        for i, h in enumerate(self._page_hashes(tokens, adapter_key)):
            p = int(self.tables[slot, i])
            covered.append(p)
            if h in self._hash_to_page or p in self._page_to_hash:
                continue                  # already registered (e.g. aliased)
            self._hash_to_page[h] = p
            self._page_to_hash[p] = h
        return covered

    def commit_prompt(self, slot: int, prompt: np.ndarray,
                      adapter_key: str) -> None:
        """Register ``slot``'s fully prompt-covered pages for sharing.  Call
        AFTER the prefill that filled them."""
        self._register_pages(slot, prompt, adapter_key)

    def ensure_position(self, slot: int, pos: int) -> None:
        """Allocate pages so ``slot`` can write KV at position ``pos`` (a
        no-op when admission reserved the full footprint)."""
        idx = pos // self.page_size
        if idx >= self.pages_per_slot:
            raise self.oom(
                f"position {pos} beyond slot capacity "
                f"{self.pages_per_slot * self.page_size}")
        while self.n_pages[slot] <= idx:
            p = self._alloc()
            self.tables[slot, self.n_pages[slot]] = p
            self._owned[slot].append(p)
            self.n_pages[slot] += 1

    def truncate_slot(self, slot: int, n_keep: int) -> None:
        """Release ``slot``'s trailing pages beyond the first ``n_keep``
        (speculative-decode rollback: pages grown for a draft window whose
        tail was rejected go back to the pool).  Trailing pages are the
        slot's most recently grown ones (aliased prefix pages sit at the
        front of its table), and each release goes through the refcount."""
        if n_keep < 1:
            raise ValueError(f"slot {slot} must keep >= 1 page, got "
                             f"{n_keep}")
        while self.n_pages[slot] > n_keep:
            idx = int(self.n_pages[slot]) - 1
            p = int(self.tables[slot, idx])
            owned = self._owned[slot].pop()
            if owned != p:
                raise RuntimeError(
                    f"slot {slot} table/_owned order diverged at page index "
                    f"{idx}: owned {owned} vs table {p}")
            self.tables[slot, idx] = TRASH_PAGE
            self.n_pages[slot] -= 1
            self._release(p)

    def free_slot(self, slot: int) -> None:
        for p in self._owned[slot]:
            self._release(p)
        self._owned[slot] = []
        self.n_pages[slot] = 0
        self.tables[slot, :] = TRASH_PAGE

    # -- preemption --------------------------------------------------------
    def suspend_slot(self, slot: int, tokens: np.ndarray, adapter_key: str,
                     priority: int = 0) -> int:
        """Preempt ``slot``: release its pages while keeping its computed KV
        recoverable.  ``tokens`` is the slot's resident sequence; every
        page it fully covers is registered and stays retained, pinned at
        ``priority`` in the eviction order while the returned pin token is
        outstanding (:meth:`resume_slot` / :meth:`release_pin`).  The
        partial tail page returns to the free list."""
        if self.n_pages[slot] == 0:
            raise RuntimeError(f"slot {slot} has nothing to suspend")
        covered = self._register_pages(slot, tokens, adapter_key)
        token = self._next_pin
        self._next_pin += 1
        self._pins[token] = (priority, {p: i for i, p in enumerate(covered)})
        self.stats["suspends"] += 1
        if self._obs:
            self.tracker.count("kv/suspends")
            self.record_conservation()
        self.free_slot(slot)
        return token

    def resume_slot(self, slot: int, tokens: np.ndarray, adapter_key: str,
                    reserve_tokens: int = None,
                    alloc_tokens: Optional[int] = None,
                    pin: Optional[int] = None) -> int:
        """Rebuild a suspended slot's table for its full sequence: an
        :meth:`admit` of ``tokens`` that also releases the suspension's
        pin.  Returns the aliased length in tokens; the caller re-prefills
        only ``tokens[aliased:]``.  On :class:`OutOfPages` the pin stays."""
        prefix = self.admit(slot, tokens, adapter_key,
                            reserve_tokens=reserve_tokens,
                            alloc_tokens=alloc_tokens)
        if pin is not None:
            self.release_pin(pin)
        self.stats["resumes"] += 1
        if self._obs:
            self.tracker.count("kv/resumes")
        return prefix

    def release_pin(self, pin: int) -> None:
        """Drop a suspension's eviction pin without resuming it; its
        retained pages demote to ordinary prefix-cache residency."""
        self._pins.pop(pin, None)

    def alias_probe(self, tokens: np.ndarray, adapter_key: str) -> int:
        """Full pages of ``tokens`` an :meth:`admit` would alias right now
        (read-only hash-chain walk)."""
        hashes = self._page_hashes(tokens, adapter_key)
        n = 0
        for i in range(min(len(hashes), (len(tokens) - 1) // self.page_size)):
            if hashes[i] not in self._hash_to_page:
                break
            n += 1
        return n

    def exclusive_pages(self, slot: int) -> int:
        """Pages only ``slot`` references — what suspending it would return
        to the allocatable (free + retained) pool."""
        return sum(1 for p in self._owned[slot] if self.refcount[p] == 1)

    def allocatable_pages(self) -> int:
        """Pages an admit could draw on right now (free + evictable)."""
        return len(self._free) + len(self._reusable)

    # -- views / accounting ------------------------------------------------
    def table_tensor(self, tables: np.ndarray = None) -> torch.Tensor:
        """``tables`` (default: the live ones) as an int32 tensor on the
        pools' device (a copy that does not wait for the card)."""
        t = self.tables if tables is None else tables
        return torch.from_numpy(np.array(t, np.int32)).to(
            self.pools["k"].device, non_blocking=True)

    def pages_in_use(self) -> int:
        """Pages referenced by >= 1 slot (excludes retained)."""
        return int((self.refcount > 0).sum())

    def pages_resident(self) -> int:
        """Referenced + retained-for-reuse pages."""
        return self.pages_in_use() + len(self._reusable)

    def prefix_hit_ratio(self) -> float:
        q = self.stats["prefix_queries"]
        return self.stats["prefix_hits"] / q if q else 0.0
