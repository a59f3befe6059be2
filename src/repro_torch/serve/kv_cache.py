"""Block-paged KV cache: free-list page allocator, refcounted page tables
and content-hash shared-prefix reuse.

The device side is a pair of pools ``{"k","v"}: (L, num_pages, page_size,
KH, hd)`` (:func:`repro_torch.models.model.init_cache`) on the engine's
device; every slot owns an ordered list of page ids, its row of ``tables``.
The host side (this class, numpy) is the allocator, a copy of the
reference's:

* **free list**: pages are popped at admission (which reserves the
  request's worst-case footprint, so decode never faults) and pushed back
  when their last reference drops.  Page 0 is the TRASH page: unallocated
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
  and are evicted (least recently released first) only when the free list
  runs dry.

Suspend / resume (preemption) belongs to a later slice of the port.
"""
from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import Dict, List

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as model_lib

#: reserved page id no slot ever owns; masked / unallocated refs land here
TRASH_PAGE = 0


class OutOfPages(RuntimeError):
    """Every non-trash page is referenced; admission must wait for frees."""


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
        self.stats = {"prefix_queries": 0, "prefix_hits": 0,
                      "pages_aliased": 0, "pages_allocated": 0,
                      "evictions": 0}

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

    def _alloc(self) -> int:
        if self._free:
            p = self._free.pop()
        elif self._reusable:
            p, _ = self._reusable.popitem(last=False)
            h = self._page_to_hash.pop(p, None)
            if h is not None:
                self._hash_to_page.pop(h, None)
            self.stats["evictions"] += 1
        else:
            raise OutOfPages(f"all {self.num_pages - 1} KV pages referenced")
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
        h = self._page_to_hash.get(p)
        if h is not None:
            self._reusable[p] = None     # stays resident for prefix hits
        else:
            self._free.append(p)

    def admit(self, slot: int, prompt: np.ndarray, adapter_key: str,
              reserve_tokens: int = None) -> int:
        """Build ``slot``'s page table for ``prompt``: alias every resident
        shared-prefix page, allocate fresh pages for the rest of
        ``reserve_tokens`` (default: the prompt).  Returns the aliased prefix
        length in tokens.  Raises :class:`OutOfPages` with no state change
        if the fresh pages don't fit."""
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
        need = -(-reserve // self.page_size)
        # acquire the aliases BEFORE allocating: a retained prefix page sits
        # in the eviction pool and must not be handed out again
        for p in shared:
            self._acquire(p)
        n_fresh = need - len(shared)
        if n_fresh > len(self._free) + len(self._reusable):
            for p in shared:
                self._release(p)
            raise OutOfPages(
                f"{n_fresh} pages needed, "
                f"{len(self._free) + len(self._reusable)} allocatable")
        fresh = [self._alloc() for _ in range(n_fresh)]
        if shared:
            self.stats["prefix_hits"] += 1
            self.stats["pages_aliased"] += len(shared)
        row = shared + fresh
        self.tables[slot, :len(row)] = row
        self.n_pages[slot] = len(row)
        self._owned[slot] = list(row)
        return len(shared) * self.page_size

    def commit_prompt(self, slot: int, prompt: np.ndarray,
                      adapter_key: str) -> None:
        """Register ``slot``'s fully prompt-covered pages for sharing.  Call
        AFTER the prefill that filled them."""
        for i, h in enumerate(self._page_hashes(prompt, adapter_key)):
            p = int(self.tables[slot, i])
            if h in self._hash_to_page or p in self._page_to_hash:
                continue                  # already registered (e.g. aliased)
            self._hash_to_page[h] = p
            self._page_to_hash[p] = h

    def free_slot(self, slot: int) -> None:
        for p in self._owned[slot]:
            self._release(p)
        self._owned[slot] = []
        self.n_pages[slot] = 0
        self.tables[slot, :] = TRASH_PAGE

    def table_tensor(self, tables: np.ndarray = None) -> torch.Tensor:
        """``tables`` (default: the live ones) as an int32 tensor on the
        pools' device."""
        t = self.tables if tables is None else tables
        return torch.from_numpy(np.ascontiguousarray(t)).to(
            self.pools["k"].device)

    def pages_in_use(self) -> int:
        """Pages referenced by >= 1 slot (excludes retained)."""
        return int((self.refcount > 0).sum())
