"""KV-cache memory for continuous batching (``repro.serve.cache``): the
dense slot slab and the paged pool.

**Slot slab** (recurrent and hybrid stacks, or ``kv_layout="slab"``):
the model's decode cache (``lm.init_cache``, or ``encdec.init_cache``'s
{"self", "cross"} pair of such lists) with batch = ``max_batch``, one
dict per layer with the batch on axis 0. A *slot* is one index of that
axis: admission writes a freshly prefilled single-request cache into it
(:func:`write_slot`), retirement abandons it. An enc-dec model's paged
cache keeps such a dense per-slot ``cross`` slab beside its pools.

**Paged pool** (attention-only stacks):

KV memory is ``n_pages`` fixed-size pages shared by every slot.
:class:`PagePool` decides which physical pages a slot's logical
positions map to; the device consumes the mapping as a
``(max_batch, max_pages)`` int32 page table (:meth:`PagePool.table_row`).
Dropping a slot's mapping *is* the invalidation. The pool is
refcounted: one physical page may sit in many slots' tables (the
cross-request prefix cache, ``serve.prefix.PrefixIndex``), may be
pinned by the index with no slot referencing it (``cache``/``uncache``),
and is copy-on-written (``cow``) before a slot writes into a page
another holder can see. :func:`copy_pages` and :func:`apply_defrag` are
the device halves of ``cow`` and ``defrag``; they leave an enc-dec
``cross`` slab as it is.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from repro_torch.models.layers import paged_copy_pages
from repro_torch.train.steps import ModelAPI


def init_slab(cfg, max_batch: int, max_len: int, window=None, *,
              device="cuda"):
    """Batched decode cache with one slot per concurrent request."""
    return ModelAPI(cfg).init_cache(max_batch, max_len, window,
                                    device=device)


def write_slot(slab, cache, slot: int):
    """Write a prefilled single-request cache (batch 1) into ``slot`` of
    the slab (a list of per-layer dicts, or a dict of such lists), in
    place; returns the slab."""
    if isinstance(slab, dict):
        for key, part in slab.items():
            write_slot(part, cache[key], slot)
        return slab
    for dst, src in zip(slab, cache):
        for name, t in dst.items():
            t[slot:slot + 1] = src[name].to(t.dtype)
    return slab


def read_slot(slab, slot: int):
    """A copy of ``slot``'s cache (batch kept, size 1)."""
    return [{name: t[slot:slot + 1].clone() for name, t in layer.items()}
            for layer in slab]


def invalidate_beyond(cache, true_len):
    """Mark an attention cache's slots at index >= ``true_len`` empty
    (``slot_pos`` -1), in place, so that a prompt right-padded to one
    prefill length decodes as an unpadded one would. true_len: (B,)
    per-row true lengths. Recurrent entries, and an enc-dec cache's
    ``cross`` caches (the whole encoder output), are left as they
    are."""
    if isinstance(cache, dict):
        invalidate_beyond(cache["self"], true_len)
        return cache
    for layer in cache:
        if "slot_pos" in layer and "k" in layer:
            sp = layer["slot_pos"]
            tl = torch.as_tensor(true_len, device=sp.device).reshape(-1, 1)
            idx = torch.arange(sp.shape[-1], device=sp.device)
            sp.masked_fill_(idx[None, :] >= tl, -1)
    return cache


class PagePool:
    """Refcounted fixed-size-page allocator over ``n_pages`` physical
    pages.

    The pool decides *which* physical pages a slot's logical positions
    map to; the device side consumes the mapping as an
    ``(max_batch, max_pages)`` int32 page table (``table_row``). A
    physical page is in exactly one of three states:

      * **free** — on the free list, content meaningless;
      * **referenced** — mapped by ``refcount(p) >= 1`` slots (prefix
        sharing maps one physical page into many tables);
      * **cached** — refcount 0 but pinned by the prefix index
        (``cache``), holding reusable KV until ``uncache`` (LRU
        eviction under pool pressure) releases it.

    Invariants (tests/test_torch_serve.py, tests/test_torch_prefix.py):

      * ``alloc`` is all-or-nothing — a partial grant never leaks pages;
      * ``free_slot`` decrements every mapped page; only pages reaching
        refcount 0 *and* not cached return to the free list — no page is
        freed while any slot or the index can still read it;
      * ``cow`` never hands a slot a page another holder can see: a
        shared mapping (refcount > 1, or cached) is swapped for a fresh
        page, the original keeps its other holders;
      * ``defrag`` preserves every slot's logical->token mapping *and*
        all sharing structure (a page mapped by k slots is moved once
        and all k tables point at its new index); cached pages keep
        their content too.
    """

    def __init__(self, n_pages: int, page_size: int):
        if n_pages < 1 or page_size < 1:
            raise ValueError("n_pages and page_size must be >= 1")
        self.n_pages = n_pages
        self.page_size = page_size
        self._free: List[int] = list(range(n_pages - 1, -1, -1))
        self._slots: Dict[int, List[int]] = {}
        self._ref: List[int] = [0] * n_pages
        self._cached: set = set()

    # ------------------------------------------------------------------ #
    def pages_for(self, n_tokens: int) -> int:
        """Pages needed to hold ``n_tokens`` logical positions."""
        return max(0, -(-n_tokens // self.page_size))

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return self.n_pages - len(self._free)

    def utilization(self) -> float:
        return self.used_pages / self.n_pages

    def slot_pages(self, slot: int) -> List[int]:
        return list(self._slots.get(slot, ()))

    def refcount(self, page: int) -> int:
        """Slot references on ``page`` (index pins are separate)."""
        return self._ref[page]

    def is_cached(self, page: int) -> bool:
        return page in self._cached

    def is_shared(self, page: int) -> bool:
        """True when a write to ``page`` would be visible to another
        holder — a second slot, or the prefix index."""
        return self._ref[page] > 1 or page in self._cached

    # ------------------------------------------------------------------ #
    def alloc(self, slot: int, n: int) -> bool:
        """Append ``n`` fresh pages to ``slot``; all-or-nothing."""
        if n > len(self._free):
            return False
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self._ref[p] = 1
        self._slots.setdefault(slot, []).extend(pages)
        return True

    def share(self, slot: int, pages: List[int]) -> None:
        """Append already-live pages to ``slot``'s table (prefix hit).

        Each page must be referenced or cached — sharing a free page
        would map memory the allocator can hand to someone else.
        """
        for p in pages:
            if self._ref[p] == 0 and p not in self._cached:
                raise ValueError(f"page {p} is free; cannot share it")
        for p in pages:
            self._ref[p] += 1
        self._slots.setdefault(slot, []).extend(pages)

    def ensure(self, slot: int, n_tokens: int) -> bool:
        """Grow ``slot`` so positions [0, n_tokens) are mapped."""
        have = len(self._slots.get(slot, ()))
        return self.alloc(slot, max(0, self.pages_for(n_tokens) - have))

    def free_slot(self, slot: int) -> int:
        """Drop every mapping of ``slot``; a page returns to the free
        list only once nothing else (slot or index pin) holds it."""
        pages = self._slots.pop(slot, [])
        for p in pages:
            self._ref[p] -= 1
            if self._ref[p] == 0 and p not in self._cached:
                self._free.append(p)
        return len(pages)

    # ------------------------------------------------------------------ #
    def cache(self, pages: List[int]) -> None:
        """Pin ``pages`` for the prefix index: refcount-0 pins survive
        ``free_slot`` and leave the pool only via ``uncache``."""
        for p in pages:
            if self._ref[p] == 0 and p not in self._cached:
                raise ValueError(f"page {p} is free; cannot cache it")
        self._cached.update(pages)

    def uncache(self, pages: List[int]) -> int:
        """Drop index pins; returns how many pages became free."""
        freed = 0
        for p in pages:
            if p in self._cached:
                self._cached.discard(p)
                if self._ref[p] == 0:
                    self._free.append(p)
                    freed += 1
        return freed

    def cow(self, slot: int, logical: int):
        """Copy-on-write: give ``slot`` a private page at table index
        ``logical`` before it writes there.

        Returns ``(src, dst)`` physical ids for the device-side content
        copy, or ``None`` when the mapping is already private (no copy
        needed). Raises if a copy is needed but the free list is empty —
        callers evict/preempt first.
        """
        pages = self._slots[slot]
        src = pages[logical]
        if not self.is_shared(src):
            return None
        if not self._free:
            raise RuntimeError(
                f"cow needs a free page (slot {slot}, logical {logical}) "
                f"but the pool is exhausted")
        dst = self._free.pop()
        self._ref[dst] = 1
        self._ref[src] -= 1  # shared -> still held by someone else
        pages[logical] = dst
        return (src, dst)

    def table_row(self, slot: int, max_pages: int) -> np.ndarray:
        """(max_pages,) int32 page-table row for ``slot`` (-1 unmapped)."""
        row = np.full((max_pages,), -1, np.int32)
        pages = self._slots.get(slot, ())
        row[: len(pages)] = pages
        return row

    # ------------------------------------------------------------------ #
    def defrag(self) -> np.ndarray:
        """Compact occupied pages to the lowest physical indices.

        Returns ``perm`` of shape (n_pages + 1,): ``new_pool[i] =
        old_pool[perm[i]]`` — apply to the device pools with
        :func:`apply_defrag` *before* the next step consumes the updated
        page tables. The trailing trash page stays put. After
        compaction the free list is the contiguous tail.
        """
        order: List[int] = []
        remap: Dict[int, int] = {}
        for slot in sorted(self._slots):
            new_pages = []
            for old in self._slots[slot]:
                if old not in remap:  # shared pages move exactly once
                    remap[old] = len(order)
                    order.append(old)
                new_pages.append(remap[old])
            self._slots[slot] = new_pages
        # refcount-0 cached pages hold reusable KV: compact them right
        # after the referenced pages so the free tail stays truly free
        for old in sorted(self._cached):
            if old not in remap:
                remap[old] = len(order)
                order.append(old)
        free_old = [i for i in range(self.n_pages) if i not in remap]
        self._free = list(range(self.n_pages - 1, len(order) - 1, -1))
        new_ref = [0] * self.n_pages
        for old, new in remap.items():
            new_ref[new] = self._ref[old]
        self._ref = new_ref
        self._cached = {remap[p] for p in self._cached}
        perm = np.empty((self.n_pages + 1,), np.int32)
        perm[: len(order)] = order
        perm[len(order): self.n_pages] = free_old
        perm[self.n_pages] = self.n_pages  # trash page fixed
        return perm

    @staticmethod
    def remap_from_perm(perm) -> Dict[int, int]:
        """old physical id -> new physical id for a ``defrag`` perm
        (``new_pool[i] = old_pool[perm[i]]``); consumed by
        ``serve.prefix.PrefixIndex.remap``."""
        return {int(old): new for new, old in enumerate(perm[:-1])}


def _pools(cache):
    """The layer-stacked page pools of a paged cache: the cache itself,
    or an enc-dec cache's ``self`` entry (its ``cross`` slab is dense)."""
    return cache["self"] if "self" in cache else cache


def apply_defrag(cache, perm):
    """Gather the layer-stacked pools ``(n_layers, n_pages + 1, ...)``,
    values and any dequant scales, into the post-``defrag`` page order,
    in place."""
    for pool in _pools(cache).values():
        idx = torch.as_tensor(perm, dtype=torch.long, device=pool.device)
        pool.copy_(pool.index_select(1, idx))
    return cache


def copy_pages(cache, src: List[int], dst: List[int]):
    """Duplicate physical pages ``src[i] -> dst[i]`` in every pool of
    the layer-stacked cache (the device half of :meth:`PagePool.cow`),
    in place."""
    if src:
        paged_copy_pages(_pools(cache), src, dst)
    return cache
