"""Paged KV pool, host side (``repro.serve.cache.PagePool``).

KV memory is ``n_pages`` fixed-size pages shared by every slot.
:class:`PagePool` decides which physical pages a slot's logical
positions map to; the device consumes the mapping as a
``(max_batch, max_pages)`` int32 page table (:meth:`PagePool.table_row`).
Dropping a slot's mapping *is* the invalidation. The reference's
refcounting, index pins and copy-on-write serve its prefix cache, which
is a later slice of the port: here a page is free or owned by one slot.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch


class PagePool:
    """Fixed-size-page allocator over ``n_pages`` physical pages.

    Invariants (tests/test_torch_serve.py): ``alloc`` is all-or-nothing;
    no page is owned by two slots; free + owned == n_pages; ``defrag``
    keeps every slot's logical -> token mapping.
    """

    def __init__(self, n_pages: int, page_size: int):
        if n_pages < 1 or page_size < 1:
            raise ValueError("n_pages and page_size must be >= 1")
        self.n_pages = n_pages
        self.page_size = page_size
        self._free: List[int] = list(range(n_pages - 1, -1, -1))
        self._slots: Dict[int, List[int]] = {}

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

    def alloc(self, slot: int, n: int) -> bool:
        """Append ``n`` fresh pages to ``slot``; all-or-nothing."""
        if n > len(self._free):
            return False
        self._slots.setdefault(slot, []).extend(
            self._free.pop() for _ in range(n))
        return True

    def ensure(self, slot: int, n_tokens: int) -> bool:
        """Grow ``slot`` so positions [0, n_tokens) are mapped."""
        have = len(self._slots.get(slot, ()))
        return self.alloc(slot, max(0, self.pages_for(n_tokens) - have))

    def free_slot(self, slot: int) -> int:
        """Return every page of ``slot`` to the free list."""
        pages = self._slots.pop(slot, [])
        self._free.extend(pages)
        return len(pages)

    def table_row(self, slot: int, max_pages: int) -> np.ndarray:
        """(max_pages,) int32 page-table row for ``slot`` (-1 unmapped)."""
        row = np.full((max_pages,), -1, np.int32)
        pages = self._slots.get(slot, ())
        row[: len(pages)] = pages
        return row

    def defrag(self) -> np.ndarray:
        """Compact owned pages to the lowest physical indices.

        Returns ``perm`` (n_pages + 1,) with ``new_pool[i] =
        old_pool[perm[i]]``; apply it to the device pools with
        :func:`apply_defrag` before the next step reads the rewritten
        tables. The trailing trash page stays put.
        """
        order: List[int] = []
        for slot in sorted(self._slots):
            new_pages = []
            for old in self._slots[slot]:
                new_pages.append(len(order))
                order.append(old)
            self._slots[slot] = new_pages
        owned = set(order)
        free_old = [i for i in range(self.n_pages) if i not in owned]
        self._free = list(range(self.n_pages - 1, len(order) - 1, -1))
        perm = np.empty((self.n_pages + 1,), np.int32)
        perm[: len(order)] = order
        perm[len(order): self.n_pages] = free_old
        perm[self.n_pages] = self.n_pages
        return perm


def apply_defrag(cache, perm):
    """Gather the layer-stacked pools ``(n_layers, n_pages + 1, ...)``
    into the post-``defrag`` page order, in place."""
    for pool in cache.values():
        idx = torch.as_tensor(perm, dtype=torch.long, device=pool.device)
        pool.copy_(pool.index_select(1, idx))
    return cache
