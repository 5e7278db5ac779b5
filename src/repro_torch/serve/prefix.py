"""Cross-request prefix index (``repro.serve.prefix``): a radix trie
over the paged KV pool at page granularity.

K/V at position ``i`` depends only on the token prefix
``tokens[:i+1]``, so pages are shareable exactly along token-prefix
chains:

  * a node's key is one page worth (``page_size``) of token ids; the
    path from the root spells the full prefix;
  * a node's value is the physical page holding that span's K/V in the
    :class:`repro_torch.serve.cache.PagePool`; the index pins it
    (``pool.cache``) so retiring the request that wrote it does not
    recycle the memory; the first writer of a chain wins;
  * ``lookup`` walks the longest indexed page-aligned prefix, and the
    engine maps those pages straight into the new slot's page table
    (``pool.share``): prefill starts at the first uncached token;
  * under pool pressure ``evict`` releases least-recently-used *leaf*
    entries whose pages no slot references (refcount 0), so every
    stored chain stays contiguous from the root.

Namespaces keep media-conditioned streams apart (the reference keys
enc-dec requests by a digest of their media); token-only requests use
the ``None`` namespace. Host-side Python only; the engine owns the
device-side content (copy-on-write copies, defrag gathers) and calls
:meth:`PrefixIndex.remap` after ``PagePool.defrag`` renumbers pages.
"""
from __future__ import annotations

import itertools
from typing import Dict, List, Optional, Sequence, Tuple


class _Node:
    __slots__ = ("key", "page", "children", "parent", "namespace",
                 "last_used")

    def __init__(self, key, page, parent, namespace, last_used):
        self.key: Tuple[int, ...] = key
        self.page: int = page
        self.children: Dict[Tuple[int, ...], "_Node"] = {}
        self.parent: Optional[_Node] = parent  # None -> root child
        self.namespace = namespace
        self.last_used: int = last_used


class PrefixIndex:
    def __init__(self, pool, page_size: int):
        if page_size != pool.page_size:
            raise ValueError(
                f"index page_size {page_size} != pool page_size "
                f"{pool.page_size}")
        self.pool = pool
        self.page_size = page_size
        self._roots: Dict[object, Dict[Tuple[int, ...], _Node]] = {}
        self._nodes: List[_Node] = []
        self._clock = itertools.count()

    # ------------------------------------------------------------------ #
    @property
    def n_entries(self) -> int:
        return len(self._nodes)

    def lookup(self, tokens: Sequence[int], namespace=None) -> List[int]:
        """Physical pages of the longest indexed page-aligned prefix of
        ``tokens``; touches every matched node (LRU recency)."""
        out: List[int] = []
        children = self._roots.get(namespace)
        if not children:
            return out
        t = next(self._clock)
        for i in range(len(tokens) // self.page_size):
            key = tuple(tokens[i * self.page_size: (i + 1) * self.page_size])
            node = children.get(key)
            if node is None:
                break
            node.last_used = t
            out.append(node.page)
            children = node.children
        return out

    def insert(self, tokens: Sequence[int], pages: Sequence[int],
               namespace=None) -> int:
        """Register the chain of full pages spelling ``tokens``.

        ``pages[i]`` holds the K/V of ``tokens[i*ps:(i+1)*ps]``. Nodes
        already present keep their page (first writer wins — both pages
        hold bitwise-identical KV, so dedupe is free); new nodes pin
        their page in the pool. Returns how many new entries were added.
        """
        n_full = min(len(tokens) // self.page_size, len(pages))
        children = self._roots.setdefault(namespace, {})
        t = next(self._clock)
        parent: Optional[_Node] = None
        added = 0
        for i in range(n_full):
            key = tuple(tokens[i * self.page_size: (i + 1) * self.page_size])
            node = children.get(key)
            if node is None:
                node = _Node(key, pages[i], parent, namespace, t)
                self.pool.cache([pages[i]])
                children[key] = node
                self._nodes.append(node)
                added += 1
            else:
                node.last_used = t
            parent = node
            children = node.children
        return added

    # ------------------------------------------------------------------ #
    def _evictable(self) -> List[_Node]:
        """Leaves whose pages no slot references: safe to release."""
        return [n for n in self._nodes
                if not n.children and self.pool.refcount(n.page) == 0]

    def evict(self, n_pages: int) -> int:
        """Release LRU evictable entries until ``n_pages`` pages went
        back to the free list (or nothing is evictable). Evicting a leaf
        may expose its parent as the next candidate."""
        freed = 0
        while freed < n_pages:
            cands = self._evictable()
            if not cands:
                break
            victim = min(cands, key=lambda n: n.last_used)
            self._remove(victim)
            freed += self.pool.uncache([victim.page])
        return freed

    def _remove(self, node: _Node) -> None:
        container = (node.parent.children if node.parent is not None
                     else self._roots[node.namespace])
        del container[node.key]
        self._nodes.remove(node)

    def remap(self, old_to_new: Dict[int, int]) -> None:
        """Rewrite physical page ids after a ``PagePool.defrag``."""
        for node in self._nodes:
            node.page = old_to_new.get(node.page, node.page)
