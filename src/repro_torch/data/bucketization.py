"""Window-based length bucketization (``repro.data.bucketization``, paper
section 3, GNMT), copied: pure numpy, so the same examples give the same
batches bit for bit.

Synchronous training waits for the longest sequence in each global
batch, so mixing lengths wastes step time. The paper's scheme sorts
examples into sliding length windows so that every batch holds
similar-length sequences; at 1024 workers, ``data.pipeline.
RoundRobinHostPipeline`` distributes the stream across input hosts.
Every example appears exactly once, and a batch's length spread is at
most the window.
"""
from __future__ import annotations

from typing import Iterator, List, Sequence, Tuple

import numpy as np


def window_bucketize(lengths: Sequence[int], batch_size: int,
                     window: int) -> List[List[int]]:
    """Group example indices into batches whose length spread <= window.

    Greedy sweep over the sorted-by-length order, cutting a batch whenever
    it is full or the window would be exceeded. Returns index batches
    (the last batch per window run may be short — callers pad).
    """
    order = np.argsort(np.asarray(lengths), kind="stable")
    batches: List[List[int]] = []
    cur: List[int] = []
    cur_min = None
    for idx in order:
        n = int(lengths[idx])
        if cur and (len(cur) >= batch_size or n - cur_min > window):
            batches.append(cur)
            cur = []
            cur_min = None
        if cur_min is None:
            cur_min = n
        cur.append(int(idx))
    if cur:
        batches.append(cur)
    return batches


def pad_batch(examples: List[np.ndarray], pad_value: int = 0,
              multiple: int = 1) -> Tuple[np.ndarray, np.ndarray]:
    """Pad a list of 1-D token arrays to a common length.

    Returns (tokens (B, L), mask (B, L) float32)."""
    max_len = max(len(e) for e in examples)
    if multiple > 1:
        max_len = -(-max_len // multiple) * multiple
    B = len(examples)
    out = np.full((B, max_len), pad_value, examples[0].dtype)
    mask = np.zeros((B, max_len), np.float32)
    for i, e in enumerate(examples):
        out[i, : len(e)] = e
        mask[i, : len(e)] = 1.0
    return out, mask


def padding_waste(lengths: Sequence[int], batches: List[List[int]]) -> float:
    """Fraction of padded (wasted) tokens across all batches."""
    lengths = np.asarray(lengths)
    total_real = int(lengths.sum())
    total_padded = 0
    for b in batches:
        ls = lengths[np.asarray(b, int)]
        total_padded += int(ls.max()) * len(b)
    return 1.0 - total_real / max(total_padded, 1)


def bucketized_batches(examples: List[np.ndarray], batch_size: int,
                       window: int, *, pad_value: int = 0,
                       seed: int = 0) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Shuffled stream of (tokens, mask) batches under window bucketization."""
    rng = np.random.default_rng(seed)
    lengths = [len(e) for e in examples]
    batches = window_bucketize(lengths, batch_size, window)
    for bi in rng.permutation(len(batches)):
        idxs = batches[bi]
        yield pad_batch([examples[i] for i in idxs], pad_value)
