"""Checkpointed two-level scan for long recurrences
(``repro.models.scan_utils``).

``lax.scan`` becomes a Python loop over time. With more than one chunk,
each chunk runs under ``torch.utils.checkpoint`` (non-reentrant), as the
reference's ``jax.checkpoint`` over chunks: the backward recomputes a
chunk's steps from its carry, so saved memory drops from O(S) steps to
O(S / chunk + chunk).
"""
from __future__ import annotations

from typing import Callable

import torch
from torch.utils.checkpoint import checkpoint as _checkpoint


def _largest_divisor_leq(n: int, k: int) -> int:
    k = min(n, k)
    while n % k:
        k -= 1
    return k


def _scan(f: Callable, carry, xs: torch.Tensor):
    ys = []
    for t in range(xs.shape[0]):
        carry, y = f(carry, xs[t])
        ys.append(y)
    return carry, torch.stack(ys)


def chunked_scan(f: Callable, init, xs: torch.Tensor, *, chunk: int = 256):
    """Equivalent to ``jax.lax.scan(f, init, xs)`` with chunked remat:
    ``f(carry, x_t) -> (carry, y_t)`` over the leading time dim S of the
    tensor ``xs``; returns (final carry, the y_t stacked on a new leading
    dim). chunk is clamped to the largest divisor of S."""
    S = xs.shape[0]
    c = _largest_divisor_leq(S, chunk)
    n_chunks = S // c
    if n_chunks <= 1:
        return _scan(f, init, xs)
    carry, ys = init, []
    for k in range(n_chunks):
        carry, yc = _checkpoint(_scan, f, carry, xs[k * c:(k + 1) * c],
                                use_reentrant=False)
        ys.append(yc)
    return carry, torch.cat(ys)
