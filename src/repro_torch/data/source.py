"""Shard-addressed batch sources (``repro.data.source``): the producer
end of the streaming input pipeline.

A :class:`Source` hands out data in *shards*: each shard is a
deterministic list of batch dicts addressable by index, so any shard can
be generated (or read back from the cache, :mod:`repro_torch.data.cache`)
without producing its predecessors, and the training stream is the
shards concatenated in order.

:class:`SyntheticShardSource` carves the synthetic LM stream into shards:
shard ``i`` is drawn from its own ``np.random.default_rng([seed, i])``,
so a resumed run seeks to any global batch in O(1) shards, and its
shards are byte-identical to the reference's for the same text-only
config.
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Protocol

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import make_lm_batch, seek_batches


class Source(Protocol):
    """Shard-addressed batch producer (what ``Pipeline`` and
    ``ShardCache`` consume): ``n_shards`` shards, ``shard(i)`` a
    deterministic list of batch dicts (str -> np.ndarray), and
    ``fingerprint()`` naming the exact stream for the cache's reuse
    check."""

    n_shards: int

    def shard(self, i: int) -> List[Dict[str, np.ndarray]]:
        ...

    def fingerprint(self) -> Dict:
        ...


class SyntheticShardSource:
    """``n_batches`` synthetic zipfian-LM batches of ``(batch, seq)``, in
    shards of ``shard_size`` (the last one may be short), each from its
    own ``(seed, shard index)`` RNG."""

    def __init__(self, cfg: ModelConfig, *, batch: int, seq: int,
                 n_batches: int, shard_size: int = 8, seed: int = 0):
        if shard_size < 1:
            raise ValueError(f"shard_size must be >= 1, got {shard_size}")
        if n_batches < 0:
            raise ValueError(f"n_batches must be >= 0, got {n_batches}")
        self.cfg = cfg
        self.batch = batch
        self.seq = seq
        self.n_batches = n_batches
        self.shard_size = shard_size
        self.seed = seed
        self.n_shards = -(-n_batches // shard_size) if n_batches else 0

    def shard(self, i: int) -> List[Dict[str, np.ndarray]]:
        if not 0 <= i < self.n_shards:
            raise IndexError(f"shard {i} out of range [0, {self.n_shards})")
        rng = np.random.default_rng([self.seed, i])
        n = min(self.shard_size, self.n_batches - i * self.shard_size)
        return [make_lm_batch(self.cfg, rng, batch=self.batch, seq=self.seq)
                for _ in range(n)]

    def fingerprint(self) -> Dict:
        """The stream's identity, as the reference writes it (the port's
        archs are text-only: ``frontend`` is ``"none"``), so a cache
        built for another geometry or seed is never trained on."""
        return {
            "kind": "synthetic_lm",
            "arch": self.cfg.name,
            "vocab": self.cfg.vocab,
            "frontend": "none",
            "batch": self.batch,
            "seq": self.seq,
            "n_batches": self.n_batches,
            "shard_size": self.shard_size,
            "seed": self.seed,
        }

    def batches(self, start: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        """The flattened stream from global batch ``start`` on, without
        generating the shards before it."""
        return seek_batches(self, self.shard_size, start)
