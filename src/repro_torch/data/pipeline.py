"""Synthetic LM data and input plumbing (``repro.data.pipeline``).

The LM batches are numpy with the reference's generator calls, so a seed
gives byte-identical batches on both sides: zipfian tokens with a
learnable bigram structure, enough for the loss to fall, and for an
``audio_frames`` frontend (whisper) standard-normal encoder frames, for
a ``vision_patches`` frontend (qwen2-vl) standard-normal patch
embeddings, drawn after the tokens from the same generator. Beside
them, GNMT's round-robin multi-host distribution, the background prefetch and the
streaming :class:`Pipeline` (source -> shard cache -> prefetch; paper
sections 2 and 3).
"""
from __future__ import annotations

from typing import Dict, Iterable, Iterator, List, Optional

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.core.distributed_eval import pad_eval_dataset
from repro_torch.data.cache import ShardCache
from repro_torch.data.prefetch import Prefetcher


def _zipf_tokens(rng: np.random.Generator, shape, vocab: int) -> np.ndarray:
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    probs = 1.0 / ranks
    probs /= probs.sum()
    flat = rng.choice(vocab, size=int(np.prod(shape)), p=probs)
    toks = flat.reshape(shape).astype(np.int32)
    # even tokens are followed by token + 1 half the time
    nxt = np.roll(toks, -1, axis=-1)
    mask = (toks % 2 == 0) & (rng.random(toks.shape) < 0.5)
    nxt = np.where(mask, (toks + 1) % vocab, nxt)
    toks[..., 1:] = nxt[..., :-1]
    return toks


def make_lm_batch(cfg: ModelConfig, rng: np.random.Generator, *,
                  batch: int, seq: int) -> Dict:
    """One synthetic batch: {"tokens": (batch, seq) int32}, plus
    "media" (batch, enc_source_len, d_model) fp32 frames for an
    ``audio_frames`` frontend. A ``vision_patches`` frontend's batch
    holds ``seq`` positions in all: n = min(n_media_tokens, seq // 2)
    media (batch, n, d_model) and tokens (batch, seq - n)."""
    n_media = _n_media(cfg, seq)
    out = {"tokens": _zipf_tokens(rng, (batch, seq - n_media), cfg.vocab)}
    if cfg.frontend in ("audio_frames", "vision_patches"):
        out["media"] = _media(rng, batch, cfg, seq)
    return out


def _n_media(cfg: ModelConfig, seq: int) -> int:
    """Media positions a vision batch of ``seq`` positions gives over."""
    if cfg.frontend != "vision_patches":
        return 0
    return min(cfg.n_media_tokens, seq // 2)


def _media(rng: np.random.Generator, n: int, cfg: ModelConfig, seq: int):
    """Standard-normal fp32 media for n examples: (n, enc_source_len,
    d_model) frames, or (n, n_media, d_model) patch embeddings."""
    m = cfg.enc_source_len if cfg.frontend == "audio_frames" else \
        _n_media(cfg, seq)
    return rng.standard_normal((n, m, cfg.d_model)).astype(np.float32)


def synthetic_lm_batches(cfg: ModelConfig, *, batch: int, seq: int,
                         steps: int, seed: int = 0) -> Iterator[Dict]:
    rng = np.random.default_rng(seed)
    for _ in range(steps):
        yield make_lm_batch(cfg, rng, batch=batch, seq=seq)


def synthetic_eval_set(cfg: ModelConfig, *, batch: int, seq: int,
                       n_examples: Optional[int] = None, seed: int = 1):
    """Padded eval set (C4): returns a callable yielding (batch, mask)."""
    n = n_examples or (batch * 2 + 3)  # deliberately not a batch multiple
    rng = np.random.default_rng(seed)
    # the tokens are drawn at full length and cut, as the reference does
    fields = {"tokens": _zipf_tokens(rng, (n, seq), cfg.vocab)
              [:, :seq - _n_media(cfg, seq)]}
    if cfg.frontend in ("audio_frames", "vision_patches"):
        fields["media"] = _media(rng, n, cfg, seq)
    padded, mask = pad_eval_dataset(fields, batch)
    n_batches = padded["tokens"].shape[0] // batch

    def gen():
        for i in range(n_batches):
            sl = slice(i * batch, (i + 1) * batch)
            yield {k: v[sl] for k, v in padded.items()}, mask[sl]

    return gen


class RoundRobinHostPipeline:
    """Distributes a (bucketized) example stream across ``n_hosts``
    input pipelines round-robin, preserving the global order per batch:
    the paper's fix for the single-host input bottleneck at 1024
    workers. ``host_stream(h)`` yields the examples host h serves."""

    def __init__(self, examples: List, n_hosts: int):
        self.examples = examples
        self.n_hosts = n_hosts

    def host_stream(self, host: int) -> Iterator:
        for i in range(host, len(self.examples), self.n_hosts):
            yield self.examples[i]

    def interleaved(self) -> Iterator:
        """What the accelerators see: the hosts drained round-robin,
        which is the original order."""
        streams = [self.host_stream(h) for h in range(self.n_hosts)]
        done = [False] * self.n_hosts
        while not all(done):
            for h, s in enumerate(streams):
                if done[h]:
                    continue
                try:
                    yield next(s)
                except StopIteration:
                    done[h] = True


def seek_batches(store, shard_size: int, start: int = 0) -> Iterator[Dict]:
    """The flattened batch stream of a shard store (``n_shards`` and
    ``shard(i)``: a source or its cache) from global batch ``start`` on,
    reading only the shards from the one that holds it."""
    first, skip = divmod(start, shard_size)
    for i in range(first, store.n_shards):
        yield from store.shard(i)[skip:]
        skip = 0


class Pipeline:
    """The streaming training input, as one iterator: a shard-addressed
    :class:`~repro_torch.data.source.Source`, through an optional
    checksum-verified :class:`~repro_torch.data.cache.ShardCache` at
    ``cache_dir``, into a bounded background
    :class:`~repro_torch.data.prefetch.Prefetcher`, yielding host batch
    dicts.

    ``start_batch`` seeks a resumed run to its stream position, reading
    only the shards from the one that holds it. Each ``__iter__``
    restarts from ``start_batch`` on a fresh worker thread; ``wait_ms``
    is the current iteration's consumer stall; ``close()`` (or leaving a
    ``with`` block) stops the worker.
    """

    def __init__(self, source, *, cache_dir: Optional[str] = None,
                 prefetch_depth: int = 2, start_batch: int = 0,
                 verify_cache: bool = True):
        if start_batch < 0:
            raise ValueError(f"start_batch must be >= 0, got {start_batch}")
        self.source = source
        self.prefetch_depth = prefetch_depth
        self.start_batch = start_batch
        self._prefetcher = None
        self._store = source
        if cache_dir:
            self._store = ShardCache(cache_dir).ensure(source,
                                                       verify=verify_cache)

    def __iter__(self) -> Iterator[Dict]:
        self.close()
        self._prefetcher = Prefetcher(
            seek_batches(self._store, self.source.shard_size,
                         self.start_batch),
            depth=self.prefetch_depth)
        return self._prefetcher

    @property
    def wait_ms(self) -> float:
        return self._prefetcher.wait_ms if self._prefetcher else 0.0

    def close(self) -> None:
        if self._prefetcher is not None:
            self._prefetcher.close()
            self._prefetcher = None

    def __enter__(self) -> "Pipeline":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def prefetch(it: Iterable, size: int = 2) -> Iterator:
    """Background-thread prefetch of ``size`` items of ``it``, in order,
    through a :class:`~repro_torch.data.prefetch.Prefetcher`.

    Unlike the reference, an exception raised by ``it`` is re-raised to
    the consumer, and closing the returned generator (or leaving a
    ``for`` loop over it and dropping it) stops and joins the thread.
    """
    with Prefetcher(it, depth=size) as p:
        yield from p
