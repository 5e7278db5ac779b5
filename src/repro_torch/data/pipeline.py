"""Synthetic LM data and input plumbing (``repro.data.pipeline``).

The LM batches are numpy with the reference's generator calls, so a seed
gives byte-identical batches on both sides: zipfian tokens with a
learnable bigram structure, enough for the loss to fall. Text-only: the
port's architectures have no media frontend yet. Beside them, GNMT's
round-robin multi-host distribution and the background prefetch
(paper sections 2 and 3).
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Iterable, Iterator, List, Optional

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.core.distributed_eval import pad_eval_dataset


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
    """One synthetic batch: {"tokens": (batch, seq) int32}."""
    return {"tokens": _zipf_tokens(rng, (batch, seq), cfg.vocab)}


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
    fields = {"tokens": _zipf_tokens(rng, (n, seq), cfg.vocab)}
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


class _End:
    """The end of a prefetched stream, with the exception that ended it
    (or None)."""

    def __init__(self, exc: Optional[BaseException]):
        self.exc = exc


def prefetch(it: Iterable, size: int = 2) -> Iterator:
    """Background-thread prefetch of ``size`` items of ``it``, in order.

    Unlike the reference, an exception raised by ``it`` is re-raised to
    the consumer, and closing the returned generator (or leaving a
    ``for`` loop over it and dropping it) stops and joins the thread.
    """
    q: "queue.Queue" = queue.Queue(maxsize=size)
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in it:
                if not put(item):
                    return
        except BaseException as exc:  # handed to the consumer, re-raised
            put(_End(exc))
            return
        put(_End(None))

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if isinstance(item, _End):
                if item.exc is not None:
                    raise item.exc
                return
            yield item
    finally:
        stop.set()
        t.join()
