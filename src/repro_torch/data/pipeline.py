"""Synthetic LM data (``repro.data.pipeline``), in numpy with the
reference's generator calls, so a seed gives byte-identical batches on
both sides: zipfian tokens with a learnable bigram structure, enough
for the loss to fall. Text-only: the port's architectures have no media
frontend yet."""
from __future__ import annotations

from typing import Dict, Iterator, Optional

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
