"""Distributed evaluation (paper §2, C4; ``repro.core.distributed_eval``):
the eval set is zero-padded to a multiple of the eval batch, and the
padded examples are masked out of the metric. The metric tensors stay on
the device; only the final sums leave it. ``train_and_eval_loop`` is the
host loop that nests the eval sweep in training."""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np


def pad_eval_dataset(examples: Dict[str, np.ndarray], global_batch: int
                     ) -> Tuple[Dict[str, np.ndarray], np.ndarray]:
    """Zero-pad every field to a multiple of global_batch.

    Returns (padded dict, real-example mask (n_padded,)).
    """
    n = next(iter(examples.values())).shape[0]
    n_pad = (-n) % global_batch
    padded = {
        k: np.concatenate([v, np.zeros((n_pad,) + v.shape[1:], v.dtype)])
        for k, v in examples.items()
    }
    mask = np.concatenate([np.ones(n, np.float32), np.zeros(n_pad, np.float32)])
    return padded, mask


def masked_top1(logits, labels, mask):
    """Top-1 accuracy counting only real examples. Returns (correct,
    count), fp32 tensors on the logits' device, so that batches can be
    accumulated exactly."""
    pred = logits.argmax(-1)
    correct = ((pred == labels) * mask).sum()
    return correct, mask.sum()


def masked_mean_loss(per_example_loss, mask):
    """(sum of the real examples' losses, their count)."""
    return (per_example_loss * mask).sum(), mask.sum()


def train_and_eval_loop(
    *,
    train_step: Callable,
    eval_step: Callable,
    train_state,
    train_batches,
    eval_batches,
    eval_every: int,
    metric_fn=None,
):
    """The paper's nested train-and-eval tight loop (host-side driver;
    ``distributed_eval.py:48``).

    train_step: (state, batch) -> (state, metrics)
    eval_step: (state, batch, mask) -> (correct, count), summed here.
    eval_batches yields (batch, mask) from a padded eval set.
    Returns (final_state, history list of dicts), one record every
    ``eval_every`` steps.
    """
    history = []
    for step, batch in enumerate(train_batches):
        train_state, train_metrics = train_step(train_state, batch)
        if (step + 1) % eval_every == 0:
            correct = 0.0
            count = 0.0
            for ebatch, mask in eval_batches():
                c, n = eval_step(train_state, ebatch, mask)
                correct += float(c)
                count += float(n)
            rec = {
                "step": step + 1,
                "eval_metric": correct / max(count, 1.0),
                **{k: float(v) for k, v in train_metrics.items()},
            }
            history.append(rec)
    return train_state, history
