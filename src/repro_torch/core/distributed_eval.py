"""Distributed evaluation (paper §2, C4; ``repro.core.distributed_eval``):
the eval set is zero-padded to a multiple of the eval batch, and the
padded examples are masked out of the metric."""
from __future__ import annotations

from typing import Dict, Tuple

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
