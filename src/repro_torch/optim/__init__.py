"""Optimizers of the port's train path (``repro.optim``): Adam under a
cosine-warmup schedule, and the bf16 compute-cast policy."""
from repro_torch.optim.adam import adam
from repro_torch.optim.base import Optimizer
from repro_torch.optim.precision import compute_cast
from repro_torch.optim.schedules import constant, cosine_warmup

__all__ = ["Optimizer", "adam", "compute_cast", "constant", "cosine_warmup"]
