"""Optimizers of the port's train paths (``repro.optim``): Adam under a
cosine warmup and the bf16 compute-cast policy (the LM); LARS under a
polynomial warmup, and SGD with momentum (ResNet)."""
from repro_torch.optim.adam import adam
from repro_torch.optim.base import Optimizer
from repro_torch.optim.lars import lars
from repro_torch.optim.precision import compute_cast
from repro_torch.optim.schedules import (
    constant,
    cosine_warmup,
    polynomial_warmup,
)
from repro_torch.optim.sgd import sgd_momentum

__all__ = ["Optimizer", "adam", "compute_cast", "constant", "cosine_warmup",
           "lars", "polynomial_warmup", "sgd_momentum"]
