"""The port's train path: step builders, hooks, metric sinks and the
``Trainer`` (``repro.train``)."""
from repro_torch.train.trainer import Trainer, TrainerConfig

__all__ = ["Trainer", "TrainerConfig"]
