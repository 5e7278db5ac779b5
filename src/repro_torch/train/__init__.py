"""The port's train path: step builders, hooks, metric sinks,
checkpoints and the ``Trainer`` (``repro.train``)."""
from repro_torch.train import checkpoint
from repro_torch.train.hooks import CheckpointHook, EvalHook, Hook, MetricsLogger
from repro_torch.train.trainer import Trainer, TrainerConfig

__all__ = ["CheckpointHook", "EvalHook", "Hook", "MetricsLogger", "Trainer",
           "TrainerConfig", "checkpoint"]
