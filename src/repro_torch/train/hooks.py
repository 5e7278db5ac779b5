"""Trainer hooks (``repro.train.hooks``): the extension surface of
``Trainer.fit``. ``fit`` runs the train step; metric tracking and the
paper's nested eval loop (C4) are hooks. Checkpointing and benchmark
records are a later slice of the port.

Call protocol, per fitted step (in hook-list order):

    on_step(trainer, step, record)        # record: mutable per-step dict
    on_eval(trainer, step, record)        # via Trainer.emit after EvalHook
    on_finish(trainer, history)           # once, after the loop

``record`` is the dict appended to ``fit``'s history, so a hook that
adds keys (``EvalHook`` adds ``eval_nll``) enriches the entry callers
see. A hook that needs true per-step wall times sets ``needs_sync``:
``fit`` then waits for the card after every step.
"""
from __future__ import annotations

import time
from typing import Callable, List, Optional, Sequence

from repro_torch.train.tracker import ConsoleSink, Sink


class Hook:
    """No-op base: override any subset of the events."""

    needs_sync = False

    def on_step(self, trainer, step: int, record: dict) -> None:
        pass

    def on_eval(self, trainer, step: int, record: dict) -> None:
        pass

    def on_finish(self, trainer, history: List[dict]) -> None:
        pass


class MetricsLogger(Hook):
    """Multi-sink metrics tracker: the console logger (its lines to
    ``sink`` when given, else stdout) plus any extra ``sinks``, all fed
    the same per-step records."""

    def __init__(self, log_every: int = 10,
                 sink: Optional[Callable[[str], None]] = None,
                 sinks: Sequence[Sink] = ()):
        self.log_every = log_every
        self.sinks: List[Sink] = [ConsoleSink(log_every, sink), *sinks]

    def on_step(self, trainer, step, record):
        t0 = time.time() - trainer.last_step_s
        for s in self.sinks:
            s.start_clock(t0)
            s.log(step, record)

    def on_eval(self, trainer, step, record):
        for s in self.sinks:
            s.log_eval(step, record)

    def on_finish(self, trainer, history):
        for s in self.sinks:
            s.finish(history)


class EvalHook(Hook):
    """The nested train-and-eval loop (C4): every ``every`` steps, run
    the padded eval set and merge ``eval_nll`` into the step record,
    then fan the enriched record out via ``on_eval``."""

    def __init__(self, eval_batches: Callable, every: int):
        self.eval_batches = eval_batches
        self.every = every

    def on_step(self, trainer, step, record):
        if self.every and step % self.every == 0:
            record.update(trainer.evaluate(self.eval_batches))
            trainer.emit("on_eval", step, record)
