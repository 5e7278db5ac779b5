"""Trainer hooks (``repro.train.hooks``): the extension surface of
``Trainer.fit``. ``fit`` runs the train step; metric tracking, the
paper's nested eval loop (C4) and checkpointing are hooks. Benchmark
records are a later slice of the port.

Call protocol, per fitted step (in hook-list order):

    on_step(trainer, step, record)        # record: mutable per-step dict
    on_eval(trainer, step, record)        # via Trainer.emit after EvalHook
    on_checkpoint(trainer, step, path)    # via Trainer.emit
    on_finish(trainer, history)           # once, after the loop

``record`` is the dict appended to ``fit``'s history, so a hook that
adds keys (``EvalHook`` adds ``eval_nll``, ``CheckpointHook`` overwrites
``ckpt_block_ms``) enriches the entry callers see. A hook that needs
true per-step wall times sets ``needs_sync``: ``fit`` then waits for the
card after every step.
"""
from __future__ import annotations

import os
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

    def on_checkpoint(self, trainer, step: int, path: str) -> None:
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


class CheckpointHook(Hook):
    """Periodic checkpoints under ``directory/step_<N>``, in the
    reference's format (``trainer.checkpoint_tree()``).

    ``async_save=True`` takes the non-blocking path
    (:class:`~repro_torch.train.checkpoint.AsyncCheckpointer`): the step
    loop only queues the device-side snapshot and drains the previous
    save. Either way the hook stamps the host's blocked time into
    ``record["ckpt_block_ms"]``; skips a save when the step has not moved
    past the last one (as right after a resume); and at the end of the
    fit saves the final step if it is not saved yet, then drains the
    in-flight save.
    """

    def __init__(self, every: int, directory: str, *,
                 async_save: bool = False):
        self.every = every
        self.directory = directory
        self.async_save = async_save
        self.checkpointer = None  # AsyncCheckpointer, made at first save
        self._last_saved: Optional[int] = None

    def _save(self, trainer, step: int) -> str:
        from repro_torch.train import checkpoint as ckpt

        path = os.path.join(self.directory, f"step_{step}")
        tree = trainer.checkpoint_tree()
        if self.async_save:
            if self.checkpointer is None:
                self.checkpointer = ckpt.AsyncCheckpointer()
            self.checkpointer.save(path, tree, step=step)
        else:
            ckpt.save_checkpoint(path, tree, step=step)
        self._last_saved = step
        return path

    def on_step(self, trainer, step, record):
        if self._last_saved is None:
            self._last_saved = trainer.start_step  # resumed state is on disk
        if self.every and step % self.every == 0 \
                and step != self._last_saved:
            t0 = time.perf_counter()
            path = self._save(trainer, step)
            record["ckpt_block_ms"] = (time.perf_counter() - t0) * 1e3
            trainer.emit("on_checkpoint", step, path)

    def on_finish(self, trainer, history):
        if self._last_saved is None:
            self._last_saved = trainer.start_step
        final = history[-1]["step"] if history else trainer.start_step
        if self.every and final != self._last_saved:
            path = self._save(trainer, final)  # a fast exit keeps its steps
            trainer.emit("on_checkpoint", final, path)
        if self.checkpointer is not None:
            self.checkpointer.wait()  # never drop the in-flight save
