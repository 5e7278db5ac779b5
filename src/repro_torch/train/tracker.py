"""Metric sinks (``repro.train.tracker``): the pluggable back half of
``MetricsLogger``. The logger decides when to emit; a sink decides
where: the console, a JSONL file, or an in-memory dict collector.

Record values may still be 0-d device tensors while the fit runs
(reading one waits for the card). ``ConsoleSink`` reads at its log
cadence; ``JsonlSink`` buffers records and serializes them trailing by
one, so keys a later hook adds to the same record land in the line;
``DictSink`` materializes at finish.
"""
from __future__ import annotations

import json
import time
from typing import Any, Callable, List, Optional


def _jsonable(v: Any):
    """One record value for serialization (0-d tensors and numpy
    scalars -> Python numbers, everything else as it is or as str)."""
    if isinstance(v, (str, bool, int, float)) or v is None:
        return v
    if hasattr(v, "item"):
        try:
            return v.item()
        except (TypeError, ValueError, RuntimeError):
            pass
    return str(v)


class Sink:
    """No-op base: override any subset."""

    def start_clock(self, t0: float) -> None:
        pass

    def log(self, step: int, record: dict) -> None:
        pass

    def log_eval(self, step: int, record: dict) -> None:
        pass

    def finish(self, history: List[dict]) -> None:
        pass


class ConsoleSink(Sink):
    """The console lines ``step N: loss=... nll=... (Ts)`` every
    ``log_every`` steps (0 silences them) and ``  eval @ N: nll=...``
    after every eval."""

    def __init__(self, log_every: int = 10,
                 out: Optional[Callable[[str], None]] = None):
        self.log_every = log_every
        self.out = out or (lambda line: print(line, flush=True))
        self._t0: Optional[float] = None

    def start_clock(self, t0: float) -> None:
        if self._t0 is None:
            self._t0 = t0

    def log(self, step, record):
        if self.log_every and step % self.log_every == 0:
            dt = time.time() - (self._t0 if self._t0 is not None
                                else time.time())
            self.out(f"step {step}: loss={float(record['loss']):.4f} "
                     f"nll={float(record['nll']):.4f} ({dt:.1f}s)")

    def log_eval(self, step, record):
        self.out(f"  eval @ {step}: nll={record['eval_nll']:.4f}")


class JsonlSink(Sink):
    """Streams every fit record to a JSONL file, one object per line,
    ``flush_every`` records behind the head and the tail at finish
    (``flush_every=0`` defers all writing to finish)."""

    def __init__(self, path: str, *, flush_every: int = 25):
        self.path = path
        self.flush_every = flush_every
        self._pending: List[dict] = []
        self._fh = None

    def _flush(self, keep_tail: int) -> None:
        if self._fh is None:
            self._fh = open(self.path, "w")
        while len(self._pending) > keep_tail:
            record = self._pending.pop(0)
            self._fh.write(json.dumps(
                {k: _jsonable(v) for k, v in record.items()}) + "\n")
        self._fh.flush()

    def log(self, step, record):
        self._pending.append(record)
        if self.flush_every and len(self._pending) > self.flush_every:
            self._flush(keep_tail=1)  # trail the head by one record

    def finish(self, history):
        self._flush(keep_tail=0)
        if self._fh is not None:
            self._fh.close()
            self._fh = None


class DictSink(Sink):
    """In-memory collector (the shape of a ``wandb.log`` integration):
    every record lands as one dict in ``logged``, materialized at
    finish."""

    def __init__(self):
        self.logged: List[dict] = []
        self.finished = False

    def log(self, step, record):
        self.logged.append(record)

    def finish(self, history):
        self.logged = [{k: _jsonable(v) for k, v in r.items()}
                       for r in self.logged]
        self.finished = True
