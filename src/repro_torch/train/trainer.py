"""Training loop (``repro.train.trainer``) on one device.

``fit`` runs the train step and appends one record per step to the
returned history; logging and the paper's nested train-and-eval loop
(C4) are hooks (:mod:`repro_torch.train.hooks`). The reference runs the
same loop under a device mesh; here there is one device and no mesh.
Checkpoints, resume and the double-buffered input stage are a later
slice of the port and are refused.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Iterable, List, Optional, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.train import steps as T
from repro_torch.train.hooks import EvalHook, Hook, MetricsLogger
from repro_torch.utils import tree_map

_LATER = "the checkpoint slice of the port (see ROADMAP.md)"


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100       # global step budget
    eval_every: int = 0          # 0 = no eval
    checkpoint_every: int = 0    # 0 = no checkpoints (others: not ported)
    log_every: int = 10
    seed: int = 0
    metrics: Tuple[str, ...] = ()  # extra step metrics (e.g. "grad_norm")
    async_checkpoint: bool = False  # not ported
    double_buffer: bool = False    # not ported
    metrics_out: str = ""          # JSONL path for the full metric stream


def _to_device(tree, device):
    """A batch of numpy arrays (or tensors) as tensors on ``device``."""
    return tree_map(lambda a: torch.as_tensor(a).to(device), tree)


class Trainer:
    """``Trainer(cfg, tcfg, optimizer, device=, params=)``: fp32 master
    weights and optimizer state on ``device`` (default ``"cuda"``,
    which raises where CUDA is absent). ``params`` starts from a given
    tree (e.g. ``lm.params_from_numpy(..., dtype=torch.float32)``),
    otherwise ``lm.init_lm`` draws it from ``tcfg.seed``."""

    def __init__(self, cfg: ModelConfig, tcfg: Optional[TrainerConfig] = None,
                 optimizer=None, *, device="cuda", params=None):
        self.cfg = cfg
        self.tcfg = tcfg or TrainerConfig()
        if self.tcfg.checkpoint_every:
            raise NotImplementedError(f"checkpoint_every: {_LATER}")
        if self.tcfg.async_checkpoint:
            raise NotImplementedError(f"async_checkpoint: {_LATER}")
        if self.tcfg.double_buffer:
            raise NotImplementedError(
                "double_buffer: the streaming data slice of the port "
                "(see ROADMAP.md)")
        self.device = resolve_device(device)
        self.optimizer = optimizer or T.make_optimizer(
            cfg, self.tcfg.total_steps)
        self.state = T.init_train_state(cfg, self.optimizer,
                                        seed=self.tcfg.seed,
                                        device=self.device, params=params)
        self._train_step = T.make_train_step(
            cfg, self.optimizer, extra_metrics=self.tcfg.metrics)
        self._eval_step = T.make_eval_step(cfg)
        self.start_step = 0
        self.last_step_s = 0.0       # wall time of the latest train step
        self.batch_shape: Optional[Tuple[int, int]] = None  # (batch, seq)
        self._hooks: List[Hook] = []

    def default_hooks(self, eval_batches: Optional[Callable] = None
                      ) -> List[Hook]:
        """The stock hooks ``TrainerConfig`` implies: the metrics logger
        (with a JSONL sink when ``metrics_out`` is set) and, with
        ``eval_every``, the eval hook."""
        sinks = []
        if self.tcfg.metrics_out:
            from repro_torch.train.tracker import JsonlSink

            sinks.append(JsonlSink(self.tcfg.metrics_out))
        hooks: List[Hook] = [MetricsLogger(self.tcfg.log_every, sinks=sinks)]
        if self.tcfg.eval_every and eval_batches is not None:
            hooks.append(EvalHook(eval_batches, self.tcfg.eval_every))
        return hooks

    def emit(self, event: str, *args) -> None:
        """Fan an event out to every hook of the current fit."""
        for h in self._hooks:
            getattr(h, event)(self, *args)

    def resume(self, ckpt_dir: str) -> int:
        raise NotImplementedError(f"resume: {_LATER}")

    def evaluate(self, eval_batches: Callable) -> dict:
        """Distributed eval (C4) over ``eval_batches()`` -> ``(batch,
        mask)`` pairs; returns ``{"eval_nll": ...}``."""
        nll, cnt = 0.0, 0.0
        for ebatch, mask in eval_batches():
            s, c = self._eval_step(self.state["params"],
                                   _to_device(ebatch, self.device),
                                   _to_device(mask, self.device))
            nll += float(s)
            cnt += float(c)
        return {"eval_nll": nll / max(cnt, 1.0)}

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def fit(self, train_batches: Iterable,
            eval_batches: Optional[Callable] = None,
            hooks: Optional[List[Hook]] = None) -> List[dict]:
        """Run up to ``total_steps`` steps; returns the per-step history
        (``step``, ``loss``, ``nll``, ``step_ms``, ``data_wait_ms``,
        ``ckpt_block_ms`` and whatever hooks add). ``step_ms`` is the
        host's time in the step call; it is the card's step time only
        when a hook sets ``needs_sync``."""
        self._hooks = (self.default_hooks(eval_batches)
                       if hooks is None else list(hooks))
        needs_sync = any(getattr(h, "needs_sync", False)
                         for h in self._hooks)
        history: List[dict] = []
        step = self.start_step
        it = iter(train_batches)
        while step < self.tcfg.total_steps:
            t_wait = time.perf_counter()
            try:
                batch = next(it)
            except StopIteration:
                break
            batch = _to_device(batch, self.device)
            data_wait_ms = (time.perf_counter() - t_wait) * 1e3
            toks = batch["tokens"]
            self.batch_shape = (int(toks.shape[0]), int(toks.shape[1]))
            t0 = time.perf_counter()
            self.state, metrics = self._train_step(self.state, batch)
            if needs_sync:
                self._sync()
            self.last_step_s = time.perf_counter() - t0
            step += 1
            record = {"step": step, **metrics,
                      "step_ms": self.last_step_s * 1e3,
                      "data_wait_ms": data_wait_ms,
                      "ckpt_block_ms": 0.0}
            history.append(record)
            self.emit("on_step", step, record)
        for record in history:  # 0-d tensors -> floats
            for k, v in record.items():
                if torch.is_tensor(v):
                    record[k] = float(v)
        self.emit("on_finish", history)
        return history
