"""Training loop (``repro.train.trainer``), on one device or on a mesh.

``fit`` runs the train step and appends one record per step to the
returned history; logging, the paper's nested train-and-eval loop (C4)
and checkpointing are hooks (:mod:`repro_torch.train.hooks`). ``resume``
restores a checkpoint (in the reference's format, so either package's
checkpoints resume in the other) and ``fit`` then continues at its step.
With ``double_buffer`` the next batch's host-to-device copy runs on a
side stream while the current step computes. With ``mesh`` (a
``launch.mesh.Mesh``) every rank runs the same loop over its blocks of
the state and its rows of each batch, in the config's
``param_sharding`` mode (:mod:`repro_torch.dist.spmd`), as the
reference's trainer runs under its mesh.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, Iterable, List, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.dist import spmd
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import steps as T
from repro_torch.train.hooks import (
    CheckpointHook,
    EvalHook,
    Hook,
    MetricsLogger,
)
from repro_torch.utils import tree_leaves, tree_map


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100       # global step budget (resume counts toward it)
    eval_every: int = 0          # 0 = no eval
    checkpoint_every: int = 0    # 0 = no checkpoints
    checkpoint_dir: str = "/tmp/repro_ckpt"
    log_every: int = 10
    seed: int = 0
    metrics: Tuple[str, ...] = ()  # extra step metrics (e.g. "grad_norm")
    async_checkpoint: bool = False  # background checkpoint writer
    double_buffer: bool = False    # stage the next batch's H2D ahead of the step
    metrics_out: str = ""          # JSONL path for the full metric stream


def _to_device(tree, device):
    """A batch of numpy arrays (or tensors) as tensors on ``device``."""
    return tree_map(lambda a: torch.as_tensor(a).to(device), tree)


class Trainer:
    """``Trainer(cfg, tcfg, optimizer, device=, params=, mesh=)``: fp32
    master weights and optimizer state on ``device`` (default
    ``"cuda"``, which raises where CUDA is absent). ``params`` starts
    from a given tree (e.g. ``lm.params_from_numpy(...,
    dtype=torch.float32)``), otherwise the family's init (``lm.init_lm``,
    ``encdec.init_encdec``) draws it from ``tcfg.seed``. An enc-dec
    model's batches carry ``media`` beside ``tokens``.

    ``mesh=None`` trains on one device. With a mesh every rank builds
    the trainer from the same full tree (``params``, or the seed's) and
    keeps its blocks (``plan.pspecs``; the moments by ``plan.ospecs``);
    ``fit`` takes the global batch stream and keeps the rank's rows, and
    its records hold the global loss and metrics; a batch whose rows the
    batch axes do not divide is replicated over them. Checkpoints and
    ``resume`` over more than one rank raise ``NotImplementedError``, and
    a mesh without a ``data`` axis ``ValueError``
    (``spmd.check_supported``)."""

    def __init__(self, cfg: ModelConfig, tcfg: Optional[TrainerConfig] = None,
                 optimizer=None, *, device="cuda", params=None, mesh=None):
        self.cfg = cfg
        self.tcfg = tcfg or TrainerConfig()
        self.device = resolve_device(device)
        self.optimizer = optimizer or T.make_optimizer(
            cfg, self.tcfg.total_steps)
        self.mesh, self.plan = mesh, None
        if mesh is None:
            self.state = T.init_train_state(cfg, self.optimizer,
                                            seed=self.tcfg.seed,
                                            device=self.device,
                                            params=params)
        else:
            self.state = self._sharded_state(params)
        self._train_step = T.make_train_step(
            cfg, self.optimizer, extra_metrics=self.tcfg.metrics,
            plan=self.plan)
        self._eval_step = T.make_eval_step(cfg, plan=self.plan)
        self.start_step = 0
        self.last_step_s = 0.0       # wall time of the latest train step
        self.batch_shape: Optional[Tuple[int, int]] = None  # (batch, seq)
        self._hooks: List[Hook] = []

    def _sharded_state(self, params):
        """This rank's blocks of the full tree and the optimizer's state
        over the blocks it updates."""
        api = T.ModelAPI(self.cfg)
        spmd.check_supported(self.cfg, self.mesh)
        self._one_rank_only("checkpoint_every", self.tcfg.checkpoint_every)
        if params is None:
            params = api.init(self.cfg, self.tcfg.seed, device=self.device,
                              dtype=getattr(torch, self.cfg.param_dtype))
        self.plan = spmd.plan_of(self.cfg, self.mesh, api.param_axes(),
                                 params)
        blocks = spmd.shard_tree(params, self.plan.pspecs, self.mesh)
        return {"params": blocks,
                "opt": self.optimizer.init(self.plan.views_tree(blocks))}

    def _one_rank_only(self, what: str, on: bool = True) -> None:
        if on and self.mesh is not None and dist.get_world_size() > 1:
            raise NotImplementedError(
                f"{what} on a mesh of {dist.get_world_size()} ranks: "
                f"checkpoints are written from one rank only ({spmd.ROADMAP})")

    def default_hooks(self, eval_batches: Optional[Callable] = None
                      ) -> List[Hook]:
        """The stock hooks ``TrainerConfig`` implies: the metrics logger
        (with a JSONL sink when ``metrics_out`` is set), with
        ``eval_every`` the eval hook and with ``checkpoint_every`` the
        checkpoint hook (async with ``async_checkpoint``)."""
        sinks = []
        if self.tcfg.metrics_out:
            from repro_torch.train.tracker import JsonlSink

            sinks.append(JsonlSink(self.tcfg.metrics_out))
        hooks: List[Hook] = [MetricsLogger(self.tcfg.log_every, sinks=sinks)]
        if self.tcfg.eval_every and eval_batches is not None:
            hooks.append(EvalHook(eval_batches, self.tcfg.eval_every))
        if self.tcfg.checkpoint_every:
            hooks.append(CheckpointHook(
                self.tcfg.checkpoint_every, self.tcfg.checkpoint_dir,
                async_save=self.tcfg.async_checkpoint))
        return hooks

    def emit(self, event: str, *args) -> None:
        """Fan an event out to every hook of the current fit."""
        for h in self._hooks:
            getattr(h, event)(self, *args)

    def checkpoint_tree(self):
        """The train state in the reference's names and layouts (each
        parameter-shaped tree through the family's ``reference_tree``),
        as views of the live tensors: what checkpoints write and resume
        restores."""
        api = T.ModelAPI(self.cfg)

        def ref(tree):
            if isinstance(tree, dict) and ("layers" in tree
                                           or "dec_blocks" in tree):
                return api.reference_tree(tree)
            return tree

        opt = {k: ref(v) for k, v in self.state["opt"].items()}
        return {"params": ref(self.state["params"]), "opt": opt}

    def resume(self, ckpt_dir: str) -> int:
        """Restore the state from a checkpoint and return its step.

        ``ckpt_dir`` is a run directory of ``step_<N>`` subdirectories
        (the latest wins) or one ``step_<N>`` directory. ``fit`` then
        continues at ``start_step``, and ``total_steps`` stays the
        global budget."""
        self._one_rank_only("resume")
        step = ckpt.latest_step(ckpt_dir)
        if step is not None:
            path = os.path.join(ckpt_dir, f"step_{step}")
        else:
            path = ckpt_dir
            step = ckpt.manifest_step(path)
            if step is None:
                raise ValueError(
                    f"{ckpt_dir}: no step_<N> checkpoints and no step "
                    "recorded in manifest.json")
        ckpt.restore_into(path, self.checkpoint_tree())
        self.start_step = int(step)
        return self.start_step

    def evaluate(self, eval_batches: Callable) -> dict:
        """Distributed eval (C4) over ``eval_batches()`` -> ``(batch,
        mask)`` pairs; returns ``{"eval_nll": ...}``."""
        nll, cnt = 0.0, 0.0
        for ebatch, mask in eval_batches():
            if self.plan is not None:
                ebatch = spmd.batch_rows(ebatch, self.mesh)
                mask = spmd.batch_rows({"mask": mask}, self.mesh)["mask"]
            s, c = self._eval_step(self.state["params"],
                                   _to_device(ebatch, self.device),
                                   _to_device(mask, self.device))
            nll += float(s)
            cnt += float(c)
        return {"eval_nll": nll / max(cnt, 1.0)}

    def _device_stream(self, batches: Iterable) -> Iterable:
        """The double buffer: batch i + 1's host-to-device copy is queued
        before step i runs, so the step never waits on it. On the card
        the copy runs from pinned memory on a side stream; before a step
        reads the batch, the compute stream waits on the copy's event,
        and the batch's tensors are recorded on the compute stream, so
        the caching allocator cannot reuse their memory early. On the
        CPU the same order, without streams."""
        cuda = self.device.type == "cuda"
        if cuda:
            side = torch.cuda.Stream(self.device)
            compute = torch.cuda.current_stream(self.device)

        def stage(batch):
            if not cuda:
                return _to_device(batch, self.device), None
            host = tree_map(lambda a: torch.as_tensor(a).pin_memory(), batch)
            with torch.cuda.stream(side):
                staged = tree_map(
                    lambda t: t.to(self.device, non_blocking=True), host)
                return staged, side.record_event()

        def ready(staged, event):
            if event is not None:
                compute.wait_event(event)
                for t in tree_leaves(staged):
                    t.record_stream(compute)
            return staged

        pending = None
        for batch in batches:
            nxt = stage(batch)
            if pending is not None:
                yield ready(*pending)
            pending = nxt
        if pending is not None:
            yield ready(*pending)

    def _rank_rows(self, batches: Iterable) -> Iterable:
        """This rank's rows of each global batch; ``batch_shape`` keeps
        the global (batch, seq)."""
        for batch in batches:
            toks = batch["tokens"]
            self.batch_shape = (int(toks.shape[0]), int(toks.shape[1]))
            yield spmd.batch_rows(batch, self.mesh)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def fit(self, train_batches: Iterable,
            eval_batches: Optional[Callable] = None,
            hooks: Optional[List[Hook]] = None) -> List[dict]:
        """Run up to ``total_steps`` global steps from ``start_step``;
        returns the per-step history (``step``, ``loss``, ``nll``,
        ``step_ms``, ``data_wait_ms``, ``ckpt_block_ms`` and whatever
        hooks add). ``step_ms`` is the host's time in the step call; it
        is the card's step time only when a hook sets ``needs_sync``.
        ``data_wait_ms`` is the host's time blocked on the input (with
        the double buffer, the next batch's staging included);
        ``ckpt_block_ms`` its time blocked on a checkpoint, 0 on steps
        without one."""
        self._hooks = (self.default_hooks(eval_batches)
                       if hooks is None else list(hooks))
        needs_sync = any(getattr(h, "needs_sync", False)
                         for h in self._hooks)
        history: List[dict] = []
        step = self.start_step
        if self.plan is not None:
            train_batches = self._rank_rows(train_batches)
        if self.tcfg.double_buffer:
            train_batches = self._device_stream(train_batches)
        it = iter(train_batches)
        while step < self.tcfg.total_steps:
            t_wait = time.perf_counter()
            try:
                batch = next(it)
            except StopIteration:
                break
            batch = _to_device(batch, self.device)
            data_wait_ms = (time.perf_counter() - t_wait) * 1e3
            if self.plan is None:
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
