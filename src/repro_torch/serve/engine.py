"""Continuous-batching engine over the paged KV pool
(``repro.serve.engine``, paged layout).

KV lives in a shared :class:`~repro_torch.serve.cache.PagePool`; one
chunk program (``lm.decode_chunk``) advances every slot each round.
Decode rows feed one token; admitted prompts stream through the same
(B, C) batch as ``prefill_chunk``-sized slices. Admission is by
free-page budget (:class:`~repro_torch.serve.scheduler.PagedScheduler`);
when decode growth exhausts the pool the engine preempts the slot with
the most SLO slack (youngest first among untagged requests), which
re-queues at the front and later re-prefills from prompt + tokens so
far, token-identical under greedy sampling.

This slice serves greedily from bf16 or fp32 pools. Temperature
sampling, the prefix cache, speculative decoding, int8/int4 pools and
the slab layout raise ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import lm
from repro_torch.serve import cache as pool_ops
from repro_torch.serve import slo
from repro_torch.serve.metrics import ServeReport, StepTrace
from repro_torch.serve.request import Request
from repro_torch.serve.scheduler import PagedScheduler

_LATER = "is not ported yet (a later serving slice of the PyTorch port)"


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Engine knobs. ``max_len`` is the per-request token budget (prompt
    + generation). ``page_size`` / ``n_pages`` size the pool; ``n_pages``
    defaults to ``max_batch * ceil(max_len / page_size)``."""

    max_batch: int = 4
    max_len: int = 128
    temperature: float = 0.0
    eos_id: Optional[int] = None
    kv_layout: str = "auto"      # auto | paged
    page_size: int = 16
    prefill_chunk: int = 8
    n_pages: Optional[int] = None
    prefix_cache: bool = False
    kv_dtype: str = ""           # '' inherit model cfg | bfloat16 | float32
    spec_decode: str = "off"

    def __post_init__(self):
        if self.page_size < 1 or self.prefill_chunk < 1:
            raise ValueError("page_size and prefill_chunk must be >= 1")
        if self.n_pages is not None and self.n_pages < 1:
            raise ValueError("n_pages must be >= 1")
        for name, bad in (
                ("temperature > 0", self.temperature > 0.0),
                ("prefix_cache", self.prefix_cache),
                (f"kv_dtype={self.kv_dtype!r}", self.kv_dtype in ("int8", "int4")),
                (f"spec_decode={self.spec_decode!r}", self.spec_decode != "off"),
                (f"kv_layout={self.kv_layout!r}", self.kv_layout == "slab")):
            if bad:
                raise NotImplementedError(f"{name} {_LATER}")
        if self.kv_layout not in ("auto", "paged"):
            raise ValueError(f"kv_layout must be 'auto' or 'paged', got "
                             f"{self.kv_layout!r}")
        if self.kv_dtype not in ("", "bfloat16", "float32"):
            raise ValueError(f"unknown kv_dtype {self.kv_dtype!r}")

    @property
    def max_pages(self) -> int:
        """Page-table width: pages a single request can map."""
        return -(-self.max_len // self.page_size)

    @property
    def pool_pages(self) -> int:
        return self.n_pages or self.max_batch * self.max_pages


class Engine:
    """Paged continuous-batching engine on ``device`` (default CUDA),
    with ``params`` from ``lm.init_lm`` or ``lm.params_from_numpy``."""

    def __init__(self, cfg: ModelConfig, params,
                 serve: Optional[ServeConfig] = None, *, device="cuda"):
        self.scfg = serve or ServeConfig()
        if self.scfg.kv_dtype:
            cfg = dataclasses.replace(cfg, kv_cache_dtype=self.scfg.kv_dtype)
        self.cfg = cfg
        self.params = params
        self.device = resolve_device(device)
        self.reset()

    def reset(self) -> None:
        """Fresh scheduler, pool and trace state."""
        B = self.scfg.max_batch
        self._tok = np.zeros((B,), np.int32)
        self._pos = np.zeros((B,), np.int32)
        self._arrivals: list = []
        self._arrival_seq = itertools.count()
        self._finished: List[Request] = []
        self._trace: List[StepTrace] = []
        self._step_idx = 0
        self._preempted = 0
        self._pool = pool_ops.PagePool(self.scfg.pool_pages,
                                       self.scfg.page_size)
        self.sched = PagedScheduler(B, self._pool, self._admission_pages,
                                    on_shortfall=self._admission_preempt)
        self._cache = lm.init_paged_cache(
            self.cfg, self.scfg.pool_pages, self.scfg.page_size,
            device=self.device)
        self._ptab = np.full((B, self.scfg.max_pages), -1, np.int32)
        self._stream = {}
        self._admit_seq = np.zeros((B,), np.int64)
        self._admit_counter = itertools.count(1)

    def _admission_pages(self, req: Request) -> int:
        """Pages the pending prefill stream needs (prompt + any tokens
        generated before a preemption)."""
        return self._pool.pages_for(len(req.prompt) + len(req.tokens))

    def submit(self, req: Request) -> None:
        """Register a request; it enters the queue at ``req.arrival_step``."""
        if req.prompt_len + req.max_new_tokens > self.scfg.max_len:
            raise ValueError(
                f"request {req.id}: prompt+generation "
                f"({req.prompt_len}+{req.max_new_tokens}) "
                f"exceeds max_len={self.scfg.max_len}")
        need = self._pool.pages_for(req.prompt_len + req.max_new_tokens)
        if need > self.scfg.pool_pages:
            raise ValueError(
                f"request {req.id}: needs {need} pages but the pool has "
                f"{self.scfg.pool_pages}; raise n_pages or shrink the request")
        heapq.heappush(
            self._arrivals, (req.arrival_step, next(self._arrival_seq), req))

    def run(self) -> ServeReport:
        """Step until every submitted request has finished; the engine is
        reset on return, so a reused engine reports each workload apart."""
        t0 = time.perf_counter()
        while self._arrivals or self.sched.has_work:
            self.step()
        return self.finalize(t0)

    def finalize(self, t0: float) -> ServeReport:
        report = ServeReport(requests=list(self._finished),
                             steps=list(self._trace),
                             elapsed_s=time.perf_counter() - t0,
                             preemptions=self._preempted)
        self.reset()
        return report

    def step(self) -> None:
        """One scheduling round: arrivals -> admissions -> chunk step."""
        while self._arrivals and self._arrivals[0][0] <= self._step_idx:
            _, _, req = heapq.heappop(self._arrivals)
            if req.t_arrival is None:
                req.t_arrival = time.perf_counter()
            self.sched.submit(req)
        for slot, req in self.sched.admit():
            self._admit_paged(slot, req)
        if self.sched.n_active:
            self._chunk_once()
        self._step_idx += 1

    def defrag(self) -> None:
        """Compact the page pool; page tables are rewritten and decode
        output is unchanged."""
        pool_ops.apply_defrag(self._cache, self._pool.defrag())
        for slot in range(self.scfg.max_batch):
            self._ptab[slot] = self._pool.table_row(slot, self.scfg.max_pages)

    # ------------------------------------------------------------------ #
    def _preempt_slot(self, victim: int) -> None:
        """Evict ``victim`` to its band's queue front; the scheduler frees
        its pages."""
        self.sched.preempt(victim)
        self._ptab[victim] = -1
        self._stream.pop(victim, None)
        self._preempted += 1

    def _admission_preempt(self, req: Request) -> bool:
        """SLO-aware admission hook: evict one staged running request of
        a strictly lower class with more slack, if any."""
        staged = [(s, r) for s, r in self.sched.running()
                  if self._ptab[s, 0] >= 0]
        victim = slo.admission_victim(
            req, staged, self._step_idx,
            {s: int(self._admit_seq[s]) for s, _ in staged})
        if victim is None:
            return False
        self._preempt_slot(victim)
        return True

    def _admit_paged(self, slot: int, req: Request) -> None:
        """Stage the prefill stream; the scheduler reserved its pages."""
        self._stream[slot] = list(req.prompt) + list(req.tokens)
        self._pos[slot] = 0
        self._admit_seq[slot] = next(self._admit_counter)
        self._ptab[slot] = self._pool.table_row(slot, self.scfg.max_pages)

    def _chunk_once(self) -> None:
        """One mixed dispatch: decode rows advance one token, prefilling
        rows up to ``prefill_chunk`` prompt tokens."""
        C = self.scfg.prefill_chunk
        B = self.scfg.max_batch
        active = dict(self.sched.running())

        # Lazy decode growth; when the pool runs dry, preempt.
        while active:
            growth = {}
            for slot in active:
                if self._stream.get(slot):
                    continue  # prefill pages were reserved at admission
                need = (self._pool.pages_for(int(self._pos[slot]) + 1)
                        - len(self._pool.slot_pages(slot)))
                if need > 0:
                    growth[slot] = need
            if sum(growth.values()) <= self._pool.free_pages:
                for slot in growth:
                    self._pool.ensure(slot, int(self._pos[slot]) + 1)
                break
            victim = slo.choose_victim(
                active, self._step_idx,
                {s: int(self._admit_seq[s]) for s in active})
            self._preempt_slot(victim)
            active.pop(victim)
        if not active:
            return

        # Idle rows feed n_valid=1 against an all -1 page-table row.
        toks = np.zeros((B, C), np.int32)
        nv = np.ones((B,), np.int32)
        posb = np.zeros((B,), np.int32)
        prefilling = False
        for slot in active:
            posb[slot] = self._pos[slot]
            stream = self._stream.get(slot)
            if stream:
                n = min(C, len(stream))
                toks[slot, :n] = stream[:n]
                nv[slot] = n
                prefilling = True
            else:
                toks[slot, 0] = self._tok[slot]
            self._ptab[slot] = self._pool.table_row(slot, self.scfg.max_pages)

        t0 = time.perf_counter()
        dev = self.device
        with torch.inference_mode():
            logits, self._cache = lm.decode_chunk(
                self.params, self.cfg, torch.from_numpy(toks).to(dev),
                self._cache, torch.from_numpy(self._ptab).to(dev),
                torch.from_numpy(posb).to(dev), torch.from_numpy(nv).to(dev))
            nxt = torch.argmax(logits, dim=-1).cpu().numpy()
        dt = time.perf_counter() - t0

        produced = 0
        for slot, req in active.items():
            n = int(nv[slot])
            stream = self._stream.get(slot)
            self._pos[slot] += n
            if stream:
                self._stream[slot] = stream[n:]
                if self._stream[slot]:
                    continue  # mid-prompt: logits not sampled yet
            tok = int(nxt[slot])
            req.tokens.append(tok)
            produced += 1
            if req.t_first_token is None:
                req.t_first_token = time.perf_counter()
            self._tok[slot] = tok
            if req.done or tok == self.scfg.eos_id:
                self._retire_paged(slot, req)
        self._trace.append(StepTrace(
            "mixed" if prefilling else "decode", dt, produced,
            pool_util=self._pool.utilization()))

    def _retire_paged(self, slot: int, req: Request) -> None:
        self.sched.retire(slot)  # frees the slot's pages too
        self._ptab[slot] = -1
        self._stream.pop(slot, None)
        self._finished.append(req)


def synthetic_requests(cfg, *, n: int, tokens: int, prompt_len: int,
                       seed: int = 0,
                       prompt_lens: Optional[Sequence[int]] = None,
                       ) -> List[Request]:
    """Offline synthetic workload, byte-identical to the reference's
    ``synthetic_requests`` for a token-only arch: ``prompt_lens`` cycles
    explicit lengths, else each length is drawn from
    ``[prompt_len // 2, prompt_len]``; ids come from
    ``np.random.RandomState(seed)``."""
    rng = np.random.RandomState(seed)
    reqs = []
    for i in range(n):
        if prompt_lens:
            p_len = max(1, int(prompt_lens[i % len(prompt_lens)]))
        else:
            lo = max(1, min(prompt_len // 2, prompt_len))
            p_len = int(rng.randint(lo, max(lo + 1, prompt_len + 1)))
        prompt = rng.randint(0, cfg.vocab, size=p_len).tolist()
        reqs.append(Request(prompt=prompt, max_new_tokens=tokens))
    return reqs
