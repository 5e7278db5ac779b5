"""Slot scheduler (``repro.serve.scheduler``): admits queued requests
into free slots and retires finished ones.

Invariants (tests/test_torch_serve.py): a RUNNING request owns exactly
one slot and a slot holds at most one request; admission is FIFO within
a priority band, in ticket order, so a preempted request re-enters at
the front of its band; retirement frees the slot in the same round.
"""
from __future__ import annotations

import itertools
from collections import deque
from typing import List, Optional, Tuple

from repro_torch.serve import slo
from repro_torch.serve.request import Request, RequestState


class Scheduler:
    def __init__(self, max_batch: int):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self.max_batch = max_batch
        self._slots: List[Optional[Request]] = [None] * max_batch
        self._queue: deque = deque()
        self._seq = itertools.count()

    def _can_admit(self, slot: int, req: Request) -> bool:
        return True

    def _select(self) -> Request:
        """Next candidate: lowest (priority, ticket)."""
        return min(self._queue,
                   key=lambda r: (slo.priority_of(r), r.sched_seq))

    def submit(self, req: Request) -> None:
        """Move a request into the queue (WAITING/QUEUED -> QUEUED)."""
        if req.state not in (RequestState.WAITING, RequestState.QUEUED):
            raise ValueError(f"cannot queue request in state {req.state}")
        if any(r is req for r in self._queue):
            raise ValueError(f"request {req.id} already queued")
        if req.sched_seq is None:  # preempted requests keep their ticket
            req.sched_seq = next(self._seq)
        req.state = RequestState.QUEUED
        self._queue.append(req)

    def admit(self) -> List[Tuple[int, Request]]:
        """Fill free slots from the queue; returns [(slot, request)]."""
        out = []
        for i in range(self.max_batch):
            if self._slots[i] is not None or not self._queue:
                continue
            req = self._select()
            if not self._can_admit(i, req):
                break  # strict in-band FIFO: never admit past a blocked head
            self._queue.remove(req)
            req.state = RequestState.RUNNING
            req.slot = i
            self._slots[i] = req
            out.append((i, req))
        return out

    def retire(self, slot: int) -> Request:
        """Free ``slot`` (RUNNING -> FINISHED); returns the request."""
        req = self._slots[slot]
        if req is None:
            raise ValueError(f"slot {slot} is already free")
        self._slots[slot] = None
        req.state = RequestState.FINISHED
        req.slot = None
        return req

    def preempt(self, slot: int) -> Request:
        """Kick the request in ``slot`` back to the queue front
        (RUNNING -> QUEUED); it keeps its tokens and is re-prefilled
        from prompt + tokens on re-admission."""
        req = self._slots[slot]
        if req is None:
            raise ValueError(f"slot {slot} is free; nothing to preempt")
        self._slots[slot] = None
        req.state = RequestState.QUEUED
        req.slot = None
        self._queue.appendleft(req)
        return req

    def running(self) -> List[Tuple[int, Request]]:
        return [(i, r) for i, r in enumerate(self._slots) if r is not None]

    @property
    def n_active(self) -> int:
        return sum(r is not None for r in self._slots)

    @property
    def n_queued(self) -> int:
        return len(self._queue)

    @property
    def has_work(self) -> bool:
        return bool(self._queue) or self.n_active > 0


class PagedScheduler(Scheduler):
    """Admission by free-page budget: ``cost(req)`` pages are reserved
    all-or-nothing as the request is admitted, and a blocked queue head
    blocks everyone behind it. With the prefix cache on, the engine
    passes ``acquire(slot, req) -> bool`` instead of ``cost``: it maps
    the stream's cached pages into the slot and charges only the new
    ones, still all-or-nothing. ``on_shortfall(req) -> bool`` (the SLO
    hook) may free capacity by preempting; True retries the admission."""

    def __init__(self, max_batch: int, pool, cost=None, acquire=None,
                 on_shortfall=None):
        if (cost is None) == (acquire is None):
            raise ValueError("pass exactly one of cost / acquire")
        super().__init__(max_batch)
        self.pool = pool
        self._cost = cost
        self._acquire = acquire
        self._on_shortfall = on_shortfall

    def _can_admit(self, slot: int, req: Request) -> bool:
        while True:
            ok = (self._acquire(slot, req) if self._acquire is not None
                  else self.pool.alloc(slot, self._cost(req)))
            if ok or self._on_shortfall is None:
                return ok
            if not self._on_shortfall(req):
                return False

    def preempt(self, slot: int) -> Request:
        self.pool.free_slot(slot)
        return super().preempt(slot)

    def retire(self, slot: int) -> Request:
        self.pool.free_slot(slot)
        return super().retire(slot)
