"""One fleet replica: an ``Engine`` behind a health state machine.

A :class:`Replica` wraps a ``serve.Engine`` in-process (tests, CI, the
benchmarks) but exposes only the message-shaped surface a subprocess
deployment needs — submit a request, take one step, report health —
so swapping the in-process engine for an RPC stub changes this file,
not the fleet driver.

Health is a four-state machine driven by the fleet's step clock:

    STARTING --first step--> READY --drain()--> DRAINING --empty--> DEAD
        \\                      |                    |
         `----- kill() ------- DEAD <--- kill() ----'

``STARTING``/``READY`` replicas accept new work; ``DRAINING`` finishes
what it holds but is removed from the router; ``DEAD`` never steps
again. Liveness is heartbeat-based: every completed engine step beats
(``last_beat``), a stalled replica stops beating, and the fleet's
monitor declares any replica whose beat age exceeds the configured
timeout dead — kill and stall-past-timeout converge on one failover
path.
"""
from __future__ import annotations

import enum
from typing import Any, Dict, List, Optional

from repro_torch.serve.request import Request, RequestState


class ReplicaState(enum.Enum):
    STARTING = "starting"  # constructed, no completed step yet
    READY = "ready"        # beating, accepting work
    DRAINING = "draining"  # finishing in-flight work, no new admissions
    DEAD = "dead"          # killed or drained; never steps again


def reset_for_retry(req: Request) -> int:
    """Strip a request's runtime state so a survivor can re-serve it
    from the prompt (recompute-style, token-identical under greedy —
    the same contract pool-pressure preemption relies on). Returns the
    number of already-generated tokens thrown away (the lost work the
    fleet goodput charges)."""
    lost = len(req.tokens)
    req.tokens = []
    req.state = RequestState.WAITING
    req.slot = None
    req.sched_seq = None
    req.t_arrival = req.t_first_token = req.t_done = None
    req.s_arrival = req.s_first_token = req.s_done = None
    return lost


class Replica:
    def __init__(self, rid: int, engine: Any):
        self.id = rid
        self.engine = engine
        self.state = ReplicaState.STARTING
        self.last_beat = -1          # fleet step of the last completed step
        self.outstanding: Dict[int, Request] = {}  # id -> in-flight request
        self._harvested = 0          # engine.finished entries consumed
        self._stall_left = 0         # fleet steps the engine stays frozen

    # -- routing surface ------------------------------------------------ #
    @property
    def accepting(self) -> bool:
        return self.state in (ReplicaState.STARTING, ReplicaState.READY)

    @property
    def load(self) -> int:
        """Outstanding requests (waiting + queued + running)."""
        return len(self.outstanding)

    def submit(self, req: Request) -> None:
        if not self.accepting:
            raise RuntimeError(
                f"replica {self.id} is {self.state.value}, not accepting")
        # The request's fleet-level arrival already elapsed; it enters
        # this engine's queue at the engine's own step clock.
        req.arrival_step = self.engine.current_step
        self.engine.submit(req)
        self.outstanding[req.id] = req

    # -- health --------------------------------------------------------- #
    def heartbeat_age(self, fleet_step: int) -> int:
        return fleet_step - self.last_beat

    @property
    def stalled(self) -> bool:
        return self._stall_left > 0

    def stall(self, steps: int) -> None:
        """Freeze the engine for ``steps`` fleet steps (chaos: GC pause /
        partition). Engine state is untouched, so a stall the health
        monitor tolerates resumes with identical outputs."""
        self._stall_left = max(self._stall_left, int(steps))

    def kill(self) -> List[Request]:
        """Immediate death. Returns the orphaned in-flight requests (in
        submission order) for the fleet to reroute; the dead engine is
        never stepped again, so its partial work on them is simply
        abandoned."""
        self.state = ReplicaState.DEAD
        orphans = sorted(self.outstanding.values(),
                         key=lambda r: (r.sched_seq is None, r.sched_seq,
                                        r.id))
        self.outstanding.clear()
        return orphans

    def drain(self) -> None:
        """Stop accepting; finish what is held, then retire."""
        if self.state in (ReplicaState.STARTING, ReplicaState.READY):
            self.state = ReplicaState.DRAINING

    # -- stepping ------------------------------------------------------- #
    @property
    def has_work(self) -> bool:
        return bool(self.engine._arrivals) or self.engine.sched.has_work

    def step(self, fleet_step: int) -> None:
        """One fleet tick for this replica: skip if dead or stalled
        (no heartbeat), else advance the engine one scheduling round,
        beat, and harvest newly finished requests."""
        if self.state is ReplicaState.DEAD:
            return
        if self._stall_left > 0:
            self._stall_left -= 1
            return
        if self.state is ReplicaState.DRAINING and not self.has_work:
            self.state = ReplicaState.DEAD  # drained: graceful retirement
            return
        self.engine.step()
        self.last_beat = fleet_step
        if self.state is ReplicaState.STARTING:
            self.state = ReplicaState.READY
        fin = self.engine.finished
        while self._harvested < len(fin):
            self.outstanding.pop(fin[self._harvested].id, None)
            self._harvested += 1

    def finalize(self, t0: float):
        """Per-replica ``ServeReport`` (resets the engine; the harvest
        cursor restarts with it)."""
        self._harvested = 0
        return self.engine.finalize(t0)
