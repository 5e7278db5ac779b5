"""The fleet driver: N data-parallel replicas behind one router.

``Fleet`` owns the replicas (each a ``serve.Engine`` wrapped in a
health state machine), the prefix-affinity :class:`~repro_torch.fleet.router.
Router`, and an optional :class:`~repro_torch.fleet.chaos.ChaosPlan`. It
drives everything on one deterministic *fleet step* clock; each tick:

1. **chaos** — fire the faults due this step (seeded kill/stall);
2. **monitor** — declare any replica whose heartbeat age exceeds
   ``heartbeat_timeout`` dead (how a stalled replica is evicted);
   every in-flight request of a newly-dead replica is stripped of its
   runtime state and pushed back into the fleet arrival queue
   (*retry-with-rerouting* — its lost tokens are charged to goodput);
3. **route** — hand every due arrival to the router (consistent hash
   on the prefix-template key, least-loaded fallback) and submit it to
   the chosen replica;
4. **step** — advance every live replica one engine round (stalled
   replicas skip and miss their beat).

The loop runs until every submitted request id has finished somewhere.
Greedy outputs of completed requests are token-identical to a
single-replica run: a request is either served whole by one engine
(batch composition never changes greedy tokens) or
re-decoded from its prompt on a survivor (the preemption-resume
contract). The run ends with a :class:`FleetReport`; a request-id
conservation check (nothing dropped, nothing duplicated) runs before
the report is built.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
import time
from typing import Any, Dict, List, Optional, Sequence

from repro_torch.fleet.chaos import ChaosPlan
from repro_torch.fleet.metrics import FleetReport
from repro_torch.fleet.replica import Replica, ReplicaState, reset_for_retry
from repro_torch.fleet.router import ROUTING_POLICIES, Router
from repro_torch.serve.request import Request


@dataclasses.dataclass(frozen=True)
class FleetConfig:
    """Host-side fleet knobs (engine geometry stays in ``ServeConfig``)."""

    routing: str = "prefix"      # prefix | least_loaded
    heartbeat_timeout: int = 4   # missed beats before a replica is dead
    vnodes: int = 32             # ring points per replica
    max_steps: int = 100_000     # runaway-loop backstop

    def __post_init__(self):
        if self.routing not in ROUTING_POLICIES:
            raise ValueError(
                f"routing must be one of {ROUTING_POLICIES}, got "
                f"{self.routing!r}")
        if self.heartbeat_timeout < 1:
            raise ValueError("heartbeat_timeout must be >= 1")


class Fleet:
    def __init__(self, engines: Sequence[Any],
                 config: Optional[FleetConfig] = None,
                 chaos: Optional[ChaosPlan] = None):
        if not engines:
            raise ValueError("a fleet needs at least one engine")
        self.config = config or FleetConfig()
        self.chaos = chaos or ChaosPlan()
        self.replicas: Dict[int, Replica] = {
            i: Replica(i, e) for i, e in enumerate(engines)}
        self.router = Router(self.config.routing, self.config.vnodes)
        for rid in self.replicas:
            self.router.add_replica(rid)
        self._arrivals: list = []          # (fleet arrival step, seq, req)
        self._seq = itertools.count()
        self._submitted_ids: set = set()
        self._step = 0
        self.kills = 0
        self.stalls = 0
        self.reroutes = 0
        self.lost_tokens = 0

    # ------------------------------------------------------------------ #
    @property
    def current_step(self) -> int:
        return self._step

    def submit(self, req: Request) -> None:
        """Queue a request at its fleet-level ``arrival_step``."""
        if req.id in self._submitted_ids:
            raise ValueError(f"request id {req.id} already submitted")
        self._submitted_ids.add(req.id)
        heapq.heappush(self._arrivals,
                       (req.arrival_step, next(self._seq), req))

    # -- failure handling ----------------------------------------------- #
    def _bury(self, replica: Replica, *, cause: str) -> None:
        """Common failover path for kill and heartbeat eviction: remove
        the replica from the router, charge its abandoned decode work to
        goodput, and requeue its orphans for immediate rerouting."""
        orphans = replica.kill()
        self.router.remove_replica(replica.id)
        self.kills += 1
        for req in orphans:
            self.lost_tokens += reset_for_retry(req)
            self.reroutes += 1
            heapq.heappush(self._arrivals, (self._step, next(self._seq), req))

    def _fire_chaos(self) -> None:
        for event in self.chaos.pop_due(self._step):
            alive = [r.id for r in self.replicas.values()
                     if r.state is not ReplicaState.DEAD]
            victim = self.chaos.choose_victim(event, alive)
            if victim is None:
                continue
            replica = self.replicas[victim]
            if event.kind == "kill":
                self._bury(replica, cause="chaos kill")
            else:
                replica.stall(event.stall_steps)
                self.stalls += 1

    def _monitor(self) -> None:
        """Heartbeat health check: a replica that has beaten before and
        then gone quiet past the timeout is declared dead. (A STARTING
        replica has no beat yet; it gets the same grace from -1.)"""
        for replica in self.replicas.values():
            if replica.state is ReplicaState.DEAD:
                continue
            if replica.heartbeat_age(self._step) > \
                    self.config.heartbeat_timeout:
                self._bury(replica, cause="heartbeat timeout")

    # -- routing -------------------------------------------------------- #
    def _eligible(self) -> Dict[int, int]:
        return {r.id: r.load for r in self.replicas.values() if r.accepting}

    def _route_due(self) -> None:
        while self._arrivals and self._arrivals[0][0] <= self._step:
            eligible = self._eligible()
            if not eligible:
                raise RuntimeError(
                    f"fleet step {self._step}: requests pending but no "
                    f"surviving replica accepts work")
            _, _, req = heapq.heappop(self._arrivals)
            rid = self.router.route(req, eligible)
            self.replicas[rid].submit(req)

    # -- main loop ------------------------------------------------------ #
    def _tick(self) -> None:
        self._fire_chaos()
        self._monitor()
        self._route_due()
        for replica in self.replicas.values():
            replica.step(self._step)
        self._step += 1

    def _work_remains(self) -> bool:
        return bool(self._arrivals) or any(
            r.outstanding for r in self.replicas.values())

    def run(self, requests: Sequence[Request] = ()) -> FleetReport:
        """Serve ``requests`` (plus anything already submitted) to
        completion across the fleet and report."""
        t0 = time.perf_counter()
        for req in requests:
            self.submit(req)
        while self._work_remains():
            if self._step >= self.config.max_steps:
                raise RuntimeError(
                    f"fleet exceeded max_steps={self.config.max_steps} "
                    f"with work remaining (scheduling bug or livelock)")
            self._tick()

        reports = {rid: r.finalize(t0) for rid, r in self.replicas.items()}
        finished: List[int] = [
            req.id for rep in reports.values() for req in rep.requests]
        # Conservation: the kill->reroute path must neither drop nor
        # duplicate a request — every submitted id finishes exactly once.
        if sorted(finished) != sorted(self._submitted_ids):
            dropped = self._submitted_ids - set(finished)
            dupes = {i for i in finished if finished.count(i) > 1}
            raise RuntimeError(
                f"request-id conservation violated: dropped={sorted(dropped)} "
                f"duplicated={sorted(dupes)}")
        return FleetReport(
            replica_reports=reports,
            replica_states={rid: r.state.value
                            for rid, r in self.replicas.items()},
            elapsed_s=time.perf_counter() - t0,
            fleet_steps=self._step,
            kills=self.kills,
            stalls=self.stalls,
            reroutes=self.reroutes,
            lost_tokens=self.lost_tokens,
            routed_affinity=self.router.routed_affinity,
            routed_fallback=self.router.routed_fallback,
            routing_hits=self.router.hits,
        )
