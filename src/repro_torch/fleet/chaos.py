"""Fault injection for the fleet: seeded replica kill/stall mid-stream.

A :class:`ChaosPlan` is a deterministic schedule of events against the
fleet's step clock. At each fleet step the driver pops the events due
and applies them:

* ``kill`` — the victim replica dies instantly (process gone): its
  engine never steps again, every in-flight request is rerouted to a
  survivor and re-decoded from the prompt (greedy → token-identical),
  and the tokens it had already produced for them are charged as lost
  work in :class:`repro_torch.fleet.FleetReport`.
* ``stall`` — the victim freezes for ``stall_steps`` fleet steps
  (GC pause / network partition): its heartbeat stops advancing. If the
  stall outlasts the fleet's ``heartbeat_timeout`` the health monitor
  declares it dead and the kill path above takes over; a short stall
  just resumes (engine state intact, outputs unchanged).

Victim selection is seeded (``numpy.random.RandomState``): an event may
pin ``replica`` explicitly, else the plan draws uniformly from the
replicas alive at fire time — the same seed always injects the same
fault into the same replica, so chaos tests are reproducible.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

CHAOS_MODES = ("", "kill", "stall")


@dataclasses.dataclass(frozen=True)
class ChaosEvent:
    """One scheduled fault. ``replica=None`` defers victim choice to the
    plan's seeded rng at fire time (among then-alive replicas)."""

    step: int                      # fleet step at which the fault fires
    kind: str                      # 'kill' | 'stall'
    replica: Optional[int] = None  # victim id; None -> seeded choice
    stall_steps: int = 12          # stall only: frozen fleet steps

    def __post_init__(self):
        if self.kind not in CHAOS_MODES[1:]:
            raise ValueError(
                f"chaos event kind must be one of {CHAOS_MODES[1:]}, got "
                f"{self.kind!r}")
        if self.step < 0 or self.stall_steps < 1:
            raise ValueError("step must be >= 0 and stall_steps >= 1")


class ChaosPlan:
    """Deterministic fault schedule over the fleet step clock."""

    def __init__(self, events: Sequence[ChaosEvent] = (), seed: int = 0):
        self._events = sorted(events, key=lambda e: e.step)
        self._rng = np.random.RandomState(seed)
        self.fired: List[ChaosEvent] = []

    def __len__(self) -> int:
        return len(self._events)

    def pop_due(self, step: int) -> List[ChaosEvent]:
        """Events scheduled at or before ``step``, in schedule order;
        each is returned exactly once."""
        due = [e for e in self._events if e.step <= step]
        self._events = self._events[len(due):]
        self.fired.extend(due)
        return due

    def choose_victim(self, event: ChaosEvent,
                      alive: Sequence[int]) -> Optional[int]:
        """Resolve the event's victim among currently-alive replica ids:
        the pinned replica if still alive, else a seeded uniform draw
        (None when nothing is left to break)."""
        alive = sorted(alive)
        if not alive:
            return None
        if event.replica is not None:
            return event.replica if event.replica in alive else None
        return int(alive[self._rng.randint(len(alive))])

    @classmethod
    def from_spec(cls, chaos: str, *, chaos_step: int = 8,
                  stall_steps: int = 12, seed: int = 0) -> "ChaosPlan":
        """The one-fault plans the ``fleet.chaos`` spec knob names:
        ``""`` (no chaos), ``"kill"`` or ``"stall"`` at ``chaos_step``."""
        if chaos not in CHAOS_MODES:
            raise ValueError(
                f"chaos must be one of {CHAOS_MODES}, got {chaos!r}")
        events = () if not chaos else (
            ChaosEvent(step=chaos_step, kind=chaos,
                       stall_steps=stall_steps),)
        return cls(events, seed=seed)
