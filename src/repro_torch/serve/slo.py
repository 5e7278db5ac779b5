"""SLO classes and the victim choices the engine's preemption calls
(``repro.serve.slo``).

A request's ``slo`` (an :class:`SLOClass`, or None for best-effort
traffic) sets its priority and its latency budgets. Budgets are in
engine steps (one scheduling round), so the arithmetic is machine
independent. Untagged requests have infinite slack and the best-effort
priority, so a workload without classes preempts youngest-first and
never preempts at admission.

Policy, in two places: under pool pressure the engine preempts the slot
with the most slack (ties to the youngest admission); at admission a
latency-critical candidate that cannot get pages may evict one running
request of a strictly lower class with strictly more slack, unless its
own budget is already blown.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Mapping, Optional, Tuple

INF = float("inf")
BEST_EFFORT_PRIORITY = 1 << 30


@dataclasses.dataclass(frozen=True)
class SLOClass:
    """A named latency class: ``priority`` (0 most urgent) and budgets
    in engine steps from arrival to first token (``ttft_steps``) and to
    retirement (``latency_steps``); None is unbounded."""

    name: str
    priority: int = 0
    ttft_steps: Optional[int] = None
    latency_steps: Optional[int] = None

    def __post_init__(self):
        if self.priority < 0:
            raise ValueError("priority must be >= 0")
        for field in ("ttft_steps", "latency_steps"):
            v = getattr(self, field)
            if v is not None and v < 1:
                raise ValueError(f"{field} must be >= 1 (or None)")


INTERACTIVE = SLOClass("interactive", priority=0,
                       ttft_steps=8, latency_steps=48)
STANDARD = SLOClass("standard", priority=1,
                    ttft_steps=32, latency_steps=160)
BATCH = SLOClass("batch", priority=2)  # unbounded: pure best-effort

CLASSES: Dict[str, SLOClass] = {
    c.name: c for c in (INTERACTIVE, STANDARD, BATCH)}


def get_class(name: str) -> SLOClass:
    try:
        return CLASSES[name]
    except KeyError:
        raise ValueError(
            f"unknown SLO class {name!r}; known: {sorted(CLASSES)}"
        ) from None


def priority_of(req) -> int:
    slo = getattr(req, "slo", None)
    return slo.priority if slo is not None else BEST_EFFORT_PRIORITY


def deadline(req) -> float:
    """Step by which the request must retire; inf when unbudgeted."""
    slo = getattr(req, "slo", None)
    if slo is None or slo.latency_steps is None:
        return INF
    return req.arrival_step + slo.latency_steps


def slack(req, step: int) -> float:
    """Deadline minus now minus the steps still needed (one a token)."""
    d = deadline(req)
    if d == INF:
        return INF
    return d - step - (req.max_new_tokens - len(req.tokens))


def blown(req, step: int) -> bool:
    return slack(req, step) < 0


def met_slo(req) -> bool:
    """Did a finished request meet every budget it carried? Untagged
    and unbudgeted requests always did."""
    slo = getattr(req, "slo", None)
    if slo is None:
        return True
    if (slo.ttft_steps is not None and req.s_first_token is not None
            and req.s_first_token - req.arrival_step > slo.ttft_steps):
        return False
    if (slo.latency_steps is not None and req.s_done is not None
            and req.s_done - req.arrival_step > slo.latency_steps):
        return False
    return True


def choose_victim(active: Mapping[int, object], step: int,
                  admit_seq: Mapping[int, int]) -> int:
    """Growth-pressure victim: the slot with the most slack, ties to
    the youngest admission."""
    if not active:
        raise ValueError("no active slots to preempt")
    return max(active, key=lambda s: (slack(active[s], step), admit_seq[s]))


def admission_victim(candidate, running: Iterable[Tuple[int, object]],
                     step: int,
                     admit_seq: Mapping[int, int]) -> Optional[int]:
    """Admission-pressure victim for ``candidate``, or None: a running
    request of a strictly lower class with strictly more slack. A
    candidate whose budget is blown never preempts."""
    if blown(candidate, step):
        return None
    cand_pri = priority_of(candidate)
    cand_slack = slack(candidate, step)
    best = None
    for slot, req in running:
        if priority_of(req) <= cand_pri:
            continue
        s = slack(req, step)
        if s <= cand_slack:
            continue
        key = (s, admit_seq[slot])
        if best is None or key > best[0]:
            best = (key, slot)
    return None if best is None else best[1]
