"""SLO arithmetic and the victim choices the engine's preemption calls
(``repro.serve.slo``).

A request's ``slo`` (an object with ``priority`` and
``latency_steps``, or None) sets its priority and slack; budgets are in
engine steps, so the arithmetic is machine independent. Untagged
requests have infinite slack and the best-effort priority, so a
workload without classes preempts youngest-first and never preempts at
admission. The SLO classes themselves come with the server scenario, in
a later slice.
"""
from __future__ import annotations

from typing import Iterable, Mapping, Optional, Tuple

INF = float("inf")
BEST_EFFORT_PRIORITY = 1 << 30


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
