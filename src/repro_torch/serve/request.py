"""Request model of the serving engine (``repro.serve.request``).

    WAITING --submit--> QUEUED --admit--> RUNNING --retire--> FINISHED

WAITING requests sit in the engine's arrival buffer until their
``arrival_step``; QUEUED ones wait in the scheduler for a slot; RUNNING
ones own one slot until ``max_new_tokens`` (or EOS), when they retire.
"""
from __future__ import annotations

import dataclasses
import enum
import itertools
from typing import Any, List, Optional

_ids = itertools.count()


class RequestState(enum.Enum):
    WAITING = "waiting"
    QUEUED = "queued"
    RUNNING = "running"
    FINISHED = "finished"


@dataclasses.dataclass(eq=False)  # identity semantics
class Request:
    """One generation request: prompt token ids, generation budget,
    ``media`` (an enc-dec arch's encoder frames, (enc_source_len,
    d_model); None for token-only traffic) and the engine step it
    becomes visible at (0 = offline). Equality is identity: media
    arrays make a field-wise ``__eq__`` ill-defined. ``slo`` holds
    the request's latency class (``serve.slo.SLOClass``), None for
    best-effort traffic; ``template`` is any hashable naming the shared
    prompt template the request opens with (None = untemplated)."""

    prompt: List[int]
    max_new_tokens: int = 16
    media: Optional[Any] = None
    arrival_step: int = 0
    id: int = dataclasses.field(default_factory=lambda: next(_ids))
    slo: Optional[Any] = None
    template: Optional[Any] = None

    # -- runtime state (owned by scheduler/engine) ---------------------- #
    state: RequestState = RequestState.WAITING
    slot: Optional[int] = None
    tokens: List[int] = dataclasses.field(default_factory=list)
    t_arrival: Optional[float] = None      # wall clock at queue entry
    t_first_token: Optional[float] = None  # wall clock after prefill
    t_done: Optional[float] = None         # wall clock at retirement
    # Step-clock twins of the wall stamps (engine scheduling rounds):
    # deterministic, so SLO budgets are checked machine-independently.
    s_arrival: Optional[int] = None
    s_first_token: Optional[int] = None
    s_done: Optional[int] = None
    # Scheduler ticket (set at first submit, kept across preemptions).
    sched_seq: Optional[int] = None

    def __post_init__(self):
        if self.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if not self.prompt:
            raise ValueError("empty prompt")

    @property
    def prompt_len(self) -> int:
        return len(self.prompt)

    @property
    def done(self) -> bool:
        return len(self.tokens) >= self.max_new_tokens

    @property
    def ttft_s(self) -> Optional[float]:
        if self.t_first_token is None or self.t_arrival is None:
            return None
        return self.t_first_token - self.t_arrival

    @property
    def latency_s(self) -> Optional[float]:
        if self.t_done is None or self.t_arrival is None:
            return None
        return self.t_done - self.t_arrival
