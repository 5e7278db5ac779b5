"""Optimizer interface (``repro.optim.base``): ``init(params) -> state``
and ``update(grads, state, params, step=None) -> (params, state)``
over the port's parameter trees (nested dicts and lists of tensors)."""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple


@dataclasses.dataclass(frozen=True)
class Optimizer:
    name: str
    init: Callable[[Any], Any]  # params -> state
    # (grads, state, params, step) -> (new_params, new_state)
    update: Callable[[Any, Any, Any, Any], Tuple[Any, Any]]
    hyper: Dict[str, Any] = dataclasses.field(default_factory=dict)
