"""The four MLPerf-Inference scenarios as seeded trace generators and
engine drivers (``repro.serve.scenarios``).

* **single_stream**: one query in flight; the next is issued the moment
  the previous completes (issue-on-completion);
* **multi_stream**: a query of ``query_size`` requests every
  ``query_interval`` steps;
* **server**: Poisson arrivals (or the ``bursty`` / ``diurnal``
  replays), each request optionally carrying an SLO class;
* **offline**: the whole workload at step 0.

Arrivals are engine steps drawn from ``np.random.RandomState(seed)``
exactly as the reference draws them, so a trace is byte-identical to
the reference's for the same seed. Scenario choice and SLO tagging
change ordering and latency only: greedy tokens are the same in all
four.
"""
from __future__ import annotations

import math
import time
from typing import List, Optional, Sequence

import numpy as np

from repro_torch.serve.metrics import ServeReport
from repro_torch.serve.request import Request
from repro_torch.serve.slo import get_class

SCENARIOS = ("offline", "server", "single_stream", "multi_stream")
ARRIVAL_PATTERNS = ("poisson", "bursty", "diurnal")


# --------------------------------------------------------------------------- #
# Arrival processes (engine-step timestamps, deterministic per rng state).
# --------------------------------------------------------------------------- #
def poisson_arrivals(rng: np.random.RandomState, n: int,
                     rate: float) -> List[int]:
    """Poisson process at ``rate`` requests/step: the floor of the
    cumulative sum of exponential(1/rate) inter-arrival gaps."""
    if rate <= 0:
        raise ValueError("arrival rate must be > 0")
    gaps = rng.exponential(1.0 / rate, size=n)
    return np.floor(np.cumsum(gaps)).astype(np.int64).tolist()


def bursty_arrivals(rng: np.random.RandomState, n: int, rate: float,
                    burst_size: int = 4) -> List[int]:
    """Flash-crowd shape: burst epochs are Poisson at ``rate /
    burst_size`` (same long-run request rate) and every request of a
    burst lands on its epoch's step."""
    if burst_size < 1:
        raise ValueError("burst_size must be >= 1")
    n_bursts = -(-n // burst_size)
    epochs = poisson_arrivals(rng, n_bursts, rate / burst_size)
    return [epochs[i // burst_size] for i in range(n)]


def diurnal_arrivals(rng: np.random.RandomState, n: int, rate: float,
                     period: int = 64) -> List[int]:
    """Compressed-day shape: an inhomogeneous Poisson process whose
    instantaneous rate swings sinusoidally +-80% around ``rate`` with
    the given period — peak-hour pileups and a near-idle trough."""
    if rate <= 0 or period < 2:
        raise ValueError("rate must be > 0 and period >= 2")
    t, out = 0.0, []
    for _ in range(n):
        lam = rate * (1.0 + 0.8 * math.sin(2.0 * math.pi * t / period))
        lam = max(lam, rate * 0.05)
        t += rng.exponential(1.0 / lam)
        out.append(int(t))
    return out


def arrival_steps(pattern: str, rng: np.random.RandomState, n: int,
                  rate: float, *, burst_size: int = 4,
                  period: int = 64) -> List[int]:
    """Arrival timestamps for a named pattern (sorted, non-negative)."""
    if pattern == "poisson":
        return poisson_arrivals(rng, n, rate)
    if pattern == "bursty":
        return bursty_arrivals(rng, n, rate, burst_size=burst_size)
    if pattern == "diurnal":
        return diurnal_arrivals(rng, n, rate, period=period)
    raise ValueError(
        f"unknown arrival pattern {pattern!r}; known: {ARRIVAL_PATTERNS}")


# --------------------------------------------------------------------------- #
# Trace construction.
# --------------------------------------------------------------------------- #
def make_trace(cfg, *, scenario: str, n: int, tokens: int,
               prompt_len: int, seed: int = 0, rate: float = 0.5,
               pattern: str = "poisson", query_size: int = 2,
               query_interval: int = 8,
               slo_classes: Sequence[str] = (),
               prompt_lens: Optional[Sequence[int]] = None,
               shared_prefix_len: int = 0, n_templates: int = 1,
               suffix_spread: Optional[Sequence[int]] = None,
               ) -> List[Request]:
    """Deterministic scenario trace: ``n`` synthetic requests with the
    scenario's arrival discipline stamped on, cycled through
    ``slo_classes`` (request ``i`` gets class ``i % len``; empty ->
    untagged best-effort).

    Prompts come from :func:`repro_torch.serve.engine.synthetic_requests`
    with the same ``seed`` for every scenario, so the *workload* is
    scenario-invariant — only arrivals differ. SingleStream arrivals
    are left at 0 here; :func:`run_single_stream` re-stamps each one at
    issue time (issue-on-completion is a property of the driver, not of
    a precomputed trace).
    """
    from repro_torch.serve.engine import synthetic_requests

    if scenario not in SCENARIOS:
        raise ValueError(
            f"unknown serve scenario {scenario!r}; known: {SCENARIOS}")
    if query_size < 1 or query_interval < 1:
        raise ValueError("query_size and query_interval must be >= 1")
    reqs = synthetic_requests(
        cfg, n=n, tokens=tokens, prompt_len=prompt_len,
        scenario="server" if scenario == "server" else "offline",
        seed=seed, arrival_rate=rate, prompt_lens=prompt_lens,
        shared_prefix_len=shared_prefix_len, n_templates=n_templates,
        suffix_spread=suffix_spread)
    if scenario == "server" and pattern != "poisson":
        # Non-stationary replay: swap the Poisson stamps for the named
        # pattern, drawn from a derived-but-stable stream so the prompt
        # draws above stay byte-identical to the poisson trace.
        arr = arrival_steps(pattern, np.random.RandomState(seed ^ 0x51A0),
                            n, rate)
        for r, a in zip(reqs, arr):
            r.arrival_step = int(a)
    elif scenario == "multi_stream":
        for i, r in enumerate(reqs):
            r.arrival_step = (i // query_size) * query_interval
    if slo_classes:
        classes = [get_class(name) for name in slo_classes]
        for i, r in enumerate(reqs):
            r.slo = classes[i % len(classes)]
    return reqs


# --------------------------------------------------------------------------- #
# Drivers: feed a trace to an Engine, return its ServeReport.
# --------------------------------------------------------------------------- #
def run_offline(engine, requests) -> ServeReport:
    """Offline scenario: the whole workload is available at step 0;
    measures batched throughput."""
    for r in requests:
        r.arrival_step = 0
        engine.submit(r)
    return engine.run()


def run_server(engine, requests) -> ServeReport:
    """Server scenario: requests join at their own ``arrival_step``
    while earlier ones are mid-decode; measures the latency tail under
    continuous batching."""
    for r in requests:
        engine.submit(r)
    return engine.run()


def run_single_stream(engine, requests) -> ServeReport:
    """SingleStream scenario: issue-on-completion. Each request is
    submitted only after the previous one has fully retired, stamped
    with the engine step at which it was issued — at most one request
    is ever in flight, so mean batch occupancy is <= 1 by construction
    and the report reads as unloaded per-request latency."""
    t0 = time.perf_counter()
    for r in requests:
        r.arrival_step = engine.current_step
        engine.submit(r)
        engine.drain()
    return engine.finalize(t0)


def run_multi_stream(engine, requests) -> ServeReport:
    """MultiStream scenario: the trace carries fixed-size query bursts
    every ``query_interval`` steps (stamped by :func:`make_trace`); the
    driver replays them like the server scenario."""
    for r in requests:
        engine.submit(r)
    return engine.run()


SCENARIO_DRIVERS = {
    "offline": run_offline,
    "server": run_server,
    "single_stream": run_single_stream,
    "multi_stream": run_multi_stream,
}


def scenario_driver(name: str):
    """Driver for an MLPerf-Inference scenario name."""
    try:
        return SCENARIO_DRIVERS[name]
    except KeyError:
        raise ValueError(
            f"unknown serve scenario {name!r}; "
            f"known: {sorted(SCENARIO_DRIVERS)}"
        ) from None
