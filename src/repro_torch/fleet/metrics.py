"""Fleet-wide reporting: per-replica ``ServeReport``s rolled up into
one :class:`FleetReport`.

The fleet metric that matters at scale (ML Fleet Efficiency, arXiv
2502.06982) is *productivity goodput*: the fraction of the work the
fleet actually did that ended up useful. Two things erode it here:

* **SLO misses** — a completed request that blew its class budgets is
  throughput, not goodput. Each replica already reports this as its
  request-weighted ``ServeReport.goodput``.
* **Lost work** — tokens a killed (or stall-evicted) replica had
  already decoded for requests that then drained to survivors and were
  re-decoded from the prompt. The retry keeps outputs token-identical,
  but the first attempt's tokens were real device work that produced
  nothing.

So, with ``T_r`` the useful tokens replica ``r`` delivered and ``L``
the lost tokens across all kills/retries:

    goodput = sum_r(T_r * goodput_r) / (sum_r T_r + L)

which is 1.0 for a healthy untagged fleet and strictly below it the
moment chaos throws work away.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

from repro_torch.serve.metrics import ServeReport


@dataclasses.dataclass
class FleetReport:
    """Aggregated outcome of one fleet run."""

    replica_reports: Dict[int, ServeReport]  # replica id -> its report
    replica_states: Dict[int, str]           # replica id -> final health
    elapsed_s: float
    fleet_steps: int
    kills: int = 0           # replicas killed (chaos or heartbeat timeout)
    stalls: int = 0          # stall faults injected
    reroutes: int = 0        # requests drained to a survivor
    lost_tokens: int = 0     # tokens abandoned on dead replicas
    routed_affinity: int = 0   # requests placed via the hash ring
    routed_fallback: int = 0   # requests placed least-loaded
    routing_hits: int = 0      # requests placed on a warm replica

    # ------------------------------------------------------------------ #
    @property
    def merged(self) -> ServeReport:
        """All replicas' work as one ``ServeReport`` over the fleet
        wall clock — fleet-wide percentiles and per-class tails reuse
        the single-engine metrics code unchanged."""
        reqs = [r for rep in self.replica_reports.values()
                for r in rep.requests]
        steps = [s for rep in self.replica_reports.values()
                 for s in rep.steps]
        return ServeReport(requests=reqs, steps=steps,
                           elapsed_s=self.elapsed_s)

    @property
    def requests(self) -> int:
        return sum(len(r.requests) for r in self.replica_reports.values())

    @property
    def tokens_generated(self) -> int:
        """Useful tokens: those of completed requests, each counted once
        (a rerouted request's abandoned first attempt is in
        ``lost_tokens``, not here)."""
        return sum(r.tokens_generated for r in self.replica_reports.values())

    @property
    def tokens_per_s(self) -> float:
        return self.tokens_generated / max(self.elapsed_s, 1e-9)

    @property
    def goodput(self) -> float:
        """Productivity goodput: SLO-weighted useful tokens over all
        tokens the fleet decoded, lost work included (1.0 when the fleet
        did no work at all)."""
        useful = sum(r.tokens_generated * r.goodput
                     for r in self.replica_reports.values())
        total = self.tokens_generated + self.lost_tokens
        return useful / total if total else 1.0

    @property
    def routing_hit_rate(self) -> float:
        routed = self.routed_affinity + self.routed_fallback
        return self.routing_hits / routed if routed else 0.0

    def per_class(self) -> Dict[str, Dict[str, Any]]:
        """Fleet-wide per-SLO-class tails (merged across replicas)."""
        return self.merged.per_class()

    # ------------------------------------------------------------------ #
    def summary(self) -> Dict[str, Any]:
        m = self.merged.summary()
        alive = sum(s in ("starting", "ready", "draining")
                    for s in self.replica_states.values())
        return {
            "replicas": len(self.replica_reports),
            "replicas_alive": alive,
            "requests": self.requests,
            "tokens": self.tokens_generated,
            "elapsed_s": round(self.elapsed_s, 4),
            "tokens_per_s": round(self.tokens_per_s, 2),
            "goodput": round(self.goodput, 4),
            "lost_tokens": self.lost_tokens,
            "kills": self.kills,
            "stalls": self.stalls,
            "reroutes": self.reroutes,
            "routing_hit_rate": round(self.routing_hit_rate, 4),
            "fleet_steps": self.fleet_steps,
            "p50_token_ms": m["p50_token_ms"],
            "p99_token_ms": m["p99_token_ms"],
            "ttft_p50_ms": m["ttft_p50_ms"],
        }

    def format(self) -> str:
        s = self.summary()
        return (
            f"{s['replicas_alive']}/{s['replicas']} replicas, "
            f"{s['requests']} requests, {s['tokens']} tokens in "
            f"{s['elapsed_s']:.2f}s ({s['tokens_per_s']:.1f} tok/s), "
            f"goodput {s['goodput']:.3f} "
            f"({s['lost_tokens']} tokens lost, {s['kills']} kill(s), "
            f"{s['reroutes']} reroute(s)), "
            f"routing hit-rate {s['routing_hit_rate']:.3f}"
        )
