"""Serving metrics: throughput and latency percentiles
(``repro.serve.metrics``)."""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple


def percentile(xs: List[float], q: float) -> float:
    """Nearest-rank percentile (q in [0,100]); 0.0 on empty input."""
    if not xs:
        return 0.0
    s = sorted(xs)
    rank = max(1, -(-len(s) * q // 100))  # ceil(n*q/100), >= 1
    return s[min(int(rank), len(s)) - 1]


@dataclasses.dataclass
class StepTrace:
    """One engine step: 'mixed' while any row chunk-prefills, else
    'decode'; ``pool_util`` is the page pool's use after the step."""

    kind: str
    wall_s: float
    n_tokens: int
    pool_util: Optional[float] = None


@dataclasses.dataclass
class ServeReport:
    """Aggregated outcome of one engine run."""

    requests: List[Any]
    steps: List[StepTrace]
    elapsed_s: float
    preemptions: int = 0

    @property
    def tokens_generated(self) -> int:
        return sum(len(r.tokens) for r in self.requests)

    @property
    def tokens_per_s(self) -> float:
        return self.tokens_generated / max(self.elapsed_s, 1e-9)

    def token_latencies_s(self) -> List[float]:
        out = []
        for st in self.steps:
            out.extend([st.wall_s] * st.n_tokens)
        return out

    def percentiles_ms(self) -> Tuple[float, float]:
        lats = self.token_latencies_s()
        return (percentile(lats, 50) * 1e3, percentile(lats, 99) * 1e3)

    def summary(self) -> Dict[str, Any]:
        p50, p99 = self.percentiles_ms()
        ttfts = [r.ttft_s for r in self.requests if r.ttft_s is not None]
        decode_steps = [s for s in self.steps if s.kind == "decode"]
        utils = [s.pool_util for s in self.steps if s.pool_util is not None]
        extra = {}
        if utils:
            extra = {"pool_util_mean": round(sum(utils) / len(utils), 4),
                     "pool_util_peak": round(max(utils), 4)}
        return {
            **extra,
            "requests": len(self.requests),
            "tokens": self.tokens_generated,
            "elapsed_s": round(self.elapsed_s, 4),
            "tokens_per_s": round(self.tokens_per_s, 2),
            "p50_token_ms": round(p50, 3),
            "p99_token_ms": round(p99, 3),
            "ttft_p50_ms": round(percentile(ttfts, 50) * 1e3, 3),
            "decode_steps": len(decode_steps),
            "mean_batch_occupancy": round(
                sum(s.n_tokens for s in decode_steps)
                / max(len(decode_steps), 1), 2),
        }

    def format(self) -> str:
        s = self.summary()
        return (
            f"{s['requests']} requests, {s['tokens']} tokens in "
            f"{s['elapsed_s']:.2f}s ({s['tokens_per_s']:.1f} tok/s), "
            f"per-token p50 {s['p50_token_ms']:.1f}ms / "
            f"p99 {s['p99_token_ms']:.1f}ms, "
            f"ttft p50 {s['ttft_p50_ms']:.1f}ms, "
            f"mean occupancy {s['mean_batch_occupancy']:.1f}"
        )
