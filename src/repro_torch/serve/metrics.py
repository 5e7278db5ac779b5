"""Serving metrics (``repro.serve.metrics``): throughput, per-token
latency percentiles and TTFT, the prefix-cache and speculative-decoding
counters, and SLO accounting (violations, goodput, per-class
breakdown), MLPerf-Inference style."""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.serve import slo as slo_mod


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

    requests: List[Any]          # FINISHED Request objects
    steps: List[StepTrace]
    elapsed_s: float
    preemptions: int = 0         # pool-pressure evictions
    # -- cross-request prefix cache (serve.prefix) ---------------------- #
    prefix_hit_rate: Optional[float] = None  # skipped / total prefill toks
    pages_shared: int = 0        # cached pages mapped into admitted slots
    prefill_tokens_skipped: int = 0  # prompt tokens served from cache
    cow_copies: int = 0          # shared pages privatized before a write
    # -- speculative decoding (serve.speculative) ----------------------- #
    spec_accept_rate: Optional[float] = None  # accepted / proposed drafts
    draft_tokens: int = 0        # draft tokens proposed across the run
    draft_accepted: int = 0      # of which the verify pass accepted

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

    # -- SLO accounting (serve.slo; MLPerf Server scenario + goodput) --- #
    def _by_class(self) -> Dict[str, List[Any]]:
        by_class: Dict[str, List[Any]] = {}
        for r in self.requests:
            name = r.slo.name if getattr(r, "slo", None) else "best-effort"
            by_class.setdefault(name, []).append(r)
        return by_class

    @property
    def slo_violations(self) -> int:
        """Finished requests that missed a budget of their class (TTFT
        or end-to-end, in engine steps); untagged never violate."""
        return sum(not slo_mod.met_slo(r) for r in self.requests)

    @property
    def slo_goodput(self) -> float:
        """Fraction of requests that met every budget they carried."""
        if not self.requests:
            return 1.0
        return 1.0 - self.slo_violations / len(self.requests)

    @property
    def goodput(self) -> float:
        """Per-class goodputs weighted by each class's request count."""
        by_class = self._by_class()
        total = sum(len(rs) for rs in by_class.values())
        if not total:
            return 1.0
        weighted = sum(
            (1.0 - sum(not slo_mod.met_slo(r) for r in rs) / len(rs))
            * len(rs)
            for rs in by_class.values())
        return weighted / total

    def per_class(self) -> Dict[str, Dict[str, Any]]:
        """Per-SLO-class breakdown: request count, end-to-end and TTFT
        p50/p99 (wall ms), budget violations and class goodput; untagged
        requests are grouped under ``"best-effort"``."""
        out = {}
        for name, rs in self._by_class().items():
            lats = [r.latency_s for r in rs if r.latency_s is not None]
            ttfts = [r.ttft_s for r in rs if r.ttft_s is not None]
            bad = sum(not slo_mod.met_slo(r) for r in rs)
            out[name] = {
                "requests": len(rs),
                "p50_ms": round(percentile(lats, 50) * 1e3, 3),
                "p99_ms": round(percentile(lats, 99) * 1e3, 3),
                "ttft_p50_ms": round(percentile(ttfts, 50) * 1e3, 3),
                "ttft_p99_ms": round(percentile(ttfts, 99) * 1e3, 3),
                "violations": bad,
                "goodput": round(1.0 - bad / max(len(rs), 1), 4),
            }
        return out

    def summary(self) -> Dict[str, Any]:
        p50, p99 = self.percentiles_ms()
        ttfts = [r.ttft_s for r in self.requests if r.ttft_s is not None]
        decode_steps = [s for s in self.steps if s.kind == "decode"]
        utils = [s.pool_util for s in self.steps if s.pool_util is not None]
        extra = {}
        if utils:
            extra = {"pool_util_mean": round(sum(utils) / len(utils), 4),
                     "pool_util_peak": round(max(utils), 4)}
        if self.prefix_hit_rate is not None:
            extra.update(
                prefix_hit_rate=round(self.prefix_hit_rate, 4),
                pages_shared=self.pages_shared,
                prefill_tokens_skipped=self.prefill_tokens_skipped,
                cow_copies=self.cow_copies,
            )
        if self.spec_accept_rate is not None:
            extra.update(
                spec_accept_rate=round(self.spec_accept_rate, 4),
                draft_tokens=self.draft_tokens,
            )
        if any(getattr(r, "slo", None) is not None for r in self.requests):
            extra.update(
                goodput=round(self.goodput, 4),
                slo_goodput=round(self.slo_goodput, 4),
                slo_violations=self.slo_violations,
            )
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
