"""Prefix-affinity request router: consistent hashing over replicas.

The fleet's data-parallel replicas each own a private paged KV pool and
prefix cache — a template's pages are only warm on the replica
that served it before. The router therefore consistent-hashes every
*templated* request's prefix-template key (``Request.template``, the
template token tuple itself) onto a hash ring of replica ids: the same
template always lands on the same replica while membership is stable,
and when a replica joins or leaves only the ~K/N keys whose ring arc it
owned move (classic consistent hashing; the rest of the fleet's caches
stay hot). Untemplated traffic has no cache locality to protect and
falls back to least-loaded placement.

Everything here is host-side and deterministic: ring points
come from md5 (stable across processes, unlike Python's salted
``hash``), and ties in least-loaded placement break by replica id.
"""
from __future__ import annotations

import bisect
import hashlib
from typing import Any, Dict, List, Optional, Sequence, Tuple

ROUTING_POLICIES = ("prefix", "least_loaded")


def stable_hash(key: Any) -> int:
    """64-bit ring position for any repr-stable key (md5, not Python's
    per-process-salted ``hash``)."""
    digest = hashlib.md5(repr(key).encode()).digest()
    return int.from_bytes(digest[:8], "big")


class HashRing:
    """Consistent-hash ring: node -> ``vnodes`` points on a 64-bit
    circle; a key routes to the first point clockwise of its hash.
    Adding/removing one node moves only the keys on the arcs that node's
    points own (~K/N of them) — every other key keeps its node."""

    def __init__(self, vnodes: int = 32):
        if vnodes < 1:
            raise ValueError("vnodes must be >= 1")
        self.vnodes = vnodes
        self._points: List[Tuple[int, Any]] = []  # sorted (position, node)
        self._nodes: set = set()

    def __contains__(self, node: Any) -> bool:
        return node in self._nodes

    def __len__(self) -> int:
        return len(self._nodes)

    @property
    def nodes(self) -> list:
        return sorted(self._nodes)

    def add(self, node: Any) -> None:
        if node in self._nodes:
            return
        self._nodes.add(node)
        for v in range(self.vnodes):
            bisect.insort(self._points, (stable_hash((node, v)), node))

    def remove(self, node: Any) -> None:
        if node not in self._nodes:
            return
        self._nodes.discard(node)
        self._points = [p for p in self._points if p[1] != node]

    def lookup(self, key: Any) -> Any:
        """Node owning ``key``'s ring position (first point clockwise)."""
        if not self._points:
            raise LookupError("hash ring is empty")
        h = stable_hash(key)
        i = bisect.bisect_right(self._points, (h, object()))
        if i == len(self._points):  # wrap past the top of the circle
            i = 0
        return self._points[i][1]


class Router:
    """Spread requests over replicas, keeping prefix caches hot.

    ``route(req, eligible)`` picks a replica id out of ``eligible`` (a
    ``{replica_id: load}`` mapping of replicas currently accepting
    work):

    * policy ``"prefix"``: templated requests go to
      ``ring.lookup(req.template)``; untemplated requests (and templated
      ones whose ring owner is not currently eligible — e.g. mid
      kill-detection race) fall back to least-loaded;
    * policy ``"least_loaded"``: everything goes to the eligible replica
      with the fewest outstanding requests (ties break by id).

    The router also keeps the fleet's affinity telemetry: a *hit* is a
    routed request whose chosen replica already served its template key
    before — the fraction of warm-cache placements. The first request
    of a template is always a cold miss, and a kill moves the template's
    arc to a survivor (one more miss, then warm again).
    """

    def __init__(self, policy: str = "prefix", vnodes: int = 32):
        if policy not in ROUTING_POLICIES:
            raise ValueError(
                f"routing policy must be one of {ROUTING_POLICIES}, got "
                f"{policy!r}")
        self.policy = policy
        self.ring = HashRing(vnodes)
        self._last_home: Dict[Any, Any] = {}  # template key -> last replica
        self.routed_affinity = 0   # placed via the ring
        self.routed_fallback = 0   # placed least-loaded
        self.hits = 0              # placed on a warm replica

    # -- membership (the fleet syncs this with replica health) ---------- #
    def add_replica(self, rid: Any) -> None:
        self.ring.add(rid)

    def remove_replica(self, rid: Any) -> None:
        self.ring.remove(rid)

    # ------------------------------------------------------------------ #
    @staticmethod
    def _least_loaded(eligible: Dict[Any, int]) -> Any:
        return min(eligible.items(), key=lambda kv: (kv[1], kv[0]))[0]

    def route(self, req: Any, eligible: Dict[Any, int]) -> Any:
        if not eligible:
            raise LookupError("no eligible replica to route to")
        key = getattr(req, "template", None)
        rid = None
        if self.policy == "prefix" and key is not None and len(self.ring):
            owner = self.ring.lookup(key)
            if owner in eligible:
                rid = owner
                self.routed_affinity += 1
        if rid is None:
            rid = self._least_loaded(eligible)
            self.routed_fallback += 1
        if key is not None:
            if self._last_home.get(key) == rid:
                self.hits += 1
            self._last_home[key] = rid
        return rid

    @property
    def hit_rate(self) -> float:
        """Warm-cache placements / routed requests (0.0 before any)."""
        total = self.routed_affinity + self.routed_fallback
        return self.hits / total if total else 0.0

    def moved_keys(self, keys: Sequence[Any],
                   without: Optional[Any] = None) -> int:
        """How many of ``keys`` would change owner if ``without`` left
        the ring — the ~K/N stability diagnostic the property tests pin."""
        before = {k: self.ring.lookup(k) for k in keys}
        if without is not None:
            self.ring.remove(without)
            after = {k: self.ring.lookup(k) for k in keys}
            self.ring.add(without)
            return sum(before[k] != after[k] for k in keys)
        return 0
