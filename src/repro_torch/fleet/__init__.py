"""Multi-replica serving, the scale-out layer (the port's copy of
``repro.fleet``: host Python over the port's engine).

One ``serve.Engine`` replica cannot absorb fleet-scale traffic; this
package spreads the load over N data-parallel replicas while keeping
the repo's serving contract:
greedy outputs of every completed request are token-identical to a
single-replica run, even across seeded replica kills and stalls.

    Fleet ---- router.Router ---- consistent hash on the prefix-
      |          (HashRing)       template key + least-loaded fallback
      |
      +------- replica.Replica -- Engine behind a heartbeat/health
      |          (xN)             state machine (STARTING -> READY ->
      |                           DRAINING -> DEAD)
      +------- chaos.ChaosPlan -- seeded kill/stall fault injection
      |
      `------- metrics.FleetReport  per-replica ServeReports rolled up
                                    into fleet tokens/s, per-class
                                    tails and productivity goodput
                                    (arXiv 2502.06982)

``python -m repro_torch.launch.serve --n-replicas N`` drives it.
"""
from repro_torch.fleet.chaos import CHAOS_MODES, ChaosEvent, ChaosPlan
from repro_torch.fleet.fleet import Fleet, FleetConfig
from repro_torch.fleet.metrics import FleetReport
from repro_torch.fleet.replica import Replica, ReplicaState, reset_for_retry
from repro_torch.fleet.router import ROUTING_POLICIES, HashRing, Router

__all__ = [
    "CHAOS_MODES",
    "ChaosEvent",
    "ChaosPlan",
    "Fleet",
    "FleetConfig",
    "FleetReport",
    "HashRing",
    "ROUTING_POLICIES",
    "Replica",
    "ReplicaState",
    "Router",
    "reset_for_retry",
]
