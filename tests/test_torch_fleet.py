"""The port's fleet (``repro_torch.fleet``) against ``repro.fleet``.

- The router and the chaos plan agree with the reference's on the same
  inputs: ``stable_hash`` and ``HashRing.lookup`` over 200 seeded keys,
  the keys moved on a join and on a leave, ``Router.route`` choices and
  hit accounting across a failover, ``ChaosPlan.from_spec`` victims for
  seeds 0-3.
- Real engines: reduced gemma-7b (fp32, 2 layers, one numpy tree) served
  by the port's ``Fleet`` of two replicas and by the reference's on the
  same templated server stream with the prefix cache: with no chaos,
  with a kill at steps 2 and 5, and with a stall past and within the
  heartbeat timeout. Each request is served by the same replica, the
  fleets see the same kills and evictions, every request's greedy tokens
  are bitwise equal (and equal one engine's), and ``FleetReport.
  summary()``'s counts (all but the times) are the reference's.
- The behaviour the reference's own tests pin without a model
  (``tests/test_fleet.py``): the ring's contracts, the router's
  policies, the chaos plan, the replica state machine, ``reset_for_
  retry``, kill/stall failover with request-id conservation, duplicate
  submits, no survivors, ``FleetConfig`` validation, the report and
  ``ServeReport.goodput``, over a host-side engine stand-in.
"""
import dataclasses
import itertools
import time

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro import fleet as jfleet  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.dist import split_tree  # noqa: E402
from repro.serve import Engine as JaxEngine  # noqa: E402
from repro.serve import ServeConfig as JaxServeConfig  # noqa: E402
from repro.serve.engine import synthetic_requests as jax_requests  # noqa: E402
from repro.train.steps import ModelAPI  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.fleet import (  # noqa: E402
    CHAOS_MODES,
    ROUTING_POLICIES,
    ChaosEvent,
    ChaosPlan,
    Fleet,
    FleetConfig,
    HashRing,
    Replica,
    ReplicaState,
    Router,
    reset_for_retry,
)
from repro_torch.fleet.router import stable_hash  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.serve.engine import (  # noqa: E402
    Engine,
    ServeConfig,
    synthetic_requests,
)
from repro_torch.serve.metrics import ServeReport  # noqa: E402
from repro_torch.serve.request import Request, RequestState  # noqa: E402
from repro_torch.serve.scenarios import run_server  # noqa: E402
from repro_torch.serve.slo import get_class  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread while this file runs (the suite runs several
    workers on the machine's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _keys(n=200, seed=0):
    rng = np.random.RandomState(seed)
    return [tuple(rng.randint(0, 1000, size=4).tolist()) for _ in range(n)]


# --------------------------------------------------------------------------- #
# Router and chaos against the reference's.
# --------------------------------------------------------------------------- #
def test_ring_matches_reference():
    keys = _keys()
    assert [stable_hash(k) for k in keys] == \
        [jfleet.router.stable_hash(k) for k in keys]
    mine, theirs = HashRing(vnodes=32), jfleet.HashRing(vnodes=32)
    for n in range(4):
        mine.add(n)
        theirs.add(n)
    assert [mine.lookup(k) for k in keys] == [theirs.lookup(k) for k in keys]
    assert mine.nodes == theirs.nodes


@pytest.mark.parametrize("change", ["join", "leave"])
def test_moved_keys_match_reference(change):
    keys = _keys(400, seed=1)
    mine, theirs = Router("prefix"), jfleet.Router("prefix")
    for n in range(3):
        mine.add_replica(n)
        theirs.add_replica(n)
    if change == "leave":
        assert mine.moved_keys(keys, without=1) == \
            theirs.moved_keys(keys, without=1)
        return
    before = [mine.ring.lookup(k) for k in keys]
    mine.add_replica(3)
    theirs.add_replica(3)
    after = [mine.ring.lookup(k) for k in keys]
    assert after == [theirs.ring.lookup(k) for k in keys]
    moved = sum(a != b for a, b in zip(before, after))
    assert moved == sum(a == 3 for a in after) > 0


def test_router_choices_and_hits_across_failover_match_reference():
    rng = np.random.RandomState(2)
    templates = [tuple(rng.randint(0, 50, size=3).tolist()) for _ in range(5)]
    mine, theirs = Router("prefix"), jfleet.Router("prefix")
    for n in range(3):
        mine.add_replica(n)
        theirs.add_replica(n)
    eligible = {0: 0, 1: 0, 2: 0}
    got, want = [], []
    for step in range(60):
        if step == 20:  # a failover: replica 1 leaves
            mine.remove_replica(1)
            theirs.remove_replica(1)
            eligible.pop(1)
        key = None if step % 7 == 0 else templates[rng.randint(5)]
        r = Request(prompt=[1], max_new_tokens=1, template=key)
        got.append(mine.route(r, eligible))
        want.append(theirs.route(r, eligible))
        eligible[got[-1]] += 1
    assert got == want
    assert (mine.hits, mine.routed_affinity, mine.routed_fallback,
            mine.hit_rate) == (theirs.hits, theirs.routed_affinity,
                               theirs.routed_fallback, theirs.hit_rate)


@pytest.mark.parametrize("seed", range(4))
def test_chaos_victims_match_reference(seed):
    for kind in ("kill", "stall"):
        mine = ChaosPlan.from_spec(kind, chaos_step=3, stall_steps=5,
                                   seed=seed)
        theirs = jfleet.ChaosPlan.from_spec(kind, chaos_step=3,
                                            stall_steps=5, seed=seed)
        [a], [b] = mine.pop_due(3), theirs.pop_due(3)
        assert (a.step, a.kind, a.replica, a.stall_steps) == \
            (b.step, b.kind, b.replica, b.stall_steps)
        alive = [0, 1, 2, 3]
        assert [mine.choose_victim(a, alive) for _ in range(6)] == \
            [theirs.choose_victim(b, alive) for _ in range(6)]
    assert CHAOS_MODES == jfleet.CHAOS_MODES
    assert ROUTING_POLICIES == jfleet.ROUTING_POLICIES


# --------------------------------------------------------------------------- #
# Real engines against the reference's fleet.
# --------------------------------------------------------------------------- #
FP32 = dict(dtype="float32", kv_cache_dtype="float32", n_layers=2)
KNOBS = dict(max_batch=2, max_len=20, page_size=4, prefill_chunk=4,
             prefix_cache=True)
CHAOS = {
    "none": dict(),
    "kill_2": dict(chaos="kill", chaos_step=2),
    "kill_5": dict(chaos="kill", chaos_step=5),
    "stall_past_timeout": dict(chaos="stall", chaos_step=2, stall_steps=12),
    "stall_within_timeout": dict(chaos="stall", chaos_step=2, stall_steps=3),
}


def _workload(make, cfg):
    reqs = make(cfg, n=6, tokens=6, prompt_len=9, scenario="server", seed=0,
                arrival_rate=0.75, shared_prefix_len=6, n_templates=2)
    for i, r in enumerate(reqs):
        r.id = i
    return reqs


@pytest.fixture(scope="module")
def engines():
    ref_cfg = dataclasses.replace(jax_get_config("gemma-7b").reduced(), **FP32)
    cfg = dataclasses.replace(get_config("gemma-7b").reduced(), **FP32)
    vals, _ = split_tree(ModelAPI(ref_cfg).init(ref_cfg,
                                                jax.random.PRNGKey(0)))
    params = lm.params_from_numpy(jax.tree_util.tree_map(np.asarray, vals),
                                  cfg, device="cpu")
    mine = [Engine(cfg, params, ServeConfig(kv_layout="paged", **KNOBS),
                   device="cpu") for _ in range(2)]
    theirs = [JaxEngine(ref_cfg, vals, None,
                        JaxServeConfig(kv_layout="paged", **KNOBS))
              for _ in range(2)]
    one = run_server(mine[0], _workload(synthetic_requests, cfg))
    solo = {r.id: r.tokens for r in one.requests}
    return cfg, ref_cfg, mine, theirs, solo


def _served(report):
    """{request id: (replica, tokens)}."""
    return {r.id: (rid, list(r.tokens))
            for rid, rep in report.replica_reports.items()
            for r in rep.requests}


TIMES = ("elapsed_s", "tokens_per_s", "p50_token_ms", "p99_token_ms",
         "ttft_p50_ms")


@pytest.mark.parametrize("name", list(CHAOS))
def test_fleet_matches_reference(engines, name):
    cfg, ref_cfg, mine, theirs, solo = engines
    c = dict(CHAOS[name])
    chaos = c.pop("chaos", "")
    fcfg = dict(routing="prefix", heartbeat_timeout=4)
    got = Fleet(mine, FleetConfig(**fcfg),
                ChaosPlan.from_spec(chaos, seed=0, **c)).run(
        _workload(synthetic_requests, cfg))
    want = jfleet.Fleet(theirs, jfleet.FleetConfig(**fcfg),
                        jfleet.ChaosPlan.from_spec(chaos, seed=0, **c)).run(
        _workload(jax_requests, ref_cfg))
    assert _served(got) == _served(want)
    assert {i: t for i, (_, t) in _served(got).items()} == solo
    assert got.replica_states == want.replica_states
    assert (got.kills, got.stalls, got.reroutes, got.lost_tokens) == \
        (want.kills, want.stalls, want.reroutes, want.lost_tokens)
    mine_s, theirs_s = got.summary(), want.summary()
    for k in TIMES:
        mine_s.pop(k), theirs_s.pop(k)
    assert mine_s == theirs_s
    if chaos == "kill" or name == "stall_past_timeout":
        assert got.kills == 1 and "dead" in got.replica_states.values()
        assert got.reroutes > 0
        assert (got.goodput < 1.0) == (got.lost_tokens > 0)
        assert got.lost_tokens > 0 or name != "kill_5"
    else:
        assert got.kills == 0 and got.goodput == 1.0
    assert got.routed_affinity > 0


# --------------------------------------------------------------------------- #
# The reference's model-free behaviour (``tests/test_fleet.py``), over a
# host-side engine stand-in: one token a step a running request, a pure
# function of (prompt, position), so token identity holds by construction.
# --------------------------------------------------------------------------- #
def test_stable_hash_is_process_stable_and_spread():
    assert stable_hash(("a", 1)) == stable_hash(("a", 1))
    assert len({stable_hash(k) for k in _keys(200)}) == 200


def test_hash_ring_lookup_deterministic_and_member():
    ring = HashRing(vnodes=32)
    for n in range(4):
        ring.add(n)
    keys = _keys()
    first = [ring.lookup(k) for k in keys]
    assert first == [ring.lookup(k) for k in keys]
    assert set(first) == {0, 1, 2, 3}


@pytest.mark.parametrize("n_nodes,seed", [(n, s) for n in range(2, 7)
                                          for s in (0, 3)])
def test_hash_ring_leave_moves_only_departed_keys(n_nodes, seed):
    ring = HashRing(vnodes=32)
    for n in range(n_nodes):
        ring.add(n)
    keys = _keys(150, seed=seed)
    before = {k: ring.lookup(k) for k in keys}
    gone = seed % n_nodes
    ring.remove(gone)
    after = {k: ring.lookup(k) for k in keys}
    for k in keys:
        if before[k] != gone:
            assert after[k] == before[k], "a surviving node's key moved"
        else:
            assert after[k] != gone
    ring.add(gone)
    assert {k: ring.lookup(k) for k in keys} == before


def test_hash_ring_join_leave_moves_about_k_over_n():
    router = Router("prefix", vnodes=32)
    for n in range(4):
        router.add_replica(n)
    keys = _keys(400)
    moved = router.moved_keys(keys, without=2)
    owned = sum(router.ring.lookup(k) == 2 for k in keys)
    assert moved == owned
    assert 0.05 * len(keys) <= moved <= 0.6 * len(keys)
    assert router.ring.nodes == [0, 1, 2, 3]


def _treq(template):
    return Request(prompt=[1, 2, 3], max_new_tokens=2, template=template)


def test_router_policies():
    router = Router("prefix")
    for n in range(3):
        router.add_replica(n)
    key = (7, 8, 9)
    homes = {router.route(_treq(key), {0: 0, 1: 0, 2: 0}) for _ in range(5)}
    assert homes == {router.ring.lookup(key)}
    fallback = Router("prefix")
    for n in range(3):
        fallback.add_replica(n)
    assert fallback.route(_treq(None), {0: 4, 1: 1, 2: 3}) == 1
    assert fallback.route(_treq(None), {2: 1, 0: 1}) == 0  # ties by id
    assert (fallback.routed_fallback, fallback.routed_affinity,
            fallback.hits) == (2, 0, 0)
    least = Router("least_loaded")
    for n in range(3):
        least.add_replica(n)
    assert least.route(_treq((1, 2)), {0: 5, 1: 0, 2: 5}) == 1
    assert least.routed_affinity == 0 and least.routed_fallback == 1


def test_router_hit_accounting_across_failover():
    router = Router("prefix")
    for n in range(2):
        router.add_replica(n)
    key = (3, 1, 4)
    owner = router.route(_treq(key), {0: 0, 1: 0})
    assert router.hits == 0
    assert router.route(_treq(key), {0: 0, 1: 0}) == owner
    assert router.hits == 1
    router.remove_replica(owner)
    survivor = 1 - owner
    assert router.route(_treq(key), {survivor: 0}) == survivor
    assert router.hits == 1, "post-failover placement is a cold miss"
    assert router.route(_treq(key), {survivor: 0}) == survivor
    assert router.hits == 2 and router.hit_rate == pytest.approx(2 / 4)


def _raises(exc, fn, match=None):
    with pytest.raises(exc, match=match):
        fn()


@pytest.mark.parametrize("bad", [
    (ValueError, lambda: HashRing(vnodes=0)),
    (LookupError, lambda: HashRing().lookup("anything")),
    (ValueError, lambda: Router("round_robin")),
    (LookupError, lambda: Router().route(_treq(None), {})),
    (ValueError, lambda: ChaosEvent(step=0, kind="explode")),
    (ValueError, lambda: ChaosEvent(step=-1, kind="kill")),
    (ValueError, lambda: ChaosEvent(step=0, kind="stall", stall_steps=0)),
    (ValueError, lambda: ChaosPlan.from_spec("explode")),
    (ValueError, lambda: FleetConfig(routing="nearest")),
    (ValueError, lambda: FleetConfig(heartbeat_timeout=0)),
    (ValueError, lambda: Fleet([])),
], ids=["vnodes", "empty_ring", "policy", "no_eligible", "kind", "step",
        "stall_steps", "spec", "routing", "timeout", "no_engine"])
def test_validation(bad):
    _raises(*bad)


def test_chaos_plan_pop_due_once_and_in_order():
    plan = ChaosPlan([ChaosEvent(step=5, kind="kill"),
                      ChaosEvent(step=2, kind="stall")])
    assert len(plan) == 2
    assert [e.step for e in plan.pop_due(4)] == [2]
    assert [e.step for e in plan.pop_due(9)] == [5]
    assert plan.pop_due(9) == []
    assert [e.step for e in plan.fired] == [2, 5]
    assert len(ChaosPlan.from_spec("")) == 0
    [ev] = ChaosPlan.from_spec("stall", chaos_step=3,
                               stall_steps=7).pop_due(3)
    assert (ev.kind, ev.step, ev.stall_steps) == ("stall", 3, 7)


def test_chaos_victim_seeded_and_pinned():
    ev = ChaosEvent(step=0, kind="kill")
    picks = [ChaosPlan(seed=3).choose_victim(ev, [0, 1, 2]) for _ in range(3)]
    assert len(set(picks)) == 1 and picks[0] in (0, 1, 2)
    pinned = ChaosEvent(step=0, kind="kill", replica=1)
    plan = ChaosPlan()
    assert plan.choose_victim(pinned, [0, 1]) == 1
    assert plan.choose_victim(pinned, [0]) is None, "pinned victim dead"
    assert plan.choose_victim(ev, []) is None


class _FakeSched:
    def __init__(self, eng):
        self._eng = eng

    @property
    def has_work(self):
        return bool(self._eng._running)


class FakeEngine:
    """The engine surface a replica reads: submit, step, current_step,
    finished, finalize, ``_arrivals`` and ``sched.has_work``."""

    def __init__(self, max_batch=2):
        self.max_batch = max_batch
        self._arrivals = []
        self._running = []
        self._finished = []
        self._step_idx = 0
        self._seq = itertools.count()
        self.sched = _FakeSched(self)

    @property
    def current_step(self):
        return self._step_idx

    @property
    def finished(self):
        return self._finished

    def submit(self, req):
        self._arrivals.append((req.arrival_step, next(self._seq), req))
        self._arrivals.sort(key=lambda t: t[:2])

    @staticmethod
    def _tok(req):
        return (sum(req.prompt) * 7 + 31 * len(req.tokens)) % 97

    def step(self):
        now = self._step_idx
        while (self._arrivals and self._arrivals[0][0] <= now
               and len(self._running) < self.max_batch):
            _, _, req = self._arrivals.pop(0)
            req.state = RequestState.RUNNING
            req.sched_seq = next(self._seq)
            req.s_arrival = req.s_arrival if req.s_arrival is not None else now
            req.t_arrival = req.t_arrival or time.perf_counter()
            self._running.append(req)
        for req in list(self._running):
            if not req.tokens:
                req.s_first_token = now
                req.t_first_token = time.perf_counter()
            req.tokens.append(self._tok(req))
            if len(req.tokens) >= req.max_new_tokens:
                req.state = RequestState.FINISHED
                req.s_done, req.t_done = now, time.perf_counter()
                self._running.remove(req)
                self._finished.append(req)
        self._step_idx += 1

    def finalize(self, t0):
        report = ServeReport(requests=list(self._finished), steps=[],
                             elapsed_s=time.perf_counter() - t0)
        self._arrivals, self._running, self._finished = [], [], []
        self._step_idx = 0
        return report


def _fake_workload(n=8, *, templated=True):
    return [Request(prompt=[3 + i, 2 * i + 1], max_new_tokens=3,
                    arrival_step=i // 2,
                    template=(11, 13) if i % 2 else (5, 7) if templated
                    else None)
            for i in range(n)]


def _tokens_by_position(report):
    return [r.tokens for r in sorted(report.merged.requests,
                                     key=lambda r: r.id)]


def test_replica_state_machine_starting_ready_draining_dead():
    rep = Replica(0, FakeEngine())
    assert rep.state is ReplicaState.STARTING and rep.accepting
    req = Request(prompt=[1, 2], max_new_tokens=2)
    rep.submit(req)
    assert rep.load == 1
    rep.step(0)
    assert rep.state is ReplicaState.READY and rep.last_beat == 0
    rep.drain()
    assert rep.state is ReplicaState.DRAINING and not rep.accepting
    with pytest.raises(RuntimeError):
        rep.submit(Request(prompt=[9], max_new_tokens=1))
    for fs in range(1, 5):
        rep.step(fs)
    assert rep.state is ReplicaState.DEAD
    assert rep.load == 0, "finished work must be harvested"
    assert req.state is RequestState.FINISHED


def test_replica_stall_stops_heartbeat_then_resumes_identical():
    rep = Replica(0, FakeEngine())
    rep.submit(Request(prompt=[4, 5], max_new_tokens=3))
    rep.step(0)
    rep.stall(2)
    assert rep.stalled
    rep.step(1)
    rep.step(2)
    assert rep.last_beat == 0 and rep.heartbeat_age(2) == 2
    assert rep.engine.current_step == 1, "stalled engine must not step"
    rep.step(3)
    assert rep.last_beat == 3 and not rep.stalled


def test_replica_kill_returns_orphans_in_admission_order():
    rep = Replica(0, FakeEngine(max_batch=1))
    reqs = [Request(prompt=[i + 1], max_new_tokens=5) for i in range(3)]
    for r in reqs:
        rep.submit(r)
    rep.step(0)
    orphans = rep.kill()
    assert rep.state is ReplicaState.DEAD and rep.load == 0
    assert [o.id for o in orphans] == [r.id for r in reqs]
    assert orphans[0].sched_seq is not None, "admitted request first"
    assert rep.kill() == [], "second kill is a no-op"


def test_reset_for_retry_strips_runtime_state_keeps_identity():
    req = Request(prompt=[1, 2, 3], max_new_tokens=4)
    req.tokens = [10, 11]
    req.state, req.slot, req.sched_seq = RequestState.RUNNING, 2, 5
    req.s_arrival = req.s_first_token = 1
    req.t_arrival = req.t_first_token = 0.5
    rid = req.id
    assert reset_for_retry(req) == 2
    assert req.id == rid and req.prompt == [1, 2, 3]
    assert req.tokens == [] and req.state is RequestState.WAITING
    assert req.slot is None and req.sched_seq is None
    assert req.s_arrival is None and req.t_first_token is None


@pytest.mark.parametrize("chaos_step,victim",
                         [(s, v) for s in range(7) for v in range(3)])
def test_fleet_kill_reroute_never_drops_or_duplicates(chaos_step, victim):
    want = _tokens_by_position(Fleet([FakeEngine()]).run(_fake_workload()))
    plan = ChaosPlan([ChaosEvent(step=chaos_step, kind="kill",
                                 replica=victim)], seed=0)
    report = Fleet([FakeEngine() for _ in range(3)],
                   FleetConfig(routing="prefix"), chaos=plan).run(
        _fake_workload())
    assert report.requests == 8
    assert _tokens_by_position(report) == want
    assert report.kills == 1 and report.replica_states[victim] == "dead"
    assert report.lost_tokens == report.reroutes == 0 or report.goodput < 1.0
    assert report.goodput == pytest.approx(
        report.tokens_generated
        / (report.tokens_generated + report.lost_tokens))


def test_fleet_duplicate_submit_rejected():
    fleet = Fleet([FakeEngine()])
    req = Request(prompt=[1], max_new_tokens=1)
    fleet.submit(req)
    with pytest.raises(ValueError):
        fleet.submit(req)


def test_fleet_with_no_survivors_fails_loudly():
    plan = ChaosPlan([ChaosEvent(step=0, kind="kill", replica=0)])
    with pytest.raises(RuntimeError, match="no surviving replica"):
        Fleet([FakeEngine()], chaos=plan).run(_fake_workload(4))


def test_fleet_max_steps_backstop():
    with pytest.raises(RuntimeError, match="max_steps"):
        Fleet([FakeEngine()], FleetConfig(max_steps=2)).run(_fake_workload())


@pytest.mark.parametrize("stall_steps,timeout,evicted", [(2, 4, False),
                                                        (30, 2, True)])
def test_fleet_stall(stall_steps, timeout, evicted):
    """A stall inside the heartbeat budget is absorbed (no kill, no lost
    work); one past it is evicted by the monitor and its work drains to
    the survivor. Outputs equal the healthy run's either way."""
    want = _tokens_by_position(Fleet([FakeEngine()]).run(_fake_workload()))
    plan = ChaosPlan([ChaosEvent(step=1 if evicted else 2, kind="stall",
                                 replica=0, stall_steps=stall_steps)])
    report = Fleet([FakeEngine(), FakeEngine()],
                   FleetConfig(heartbeat_timeout=timeout), chaos=plan).run(
        _fake_workload())
    assert report.requests == 8 and report.stalls == 1
    assert _tokens_by_position(report) == want
    if evicted:
        assert report.kills == 1 and report.replica_states[0] == "dead"
    else:
        assert (report.kills, report.lost_tokens, report.goodput) == \
            (0, 0, 1.0)
        assert set(report.replica_states.values()) <= {"ready", "starting"}


def test_fleet_report_merges_and_summarizes():
    report = Fleet([FakeEngine(), FakeEngine()]).run(_fake_workload())
    assert len(report.merged.requests) == report.requests == 8
    assert report.tokens_generated == report.merged.tokens_generated == 24
    s = report.summary()
    assert s["replicas"] == 2 and s["replicas_alive"] == 2
    assert s["goodput"] == 1.0 and s["lost_tokens"] == 0
    assert 0.0 <= s["routing_hit_rate"] <= 1.0
    assert "replicas" in report.format() and "goodput" in report.format()


def _finished_req(slo_cls, *, violate=False):
    req = Request(prompt=[1, 2, 3], max_new_tokens=2, slo=slo_cls)
    req.tokens, req.state = [5, 6], RequestState.FINISHED
    req.s_arrival, req.s_first_token = 0, 1
    budget = slo_cls.latency_steps if slo_cls else None
    req.s_done = (budget + 5) if (violate and budget) else 2
    req.t_arrival, req.t_first_token, req.t_done = 0.0, 0.01, 0.02
    return req


def test_serve_report_goodput_weights_classes_by_request_count():
    interactive, batch = get_class("interactive"), get_class("batch")
    reqs = ([_finished_req(interactive) for _ in range(2)]
            + [_finished_req(interactive, violate=True)]
            + [_finished_req(batch) for _ in range(2)])
    report = ServeReport(requests=reqs, steps=[], elapsed_s=1.0)
    assert report.goodput == pytest.approx(0.8)
    assert report.goodput == pytest.approx(report.slo_goodput)
    pc = report.per_class()
    assert pc["interactive"]["goodput"] == pytest.approx(2 / 3, abs=1e-4)
    assert pc["batch"]["goodput"] == 1.0
    assert report.summary()["goodput"] == pytest.approx(0.8)
    plain = ServeReport(requests=[_finished_req(None) for _ in range(3)],
                        steps=[], elapsed_s=1.0)
    assert plain.goodput == 1.0 and "goodput" not in plain.summary()
    assert ServeReport(requests=[], steps=[], elapsed_s=0.0).goodput == 1.0
