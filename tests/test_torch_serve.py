"""The port's serving engine against ``repro.serve.Engine``: identical
greedy tokens for gemma-7b reduced (fp32, CPU) at pool parity and under
preemption; page-pool and scheduler invariants (the non-prefix cases of
tests/test_serve.py); the CLI."""
import dataclasses
import os
import random
import subprocess
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.dist import split_tree  # noqa: E402
from repro.serve import Engine as JaxEngine  # noqa: E402
from repro.serve import ServeConfig as JaxServeConfig  # noqa: E402
from repro.serve import run_offline as jax_run_offline  # noqa: E402
from repro.serve.engine import synthetic_requests as jax_requests  # noqa: E402
from repro.train.steps import ModelAPI  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.serve.cache import PagePool  # noqa: E402
from repro_torch.serve.engine import (  # noqa: E402
    Engine,
    ServeConfig,
    synthetic_requests,
)
from repro_torch.serve.metrics import percentile  # noqa: E402
from repro_torch.serve.request import Request, RequestState  # noqa: E402
from repro_torch.serve.scenarios import run_offline  # noqa: E402
from repro_torch.serve.scheduler import PagedScheduler, Scheduler  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")
FP32 = dict(dtype="float32", kv_cache_dtype="float32", n_layers=2)


@pytest.fixture(scope="module")
def models():
    ref_cfg = dataclasses.replace(jax_get_config("gemma-7b").reduced(), **FP32)
    cfg = dataclasses.replace(get_config("gemma-7b").reduced(), **FP32)
    vals, _ = split_tree(ModelAPI(ref_cfg).init(ref_cfg,
                                                jax.random.PRNGKey(0)))
    params = lm.params_from_numpy(jax.tree_util.tree_map(np.asarray, vals),
                                  cfg, device="cpu")
    return ref_cfg, vals, cfg, params


# (serve knobs, workload): pool parity, and a sub-parity pool that forces
# preemption (the runs/serve_paged.toml geometry: page 4, chunk 4).
WORKLOADS = {
    "parity": (dict(max_batch=3, max_len=32, page_size=4, prefill_chunk=4),
               dict(n=5, tokens=6, prompt_len=14,
                    prompt_lens=(3, 9, 14, 5, 11))),
    "preempt": (dict(max_batch=4, max_len=32, page_size=4, prefill_chunk=4,
                     n_pages=6),
                dict(n=4, tokens=6, prompt_len=12, prompt_lens=(9, 7, 12, 5))),
}


@pytest.mark.parametrize("name", sorted(WORKLOADS))
def test_engine_tokens_identical_to_reference(models, name):
    ref_cfg, vals, cfg, params = models
    knobs, work = WORKLOADS[name]
    want = jax_run_offline(
        JaxEngine(ref_cfg, vals, None,
                  JaxServeConfig(kv_layout="paged", **knobs)),
        jax_requests(ref_cfg, scenario="offline", seed=7, **work))
    reqs = synthetic_requests(cfg, seed=7, **work)
    assert [r.prompt for r in reqs] == [r.prompt for r in jax_requests(
        ref_cfg, scenario="offline", seed=7, **work)]
    got = run_offline(Engine(cfg, params, ServeConfig(**knobs), device="cpu"),
                      reqs)
    tokens = lambda rep: [r.tokens for r in sorted(rep.requests,  # noqa: E731
                                                   key=lambda r: r.id)]
    assert tokens(got) == tokens(want)
    assert all(len(t) == work["tokens"] for t in tokens(got))
    assert got.preemptions == want.preemptions
    if name == "preempt":
        assert got.preemptions > 0, "a 6-page pool should have preempted"


def test_defrag_mid_run_keeps_tokens(models):
    _, _, cfg, params = models
    knobs, work = WORKLOADS["parity"]
    eng = Engine(cfg, params, ServeConfig(**knobs), device="cpu")
    want = [r.tokens for r in run_offline(
        eng, synthetic_requests(cfg, seed=3, **work)).requests]
    for r in synthetic_requests(cfg, seed=3, **work):
        eng.submit(r)
    for _ in range(5):
        eng.step()
    eng.defrag()
    report = eng.run()
    assert [r.tokens for r in report.requests] == want
    assert eng._pool.free_pages == eng._pool.n_pages


def test_engine_rejects_unported_and_oversized(models):
    _, _, cfg, params = models
    assert ServeConfig(temperature=0.8).temperature == 0.8  # ported
    assert get_config("rwkv6-3b").block_pattern[0].mixer == "rwkv6"  # ported
    with pytest.raises(NotImplementedError, match="not ported"):
        Engine(dataclasses.replace(cfg, block_pattern=(
            dataclasses.replace(cfg.block_pattern[0], mixer="conv"),)),
            params, device="cpu")
    eng = Engine(cfg, params, ServeConfig(max_batch=1, max_len=16,
                                          page_size=4, n_pages=3),
                 device="cpu")
    eng.submit(Request(prompt=[1] * 10, max_new_tokens=2))  # 3 pages: ok
    with pytest.raises(ValueError, match="exceeds max_len"):
        eng.submit(Request(prompt=[1] * 8, max_new_tokens=12))
    with pytest.raises(ValueError, match="pages"):
        eng.submit(Request(prompt=[1] * 10, max_new_tokens=4))


def test_synthetic_requests_prompt_lens_spread():
    cfg = get_config("gemma-7b").reduced()
    reqs = synthetic_requests(cfg, n=6, tokens=2, prompt_len=16,
                              prompt_lens=(3, 9, 14))
    assert [r.prompt_len for r in reqs] == [3, 9, 14, 3, 9, 14]
    lens = {r.prompt_len for r in synthetic_requests(
        cfg, n=12, tokens=2, prompt_len=16, seed=1)}
    assert len(lens) > 1 and max(lens) <= 16 and min(lens) >= 8


def test_percentile_nearest_rank():
    xs = [float(i) for i in range(1, 101)]
    assert percentile(xs, 50) == 50.0
    assert percentile(xs, 99) == 99.0
    assert percentile([], 50) == 0.0


# --------------------------------------------------------------------------- #
# Host-side invariants (pure python).
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("seed", range(4))
def test_scheduler_random_arrivals_fifo_and_exclusive(seed):
    rng = random.Random(seed)
    max_batch = 1 + seed % 3
    sched = Scheduler(max_batch)
    pending = [Request(prompt=[1] * rng.randint(1, 8)) for _ in range(12)]
    submitted, admitted = [], []
    while pending or sched.has_work:
        for _ in range(rng.randint(0, 2)):
            if pending:
                submitted.append(pending.pop(0))
                sched.submit(submitted[-1])
        admitted.extend(r for _, r in sched.admit())
        running = sched.running()
        assert len({i for i, _ in running}) == len(running) <= max_batch
        for i, r in running:
            assert r.state is RequestState.RUNNING and r.slot == i
        if sched.n_queued:
            assert sched.n_active == max_batch
        for i, _ in list(running):
            if rng.random() < 0.5:
                assert sched.retire(i).state is RequestState.FINISHED
    assert [r.id for r in admitted] == [r.id for r in submitted]


def _check_pool(pool: PagePool, n_pages: int):
    owned = [p for s in pool._slots.values() for p in s]
    assert len(owned) == len(set(owned)), "page double-owned"
    assert len(owned) + pool.free_pages == n_pages, "pages leaked"
    assert set(owned).isdisjoint(pool._free)
    for slot, pages in pool._slots.items():
        row = pool.table_row(slot, 8 + len(pages))
        assert row[:len(pages)].tolist() == pages
        assert (row[len(pages):] == -1).all()


@pytest.mark.parametrize("seed", range(4))
def test_page_pool_randomized_alloc_free_defrag(seed):
    rng = random.Random(seed)
    n_pages = rng.randint(4, 24)
    pool = PagePool(n_pages, page_size=rng.randint(1, 8))
    freed_ever, reused = set(), False
    for _ in range(200):
        op, slot = rng.random(), rng.randint(0, 5)
        if op < 0.45:
            n, before = rng.randint(0, n_pages + 2), pool.free_pages
            if pool.alloc(slot, n):
                assert pool.free_pages == before - n
                reused |= bool(freed_ever & set(pool.slot_pages(slot)))
            else:  # all-or-nothing
                assert pool.free_pages == before and n > before
        elif op < 0.75:
            freed_ever |= set(pool.slot_pages(slot))
            pool.free_slot(slot)
        elif op < 0.9:
            pool.ensure(slot, rng.randint(0, n_pages * pool.page_size))
        else:
            sizes = {s: len(p) for s, p in pool._slots.items()}
            perm = pool.defrag()
            assert sorted(perm[:n_pages].tolist()) == list(range(n_pages))
            assert perm[n_pages] == n_pages  # trash page pinned
            assert {s: len(p) for s, p in pool._slots.items()} == sizes
            owned = [p for s in pool._slots.values() for p in s]
            assert sorted(owned) == list(range(len(owned)))
        _check_pool(pool, n_pages)
    assert reused


def test_paged_scheduler_budget_admission_and_preempt():
    pool = PagePool(4, page_size=4)
    sched = PagedScheduler(2, pool, cost=lambda r: pool.pages_for(
        len(r.prompt) + len(r.tokens)))
    big = Request(prompt=[1] * 12, max_new_tokens=1)    # 3 pages
    small = Request(prompt=[2] * 4, max_new_tokens=1)   # 1 page
    tiny = Request(prompt=[3] * 2, max_new_tokens=1)    # 1 page
    for r in (big, small, tiny):
        sched.submit(r)
    admitted = sched.admit()
    assert [r for _, r in admitted] == [big, small]
    assert pool.free_pages == 0 and tiny.state is RequestState.QUEUED
    sched.retire(small.slot)
    assert sched.admit() == [(1, tiny)]
    out = sched.preempt(big.slot)
    assert out is big and big.state is RequestState.QUEUED
    assert pool.free_pages == 3 and big.slot is None
    assert sched.admit()[0][1] is big  # front of the FIFO


@pytest.mark.parametrize("seed,max_batch,n_pages",
                         [(0, 1, 3), (3, 2, 5), (5, 3, 10), (9, 2, 7)])
def test_paged_scheduler_preemption_invariants(seed, max_batch, n_pages):
    rng = random.Random(seed * 7919 + max_batch * 13 + n_pages)
    pool = PagePool(n_pages, page_size=4)
    sched = PagedScheduler(
        max_batch, pool,
        cost=lambda r: pool.pages_for(r.prompt_len + len(r.tokens)))
    cap = 4 * min(n_pages, 3)
    pending = [Request(prompt=[1] * rng.randint(1, cap)) for _ in range(8)]
    all_reqs, rounds = list(pending), 0
    while pending or sched.has_work:
        rounds += 1
        for _ in range(rng.randint(0, 2)):
            if pending:
                sched.submit(pending.pop(0))
        queued = sorted(r.sched_seq for r in sched._queue)
        admitted = sched.admit()
        assert sorted(r.sched_seq for _, r in admitted) == \
            queued[: len(admitted)]
        running = sched.running()
        reserved = [p for i, _ in running for p in pool.slot_pages(i)]
        assert len(set(reserved)) == len(reserved), "page double-mapped"
        assert pool.free_pages == n_pages - len(reserved)
        for i, r in list(running):
            roll = rng.random()
            if roll < 0.3 and rounds < 300:
                sched.preempt(i)
            elif roll < 0.8 or rounds >= 300:
                sched.retire(i)
    assert all(r.state is RequestState.FINISHED for r in all_reqs)
    assert pool.free_pages == n_pages


def test_serve_cli_on_cpu():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "gemma-7b", "--device", "cpu", "--tokens", "3", "--batch", "2"],
        capture_output=True, text=True, env=env, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert lines[0].startswith("gemma-7b [offline, device=cpu, slots=2, "
                               "kv=paged]: 2 requests, 6 tokens")
    assert "tok/s" in lines[0] and "p99" in lines[0]
    assert [ln.split(":")[0] for ln in lines[1:]] == ["  req 0", "  req 1"]
    assert all("-> 3 tokens" in ln for ln in lines[1:])


def test_engine_runs_on_cpu_without_numpy_weights():
    cfg = get_config("gemma-7b").reduced()
    params = lm.init_lm(cfg, 0, device="cpu", dtype=torch.float32)
    rep = run_offline(Engine(cfg, params, ServeConfig(max_batch=2, max_len=24),
                             device="cpu"),
                      synthetic_requests(cfg, n=3, tokens=4, prompt_len=12))
    assert sorted(len(r.tokens) for r in rep.requests) == [4, 4, 4]
