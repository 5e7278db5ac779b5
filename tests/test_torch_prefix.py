"""The port's prefix cache against ``repro.serve``.

- The refcounted ``PagePool`` and the radix ``PrefixIndex``, driven by
  the same random operation sequences as ``repro.serve.cache`` and
  ``repro.serve.prefix``, give identical results at every step:
  allocations, shares, copy-on-writes, lookups, refcounts, free lists,
  evictions and defrag permutations.
- The engine with ``prefix_cache=True`` against ``repro.serve.Engine``
  on reduced gemma-7b (fp32 compute; fp32, int8 and int4 pools):
  identical greedy tokens and identical ``prefix_hit_rate``,
  ``pages_shared``, ``prefill_tokens_skipped``, ``cow_copies`` and
  preemptions, on a shared-prefix workload under pool pressure with an
  exact-duplicate prompt (a full-prompt match copy-on-writes its page).
"""
import dataclasses
import random

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.dist import split_tree  # noqa: E402
from repro.serve import Engine as JaxEngine  # noqa: E402
from repro.serve import PagePool as JaxPagePool  # noqa: E402
from repro.serve import PrefixIndex as JaxPrefixIndex  # noqa: E402
from repro.serve import Request as JaxRequest  # noqa: E402
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
from repro_torch.serve.prefix import PrefixIndex  # noqa: E402
from repro_torch.serve.request import Request  # noqa: E402
from repro_torch.serve.scenarios import run_offline  # noqa: E402

FP32 = dict(dtype="float32", kv_cache_dtype="float32", n_layers=2)


# --------------------------------------------------------------------------- #
# Host side: the same random operation sequences on both.
# --------------------------------------------------------------------------- #
def _state(pool, index):
    nodes = sorted((n.namespace or b"", n.key, n.page)
                   for n in index._nodes)
    return (list(pool._free), {s: list(p) for s, p in pool._slots.items()},
            list(pool._ref), sorted(pool._cached), nodes)


def _ops(seed, n_pages, ps):
    """A seeded sequence of valid pool and index operations, chosen
    against a model pool that both sides then replay."""
    rng = random.Random(seed)
    pool = PagePool(n_pages, ps)
    index = PrefixIndex(pool, ps)
    vocab = 3  # a small vocabulary so chains overlap and branch
    ops, seen = [], []

    def stream():
        """A fresh stream, or one that opens with a stream already seen
        (so lookups hit and inserts branch off existing chains)."""
        head = []
        if seen and rng.random() < 0.6:
            base = rng.choice(seen)
            head = base[:ps * rng.randint(1, max(1, len(base) // ps))]
        out = head + [rng.randrange(vocab)
                      for _ in range(rng.randint(1, 3 * ps))]
        seen.append(out)
        return out

    weights = dict(alloc=3, lookup_share=3, insert=3, cow=2, free=2,
                   evict=1, defrag=1)
    for _ in range(150):
        kind = rng.choices(list(weights), list(weights.values()))[0]
        slot = rng.randrange(4)
        if kind in ("insert", "cow") and not pool.slot_pages(slot):
            kind = "alloc"
        if kind == "alloc":
            op = ("alloc", slot, rng.randint(0, 3))
        elif kind in ("lookup_share", "insert"):
            op = (kind, slot, stream())
        elif kind == "cow":
            op = ("cow", slot, rng.randrange(len(pool.slot_pages(slot))))
        elif kind == "free":
            op = ("free", slot)
        elif kind == "evict":
            op = ("evict", rng.randint(1, 4))
        else:
            op = ("defrag",)
        _apply(pool, index, op, PagePool)
        ops.append(op)
    return ops


def _apply(pool, index, op, pool_cls):
    """Run one operation; returns what it returned (or raised)."""
    kind = op[0]
    try:
        if kind == "alloc":
            return pool.alloc(op[1], op[2])
        if kind == "lookup_share":
            pages = index.lookup(op[2])
            pool.share(op[1], pages)
            return pages
        if kind == "insert":
            return index.insert(op[2], pool.slot_pages(op[1]))
        if kind == "cow":
            return pool.cow(op[1], op[2])
        if kind == "free":
            return pool.free_slot(op[1])
        if kind == "evict":
            return index.evict(op[1])
        perm = pool.defrag()
        index.remap(pool_cls.remap_from_perm(perm))
        return perm.tolist()
    except (RuntimeError, ValueError) as e:
        return type(e).__name__


@pytest.mark.parametrize("seed", range(6))
def test_pool_and_index_replay_reference(seed):
    n_pages, ps = 10, 2
    ops = _ops(seed, n_pages, ps)
    mine, theirs = PagePool(n_pages, ps), JaxPagePool(n_pages, ps)
    idx_mine, idx_theirs = (PrefixIndex(mine, ps),
                            JaxPrefixIndex(theirs, ps))
    kinds = set()
    for op in ops:
        got = _apply(mine, idx_mine, op, PagePool)
        want = _apply(theirs, idx_theirs, op, JaxPagePool)
        assert got == want, op
        assert _state(mine, idx_mine) == _state(theirs, idx_theirs), op
        for p in range(n_pages):
            assert mine.is_shared(p) == theirs.is_shared(p)
        kinds.add((op[0], bool(got) and not isinstance(got, str)))
    # the sequence exercised hits, shares, cows, evictions and defrags
    for k in ("lookup_share", "cow", "evict", "insert", "defrag"):
        assert (k, True) in kinds, k


def test_prefix_index_guards_and_lru_leaf_eviction():
    ps = 2
    pool = PagePool(8, ps)
    with pytest.raises(ValueError):
        PrefixIndex(pool, ps + 1)
    index = PrefixIndex(pool, ps)
    assert pool.alloc(0, 2)
    chain = pool.slot_pages(0)
    index.insert([1, 2, 3, 4], chain)
    assert pool.alloc(1, 1)
    index.insert([5, 6], pool.slot_pages(1))
    assert index.lookup([1, 2, 3, 4], namespace=b"other") == []
    index.lookup([1, 2, 3, 4])
    pool.free_slot(0)
    assert index.evict(8) == 2  # leaf first, then its parent
    assert all(p in pool._free for p in chain)
    pool.free_slot(1)
    assert index.evict(8) == 1
    assert pool.free_pages == pool.n_pages
    with pytest.raises(ValueError, match="free"):
        pool.share(2, [0])
    with pytest.raises(ValueError, match="free"):
        pool.cache([0])


# --------------------------------------------------------------------------- #
# Engine parity with the prefix cache on.
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def models():
    ref_cfg = dataclasses.replace(jax_get_config("gemma-7b").reduced(), **FP32)
    cfg = dataclasses.replace(get_config("gemma-7b").reduced(), **FP32)
    vals, _ = split_tree(ModelAPI(ref_cfg).init(ref_cfg,
                                                jax.random.PRNGKey(0)))
    params = lm.params_from_numpy(jax.tree_util.tree_map(np.asarray, vals),
                                  cfg, device="cpu")
    return ref_cfg, vals, cfg, params


BASE = dict(max_batch=3, max_len=32, page_size=4, prefill_chunk=4,
            n_pages=12, prefix_cache=True)
COUNTERS = ("prefix_hit_rate", "pages_shared", "prefill_tokens_skipped",
            "cow_copies", "preemptions")


def _workload(make, request_cls, cfg):
    """Shared-prefix offline workload (two 8-token templates) plus an
    exact duplicate of the first prompt: a full-prompt match."""
    reqs = make(cfg, n=6, tokens=8, prompt_len=12, scenario="offline",
                seed=9, shared_prefix_len=8, n_templates=2)
    return reqs + [request_cls(prompt=list(reqs[0].prompt), max_new_tokens=8)]


def _tokens(report):
    return [list(r.tokens) for r in sorted(report.requests, key=lambda r: r.id)]


@pytest.mark.parametrize("kv", ["float32", "int8", "int4"])
def test_engine_prefix_cache_matches_reference(models, kv):
    ref_cfg, vals, cfg, params = models
    want = jax_run_offline(
        JaxEngine(ref_cfg, vals, None,
                  JaxServeConfig(kv_layout="paged", kv_dtype=kv, **BASE)),
        _workload(jax_requests, JaxRequest, ref_cfg))
    got = run_offline(
        Engine(cfg, params, ServeConfig(kv_dtype=kv, **BASE), device="cpu"),
        _workload(synthetic_requests, Request, cfg))
    assert _tokens(got) == _tokens(want)
    for name in COUNTERS:
        assert getattr(got, name) == getattr(want, name), name
    assert got.preemptions > 0 and got.pages_shared > 0
    assert got.prefill_tokens_skipped > 0 and 0 < got.prefix_hit_rate < 1
    # the cache changes no token: the cache-off engine gives the same
    off = dict(BASE, prefix_cache=False)
    plain = run_offline(
        Engine(cfg, params, ServeConfig(kv_dtype=kv, **off), device="cpu"),
        _workload(synthetic_requests, Request, cfg))
    assert _tokens(plain) == _tokens(got)
    assert plain.prefix_hit_rate is None


def test_full_prompt_match_cow_matches_reference(models):
    """Exact-duplicate prompts, admitted one at a time: every later
    duplicate full-matches, copy-on-writes its last page and re-feeds
    only its last token."""
    ref_cfg, vals, cfg, params = models
    prompt = np.random.RandomState(2).randint(0, cfg.vocab, size=8).tolist()
    base = dict(max_batch=1, max_len=32, page_size=4, prefill_chunk=4,
                prefix_cache=True, kv_dtype="int8")
    want = jax_run_offline(
        JaxEngine(ref_cfg, vals, None,
                  JaxServeConfig(kv_layout="paged", **base)),
        [JaxRequest(prompt=list(prompt), max_new_tokens=5) for _ in range(3)])
    got = run_offline(
        Engine(cfg, params, ServeConfig(**base), device="cpu"),
        [Request(prompt=list(prompt), max_new_tokens=5) for _ in range(3)])
    assert _tokens(got) == _tokens(want)
    assert (got.cow_copies, got.pages_shared, got.prefill_tokens_skipped) \
        == (want.cow_copies, want.pages_shared,
            want.prefill_tokens_skipped) == (2, 4, 14)


def test_defrag_mid_run_with_shared_pages_keeps_tokens(models):
    _, _, cfg, params = models
    off = run_offline(
        Engine(cfg, params, ServeConfig(**dict(BASE, prefix_cache=False)),
               device="cpu"),
        _workload(synthetic_requests, Request, cfg))
    eng = Engine(cfg, params, ServeConfig(kv_dtype="int4", **BASE),
                 device="cpu")
    for r in _workload(synthetic_requests, Request, cfg):
        eng.submit(r)
    for _ in range(6):
        eng.step()
    assert any(eng._pool.is_shared(p) for p in range(eng._pool.n_pages))
    eng.defrag()  # compact with shared and cached pages live
    report = eng.run()
    plain_int4 = run_offline(
        Engine(cfg, params, ServeConfig(kv_dtype="int4", **dict(
            BASE, prefix_cache=False)), device="cpu"),
        _workload(synthetic_requests, Request, cfg))
    assert _tokens(report) == _tokens(plain_int4)
    assert len(_tokens(off)) == len(_tokens(report))
    assert eng._pool.free_pages == eng._pool.n_pages
