"""Speculative decoding of the port against ``repro.serve``.

- ``NgramDrafter.propose`` equals the reference's on random contexts.
- Speculative greedy tokens equal plain greedy tokens on bf16, int8 and
  int4 pools, under pool-pressure preemption and with the prefix cache
  on. Every run asserts that drafts were proposed (an identity with no
  draft checks nothing: the reference's own preemption test proposes
  none), with three drafters: the n-gram drafter, one that replays the
  plain run's tokens (drafts accepted) and one that proposes wrong
  tokens (every draft rejected).
- ``draft_tokens``, ``spec_accept_rate`` and the greedy tokens equal
  ``repro.serve.Engine``'s with the same drafter.
"""
import dataclasses
import random

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.dist import split_tree  # noqa: E402
from repro.serve import Engine as JaxEngine  # noqa: E402
from repro.serve import ServeConfig as JaxServeConfig  # noqa: E402
from repro.serve import run_server as jax_run_server  # noqa: E402
from repro.serve.engine import synthetic_requests as jax_requests  # noqa: E402
from repro.serve.speculative import DraftModelDrafter as JaxDraftModel  # noqa: E402
from repro.serve.speculative import NgramDrafter as JaxNgram  # noqa: E402
from repro.train.steps import ModelAPI  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.serve.engine import (  # noqa: E402
    Engine,
    ServeConfig,
    synthetic_requests,
)
from repro_torch.serve.scenarios import run_server  # noqa: E402
from repro_torch.serve.speculative import (  # noqa: E402
    DraftModelDrafter,
    NgramDrafter,
    get_drafter,
)

FP32 = dict(dtype="float32", kv_cache_dtype="float32", n_layers=2)


@pytest.mark.parametrize("seed", range(4))
def test_ngram_drafter_matches_reference(seed):
    rng = random.Random(seed)
    for _ in range(200):
        ctx = [rng.randrange(1 + seed) for _ in range(rng.randint(0, 24))]
        k, max_n = rng.randint(0, 5), rng.randint(1, 4)
        assert NgramDrafter(max_n).propose(ctx, k) == \
            JaxNgram(max_n).propose(ctx, k), (ctx, k, max_n)


def test_drafter_hook_and_factory():
    d = DraftModelDrafter(lambda ctx, k: [ctx[-1]] * (k + 3))
    assert d.propose([4, 5], 2) == [5, 5]  # capped at k
    assert get_drafter("off") is None and get_drafter("") is None
    assert isinstance(get_drafter("ngram"), NgramDrafter)
    with pytest.raises(ValueError, match="unknown spec_decode"):
        get_drafter("medusa")
    with pytest.raises(ValueError):
        NgramDrafter(0)
    assert NgramDrafter().propose([1, 7, 8, 9, 5, 7, 8, 9], k=2) == [5, 7]


@pytest.fixture(scope="module")
def models():
    ref_cfg = dataclasses.replace(jax_get_config("gemma-7b").reduced(), **FP32)
    cfg = dataclasses.replace(get_config("gemma-7b").reduced(), **FP32)
    vals, _ = split_tree(ModelAPI(ref_cfg).init(ref_cfg,
                                                jax.random.PRNGKey(0)))
    params = lm.params_from_numpy(jax.tree_util.tree_map(np.asarray, vals),
                                  cfg, device="cpu")
    return ref_cfg, vals, cfg, params


# A 12-page pool under a shared-prefix server stream: preemptions,
# prefix hits and drafts in one run.
BASE = dict(max_batch=3, max_len=32, page_size=4, prefill_chunk=6,
            n_pages=12, prefix_cache=True)
SPEC = dict(spec_decode="ngram", draft_len=3)


def _workload(make, cfg):
    return make(cfg, n=6, tokens=8, prompt_len=16, scenario="server",
                seed=9, shared_prefix_len=8, n_templates=2)


def _tokens(report):
    return [list(r.tokens) for r in sorted(report.requests, key=lambda r: r.id)]


def _replay(plain, wrong=False, vocab=None):
    """propose(context, k): the plain run's next tokens for the request
    whose prompt opens the context; ``wrong`` shifts each by one, so
    every draft is rejected."""
    runs = [(list(r.prompt), list(r.tokens)) for r in plain.requests]

    def fn(ctx, k):
        for prompt, toks in runs:
            if ctx[:len(prompt)] == prompt:
                nxt = toks[len(ctx) - len(prompt):][:k]
                return [(t + 1) % vocab for t in nxt] if wrong else nxt
        raise AssertionError("context of no request in the workload")
    return fn


@pytest.mark.parametrize("kv", ["bfloat16", "int8", "int4"])
@pytest.mark.parametrize("drafter", ["ngram", "replay", "wrong"])
def test_spec_identity_and_counters_match_reference(models, kv, drafter):
    ref_cfg, vals, cfg, params = models
    knobs = dict(BASE, kv_dtype=kv)
    plain = run_server(Engine(cfg, params, ServeConfig(**knobs), device="cpu"),
                       _workload(synthetic_requests, cfg))
    assert plain.preemptions > 0 and plain.pages_shared > 0
    mine = theirs = None
    if drafter != "ngram":
        fn = _replay(plain, wrong=drafter == "wrong", vocab=cfg.vocab)
        mine, theirs = DraftModelDrafter(fn), JaxDraftModel(fn)
    spec = run_server(
        Engine(cfg, params, ServeConfig(**knobs, **SPEC), drafter=mine,
               device="cpu"),
        _workload(synthetic_requests, cfg))
    want = jax_run_server(
        JaxEngine(ref_cfg, vals, None,
                  JaxServeConfig(kv_layout="paged", **knobs, **SPEC),
                  drafter=theirs),
        _workload(jax_requests, ref_cfg))
    assert _tokens(spec) == _tokens(plain) == _tokens(want)
    assert spec.draft_tokens > 0, "no draft proposed: the identity is empty"
    assert (spec.draft_tokens, spec.spec_accept_rate, spec.preemptions,
            spec.prefix_hit_rate) == (want.draft_tokens, want.spec_accept_rate,
                                      want.preemptions, want.prefix_hit_rate)
    # replay: drafts accepted; wrong: every draft rejected (the n-gram
    # drafter's mix is whatever the reference's is, checked above)
    if drafter == "replay":
        assert spec.draft_accepted > 0
    elif drafter == "wrong":
        assert spec.draft_accepted == 0 and spec.spec_accept_rate == 0.0
    assert spec.summary()["draft_tokens"] == spec.draft_tokens
    assert plain.spec_accept_rate is None


def test_engine_validates_spec_and_quantized_combos(models):
    _, _, cfg, params = models
    with pytest.raises(ValueError, match="fit one chunk"):
        Engine(cfg, params, ServeConfig(prefill_chunk=4, spec_decode="ngram",
                                        draft_len=4), device="cpu")
    with pytest.raises(ValueError, match="fit one chunk"):
        Engine(cfg, params, ServeConfig(prefill_chunk=2), device="cpu",
               drafter=DraftModelDrafter(lambda c, k: []))
    odd = dataclasses.replace(cfg, head_dim=15)
    with pytest.raises(ValueError, match="even head_dim"):
        Engine(odd, params, ServeConfig(kv_dtype="int4"), device="cpu")
    for bad, match in ((dict(kv_dtype="fp8"), "kv_dtype"),
                       (dict(spec_decode="medusa"), "spec_decode"),
                       (dict(draft_len=0), "draft_len")):
        with pytest.raises(ValueError, match=match):
            ServeConfig(**bad)
