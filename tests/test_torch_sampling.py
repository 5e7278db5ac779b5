"""Temperature sampling in the port's engine against ``repro.serve.Engine``
on the same weights (the bridge), prompts and request ids: reduced
gemma-7b on the paged pool and on the slab, reduced jamba-1.5-large on
the slab, at temperature 0.8 in fp32. Tokens must match up to the first
draw whose two largest perturbed logits lie within ``NEAR`` of each
other (where the two frameworks' rounding may pick either), and every
layout must have a request matching over its full length. Also: draws
keyed by (seed, request, position) alone, independent of ``max_batch``;
speculative decoding refuses a temperature; the CLI samples."""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.dist import split_tree  # noqa: E402
from repro.serve import Engine as JaxEngine  # noqa: E402
from repro.serve import ServeConfig as JaxServeConfig  # noqa: E402
from repro.serve import run_offline as jax_run_offline  # noqa: E402
from repro.serve.engine import synthetic_requests as jax_requests  # noqa: E402
from repro.train.steps import ModelAPI  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.random import fold_in, gumbel  # noqa: E402
from repro_torch.serve.engine import (  # noqa: E402
    Engine,
    ServeConfig,
    synthetic_requests,
)
from repro_torch.serve.scenarios import run_offline  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")
FP32 = dict(dtype="float32", kv_cache_dtype="float32")
T = 0.8
# Two perturbed logits closer than this (fp32, reduced models whose
# logits agree with the reference's to ~1e-5) may swap between the two
# frameworks.
NEAR = 1e-3
WORK = dict(n=5, tokens=8, prompt_len=14, prompt_lens=(3, 9, 14, 5, 11))
LAYOUTS = {  # name: (arch, port knobs, reference knobs)
    "gemma-paged": ("gemma-7b",
                    dict(max_batch=3, max_len=32, page_size=4,
                         prefill_chunk=4),
                    dict(kv_layout="paged", max_batch=3, max_len=32,
                         page_size=4, prefill_chunk=4)),
    "gemma-slab": ("gemma-7b",
                   dict(kv_layout="slab", max_batch=3, max_len=32,
                        prefill_len=16),
                   dict(kv_layout="slab", max_batch=3, max_len=32,
                        prefill_len=16)),
    "jamba-slab": ("jamba-1.5-large-398b",
                   dict(max_batch=3, max_len=32),
                   dict(kv_layout="slab", max_batch=3, max_len=32)),
}


def _models(arch, n_layers=None):
    extra = dict(n_layers=n_layers) if n_layers else {}
    ref_cfg = dataclasses.replace(jax_get_config(arch).reduced(), **FP32,
                                  **extra)
    cfg = dataclasses.replace(get_config(arch).reduced(), **FP32, **extra)
    vals = jax.jit(lambda k: split_tree(ModelAPI(ref_cfg).init(ref_cfg, k))[0])(
        jax.random.PRNGKey(0))
    params = lm.params_from_numpy(jax.tree_util.tree_map(np.asarray, vals),
                                  cfg, device="cpu")
    return ref_cfg, vals, cfg, params


@pytest.fixture(scope="module")
def gemma():
    return _models("gemma-7b", n_layers=2)


@pytest.fixture(scope="module")
def jamba():
    return _models("jamba-1.5-large-398b")


def _ids(reqs, base=100):
    """Request ids are a process-wide counter on both sides: pin them."""
    for i, r in enumerate(reqs):
        r.id = base + i
    return reqs


def _tokens(report):
    return {r.id: list(r.tokens) for r in report.requests}


def _record_margins(engine):
    """Wrap ``engine._sample``: for every draw, the gap between the two
    largest perturbed logits, by (request id, position) of its first
    draw."""
    margins = {}
    draw = engine._sample

    def recorded(logits, rid, pos, ahead=0):
        out = draw(logits, rid, pos, ahead)
        B = logits.shape[0]

        def rows(x):
            if torch.is_tensor(x):
                return x.to(torch.int64).expand(B)
            return torch.full((B,), int(x), dtype=torch.int64)

        r, p = rows(rid), rows(pos) + rows(ahead)
        keys = fold_in(fold_in(engine._key, r), p)
        pert = gumbel(keys, logits.shape[-1:], logits.dtype) + logits / \
            torch.tensor(engine.scfg.temperature, dtype=logits.dtype)
        top2 = pert.topk(2, dim=-1).values
        for a, b, gap in zip(r.tolist(), p.tolist(),
                             (top2[:, 0] - top2[:, 1]).tolist()):
            margins.setdefault((a, b), gap)
        return out

    engine._sample = recorded
    return margins


def _compare(got, want, prompts, margins):
    """Matches up to each request's first near tie; returns the number
    of requests equal over their full length and of near ties met."""
    full, ties = 0, 0
    assert sorted(got) == sorted(want)
    for rid, toks in got.items():
        ref = want[rid]
        assert len(toks) == len(ref)
        first = next((j for j, (a, b) in enumerate(zip(toks, ref))
                      if a != b), None)
        if first is None:
            full += 1
            continue
        gap = margins[(rid, prompts[rid] + first)]
        assert gap <= NEAR, (
            f"request {rid} differs at token {first} where the top two "
            f"perturbed logits are {gap} apart")
        ties += 1
    return full, ties


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_sampled_tokens_match_reference_up_to_near_ties(layout, gemma,
                                                        jamba):
    arch, knobs, ref_knobs = LAYOUTS[layout]
    ref_cfg, vals, cfg, params = jamba if arch.startswith("jamba") else gemma
    want = _tokens(jax_run_offline(
        JaxEngine(ref_cfg, vals, None,
                  JaxServeConfig(temperature=T, seed=3, **ref_knobs)),
        _ids(jax_requests(ref_cfg, scenario="offline", seed=7, **WORK))))
    eng = Engine(cfg, params, ServeConfig(temperature=T, seed=3, **knobs),
                 device="cpu")
    margins = _record_margins(eng)
    reqs = _ids(synthetic_requests(cfg, seed=7, **WORK))
    prompts = {r.id: r.prompt_len for r in reqs}
    got = _tokens(run_offline(eng, reqs))
    full, ties = _compare(got, want, prompts, margins)
    assert full >= 1, f"no request matched over its full length ({ties} ties)"
    greedy = _tokens(run_offline(
        Engine(cfg, params, ServeConfig(**knobs), device="cpu"),
        _ids(synthetic_requests(cfg, seed=7, **WORK))))
    assert got != greedy, "temperature 0.8 drew the greedy tokens"


def test_sampled_tokens_do_not_depend_on_max_batch(gemma):
    _, _, cfg, params = gemma
    runs = []
    for max_batch in (1, 2, 5):
        eng = Engine(cfg, params,
                     ServeConfig(temperature=T, max_batch=max_batch,
                                 max_len=32, page_size=4, prefill_chunk=4),
                     device="cpu")
        runs.append(_tokens(run_offline(
            eng, _ids(synthetic_requests(cfg, seed=7, **WORK)))))
    assert runs[0] == runs[1] == runs[2]


def test_draws_keyed_by_request_and_position(gemma):
    """The reference's keying test on the port, and the same draws as
    the reference's ``Engine._sample``: identical rows draw differently
    across requests and positions, and one request's row does not
    depend on its slot."""
    ref_cfg, vals, cfg, params = gemma
    eng = Engine(cfg, params, ServeConfig(max_batch=4, max_len=16,
                                          prefill_len=8, temperature=1.0),
                 device="cpu")
    ref = JaxEngine(ref_cfg, vals, None,
                    JaxServeConfig(max_batch=4, max_len=16, prefill_len=8,
                                   temperature=1.0))
    logits = torch.zeros(4, cfg.vocab)
    rids = torch.tensor([10, 11, 12, 13])
    pos = torch.full((4,), 7)
    a = eng._sample(logits, rids, pos)
    assert torch.equal(a, eng._sample(logits, rids, pos))
    assert len(set(a.tolist())) > 1, "all requests drew with one key"
    seq = [int(eng._sample(logits[:1], 10, p)[0]) for p in range(8)]
    assert len(set(seq)) > 1, "positions share a key"
    assert int(eng._sample(logits[2:3], 12, 7)[0]) == int(a[2])
    want = np.asarray(ref._sample(jnp.zeros((4, cfg.vocab)),
                                  np.array([10, 11, 12, 13], np.uint32),
                                  np.full((4,), 7, np.int32)))
    assert a.tolist() == want.tolist()
    assert seq == [int(np.asarray(ref._sample(jnp.zeros((1, cfg.vocab)), 10,
                                              p))[0]) for p in range(8)]


def test_greedy_is_unchanged_at_zero_temperature(gemma):
    _, _, cfg, params = gemma
    eng = Engine(cfg, params, ServeConfig(max_batch=2, max_len=16),
                 device="cpu")
    logits = torch.randn(2, cfg.vocab, generator=torch.Generator().manual_seed(0))
    assert torch.equal(eng._sample(logits, 0, 3), logits.argmax(-1))


def test_spec_decode_with_temperature_raises(gemma):
    _, vals, cfg, params = gemma
    with pytest.raises(ValueError, match="greedy-only"):
        Engine(cfg, params, ServeConfig(temperature=0.5, spec_decode="ngram",
                                        prefill_chunk=8, draft_len=3),
               device="cpu")
    ServeConfig(temperature=0.5, seed=11)  # no longer refused


def test_serve_cli_samples_on_cpu():
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    outs = []
    for temp in ("0.8", "0.8", "0"):
        out = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
             "gemma-7b", "--device", "cpu", "--tokens", "4", "--batch", "2",
             "--temperature", temp, "--seed", "0"],
            capture_output=True, text=True, env=env, timeout=300, cwd=ROOT)
        assert out.returncode == 0, out.stderr
        lines = out.stdout.splitlines()
        assert lines[0].startswith("gemma-7b [offline, device=cpu, slots=2, "
                                   "kv=paged]: 2 requests, 8 tokens")
        outs.append([ln.split("tokens ")[-1] for ln in lines[1:]])
    assert outs[0] == outs[1] and outs[0] != outs[2]
