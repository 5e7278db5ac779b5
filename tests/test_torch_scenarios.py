"""The port's MLPerf-Inference scenarios and SLO classes against
``repro.serve``.

- ``make_trace`` gives the reference's prompts, templates, arrivals and
  classes for every scenario and arrival pattern, and the arrival
  processes draw what the reference draws from the same rng.
- The four drivers on reduced gemma-7b (fp32, a sub-parity int8 pool,
  SLO classes) give the reference engine's greedy tokens, step stamps,
  preemptions and per-class counts, violations and goodput.
- The SLO registry and arithmetic equal the reference's.
- The serve CLI runs the new flags on ``--device cpu``.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.dist import split_tree  # noqa: E402
from repro.serve import Engine as JaxEngine  # noqa: E402
from repro.serve import ServeConfig as JaxServeConfig  # noqa: E402
from repro.serve import scenarios as jax_scen  # noqa: E402
from repro.serve import slo as jax_slo  # noqa: E402
from repro.train.steps import ModelAPI  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.serve import scenarios as scen  # noqa: E402
from repro_torch.serve import slo  # noqa: E402
from repro_torch.serve.engine import Engine, ServeConfig  # noqa: E402
from repro_torch.serve.metrics import ServeReport  # noqa: E402
from repro_torch.serve.request import Request  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")
FP32 = dict(dtype="float32", kv_cache_dtype="float32", n_layers=2)
CLASSES = ("interactive", "standard", "batch")


def _trace_key(reqs):
    return [(r.prompt, r.arrival_step, r.max_new_tokens, r.template,
             r.slo.name if r.slo else None) for r in reqs]


TRACES = [(s, p) for s in scen.SCENARIOS for p in ("poisson",)] + \
    [("server", "bursty"), ("server", "diurnal")]


@pytest.mark.parametrize("scenario,pattern", TRACES)
@pytest.mark.parametrize("shared", [0, 6])
def test_make_trace_identical_to_reference(scenario, pattern, shared):
    kw = dict(scenario=scenario, n=9, tokens=3, prompt_len=12, seed=4,
              rate=0.7, pattern=pattern, query_size=3, query_interval=5,
              slo_classes=CLASSES, shared_prefix_len=shared, n_templates=2)
    got = scen.make_trace(get_config("gemma-7b").reduced(), **kw)
    want = jax_scen.make_trace(jax_get_config("gemma-7b").reduced(), **kw)
    assert _trace_key(got) == _trace_key(want)
    if scenario != "offline" and scenario != "single_stream":
        assert len({r.arrival_step for r in got}) > 1
    with pytest.raises(ValueError, match="unknown serve scenario"):
        scen.make_trace(get_config("gemma-7b").reduced(), **dict(
            kw, scenario="offln"))


@pytest.mark.parametrize("seed", range(3))
def test_arrival_processes_identical_to_reference(seed):
    for pattern in scen.ARRIVAL_PATTERNS:
        got = scen.arrival_steps(pattern, np.random.RandomState(seed), 40, 0.6)
        want = jax_scen.arrival_steps(pattern, np.random.RandomState(seed),
                                      40, 0.6)
        assert got == want, pattern
        assert got == sorted(got) and min(got) >= 0
    with pytest.raises(ValueError, match="pattern"):
        scen.arrival_steps("weekly", np.random.RandomState(0), 2, 1.0)
    with pytest.raises(ValueError):
        scen.poisson_arrivals(np.random.RandomState(0), 2, 0.0)


def test_slo_registry_and_arithmetic_match_reference():
    assert sorted(slo.CLASSES) == sorted(jax_slo.CLASSES)
    for name, c in slo.CLASSES.items():
        assert dataclasses.astuple(c) == dataclasses.astuple(
            jax_slo.CLASSES[name])
    with pytest.raises(ValueError, match="unknown SLO class"):
        slo.get_class("gold")
    with pytest.raises(ValueError):
        slo.SLOClass("x", priority=-1)
    with pytest.raises(ValueError):
        slo.SLOClass("x", ttft_steps=0)
    r = Request(prompt=[1], max_new_tokens=4, arrival_step=2,
                slo=slo.get_class("interactive"))
    r.s_first_token, r.s_done = 10, 20
    assert slo.met_slo(r) and slo.slack(r, 10) == 2 + 48 - 10 - 4
    r.s_first_token = 11  # ttft budget 8 steps from arrival 2
    assert not slo.met_slo(r)
    assert slo.met_slo(Request(prompt=[1]))
    assert scen.scenario_driver("server") is scen.run_server
    with pytest.raises(ValueError, match="unknown serve scenario"):
        scen.scenario_driver("burst")


@pytest.fixture(scope="module")
def models():
    ref_cfg = dataclasses.replace(jax_get_config("gemma-7b").reduced(), **FP32)
    cfg = dataclasses.replace(get_config("gemma-7b").reduced(), **FP32)
    vals, _ = split_tree(ModelAPI(ref_cfg).init(ref_cfg,
                                                jax.random.PRNGKey(0)))
    params = lm.params_from_numpy(jax.tree_util.tree_map(np.asarray, vals),
                                  cfg, device="cpu")
    return ref_cfg, vals, cfg, params


def _class_fields(report):
    """The per-class fields that do not depend on the wall clock."""
    return {name: (m["requests"], m["violations"], m["goodput"])
            for name, m in report.per_class().items()}


def _run_fields(report):
    reqs = sorted(report.requests, key=lambda r: r.id)
    return ([r.tokens for r in reqs],
            [(r.arrival_step, r.s_arrival, r.s_first_token, r.s_done)
             for r in reqs], report.preemptions)


@pytest.mark.parametrize("scenario", scen.SCENARIOS)
def test_drivers_match_reference_engine(models, scenario):
    ref_cfg, vals, cfg, params = models
    knobs = dict(max_batch=3, max_len=16, page_size=4, prefill_chunk=4,
                 n_pages=8, kv_dtype="int8")
    kw = dict(scenario=scenario, n=6, tokens=4, prompt_len=10, seed=0,
              slo_classes=CLASSES, query_size=2, query_interval=4)
    want = jax_scen.scenario_driver(scenario)(
        JaxEngine(ref_cfg, vals, None,
                  JaxServeConfig(kv_layout="paged", **knobs)),
        jax_scen.make_trace(ref_cfg, **kw))
    got = scen.scenario_driver(scenario)(
        Engine(cfg, params, ServeConfig(**knobs), device="cpu"),
        scen.make_trace(cfg, **kw))
    assert isinstance(got, ServeReport)
    assert _run_fields(got) == _run_fields(want)
    assert _class_fields(got) == _class_fields(want)
    assert (got.slo_violations, got.slo_goodput, got.goodput) == \
        (want.slo_violations, want.slo_goodput, want.goodput)
    assert set(got.per_class()) == set(CLASSES)
    s = got.summary()
    assert s["slo_violations"] == got.slo_violations
    if scenario == "single_stream":
        done = sorted(got.requests, key=lambda r: r.s_arrival)
        for prev, nxt in zip(done, done[1:]):
            assert nxt.s_arrival >= prev.s_done


def test_engine_admission_preempts_lower_class(models):
    """A late interactive arrival with a meetable budget preempts a batch
    slot; one whose budget is already blown waits. Tokens are the same
    either way, and equal the reference's."""
    ref_cfg, vals, cfg, params = models
    blown = slo.SLOClass("interactive", priority=0, ttft_steps=1,
                         latency_steps=2)

    def mk(cls, request_cls, vocab):
        rng = np.random.RandomState(6)
        batch = [request_cls(prompt=rng.randint(0, vocab, size=13).tolist(),
                             max_new_tokens=3, slo=slo.get_class("batch"))
                 for _ in range(2)]
        return batch + [request_cls(
            prompt=rng.randint(0, vocab, size=4).tolist(), max_new_tokens=4,
            arrival_step=2, slo=cls)]

    knobs = dict(max_batch=3, max_len=16, page_size=4, prefill_chunk=8,
                 n_pages=8)
    eng = Engine(cfg, params, ServeConfig(**knobs), device="cpu")
    held = scen.run_server(eng, mk(blown, Request, cfg.vocab))
    rescued = scen.run_server(eng, mk(slo.get_class("interactive"), Request,
                                      cfg.vocab))
    assert held.preemptions == 0 and rescued.preemptions > 0
    from repro.serve import Request as JaxRequest

    want = jax_scen.run_server(
        JaxEngine(ref_cfg, vals, None,
                  JaxServeConfig(kv_layout="paged", **knobs)),
        mk(jax_slo.get_class("interactive"), JaxRequest, cfg.vocab))
    key = lambda rep: sorted((r.prompt_len, tuple(r.tokens))  # noqa: E731
                             for r in rep.requests)
    assert key(held) == key(rescued) == key(want)
    assert rescued.preemptions == want.preemptions


def test_serve_cli_new_flags_on_cpu():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "gemma-7b", "--device", "cpu", "--tokens", "4", "--batch", "4",
         "--prompt-len", "20", "--page-size", "4", "--kv-dtype", "int4",
         "--prefix-cache", "--spec-decode", "ngram", "--draft-len", "3",
         "--scenario", "server", "--shared-prefix-len", "12",
         "--n-templates", "2", "--slo-classes", "interactive,batch"],
        capture_output=True, text=True, env=env, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert lines[0].startswith("gemma-7b [server, device=cpu, slots=4, "
                               "kv=paged/int4]: 4 requests, 16 tokens")
    assert lines[1].startswith("  prefix cache: hit_rate ")
    assert lines[2].startswith("  speculative: accept_rate ")
    assert lines[3].startswith("  slo: goodput ")
    assert [ln.split(":")[0] for ln in lines[-4:]] == [
        f"  req {i}" for i in range(4)]
    for bad in (["--chaos", "kill"], ["--serve-mode", "tp2d"],
                ["--n-replicas", "2"]):
        out = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
             "gemma-7b", "--device", "cpu", *bad],
            capture_output=True, text=True, env=env, timeout=300, cwd=ROOT)
        assert out.returncode != 0 and "NotImplementedError" in out.stderr
