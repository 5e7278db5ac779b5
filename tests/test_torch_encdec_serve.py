"""The port's serving engine and trainer on reduced whisper-medium
against the JAX reference's, from the same numpy weights (the
reference's ``init_encdec`` through the bridge, norms perturbed) in fp32
on both sides. Both engines serve the reference's requests, media
included (its ``synthetic_requests`` draws them with ``jax.random``).

Held, greedy tokens exactly: the paged engine (chunked decoder prefill,
one encoder pass a request into the cross slab) and the slab engine,
each against the reference's, and the port's paged against its slab;
the int8 pool (cross slab int8 too); the prefix cache, whose pages only
requests with bitwise-identical media share (same template, other
media: no hit); n-gram drafts (the drafts proposed and accepted equal
too); preemption under a tight pool and a defrag mid-flight, which leave
the cross slab as it is. Trainer: 3 steps with eval, losses within rtol
1e-4 (fp32, sums in other orders), the batches byte-identical, the
checkpoint names the reference's; a resumed run's losses bitwise the
uninterrupted run's."""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.data import pipeline as jax_data  # noqa: E402
from repro.dist import split_tree  # noqa: E402
from repro.launch.mesh import single_device_mesh  # noqa: E402
from repro.models import encdec as jed  # noqa: E402
from repro.serve import Engine as JaxEngine  # noqa: E402
from repro.serve import ServeConfig as JaxServeConfig  # noqa: E402
from repro.serve import run_server as jax_run_server  # noqa: E402
from repro.serve.engine import synthetic_requests as jax_requests  # noqa: E402
from repro.train import Trainer as JaxTrainer  # noqa: E402
from repro.train import TrainerConfig as JaxTrainerConfig  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import pipeline as data  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import encdec, lm  # noqa: E402
from repro_torch.serve.engine import (  # noqa: E402
    Engine,
    ServeConfig,
    synthetic_requests,
)
from repro_torch.serve.request import Request  # noqa: E402
from repro_torch.serve.scenarios import run_server  # noqa: E402
from repro_torch.train import Trainer, TrainerConfig  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402

ARCH = "whisper-medium"
FP32 = dict(dtype="float32", kv_cache_dtype="float32")
PAGED = dict(max_batch=2, max_len=32, kv_layout="paged", page_size=4,
             prefill_chunk=4)
WORK = dict(n=4, tokens=4, prompt_len=10, scenario="server", seed=5)
PREFIX = dict(max_batch=3, max_len=40, kv_layout="paged", page_size=4,
              prefill_chunk=4)
PREFIX_WORK = dict(n=6, tokens=5, prompt_len=12, scenario="server", seed=3,
                   shared_prefix_len=8, n_templates=2)


def cfgs(**kw):
    kw = {**FP32, **kw}
    return (dataclasses.replace(jax_get_config(ARCH).reduced(), **kw),
            dataclasses.replace(get_config(ARCH).reduced(), **kw))


@pytest.fixture(scope="module")
def model():
    jcfg, cfg = cfgs()
    vals = jax.jit(lambda k: split_tree(jed.init_encdec(jcfg, k))[0])(
        jax.random.PRNGKey(0))
    tree = lm.perturb_norms(jax.tree_util.tree_map(np.asarray, vals), 100)
    return jcfg, cfg, tree, encdec.params_from_numpy(tree, cfg, device="cpu")


def port_requests(jreqs, media=None):
    """The reference's requests for the port's engine: prompts, budgets,
    arrivals, ids and media (``media``: replacement arrays, one a
    request)."""
    return [Request(prompt=list(r.prompt), max_new_tokens=r.max_new_tokens,
                    media=np.asarray(r.media if media is None else media[i]),
                    arrival_step=r.arrival_step, id=r.id,
                    template=r.template)
            for i, r in enumerate(jreqs)]


def tokens_of(report):
    return [list(r.tokens) for r in sorted(report.requests,
                                           key=lambda r: r.id)]


def serve_ref(model, knobs, work):
    jcfg, _, tree, _ = model
    jreqs = jax_requests(jcfg, **work)
    report = jax_run_server(JaxEngine(jcfg, tree, None,
                                      JaxServeConfig(**knobs)), jreqs)
    return jax_requests(jcfg, **work), report


def serve_port(model, knobs, jreqs, media=None):
    _, cfg, _, params = model
    eng = Engine(cfg, params, ServeConfig(**knobs), device="cpu")
    return eng, run_server(eng, port_requests(jreqs, media))


@pytest.fixture(scope="module")
def paged_ref(model):
    return serve_ref(model, PAGED, WORK)


# --------------------------------------------------------------------------- #
def test_paged_and_slab_engines_match_reference(model, paged_ref):
    jreqs, want = paged_ref
    eng, got = serve_port(model, PAGED, jreqs)
    assert eng.layout == "paged"
    assert tokens_of(got) == tokens_of(want)
    assert all(len(t) == WORK["tokens"] for t in tokens_of(got))
    encodes = [s for s in got.steps if s.kind == "encode"]
    assert len(encodes) == WORK["n"] and all(s.n_tokens == 0
                                             for s in encodes)
    slab = dict(max_batch=2, max_len=32, prefill_len=16, kv_layout="slab")
    _, want_slab = serve_ref(model, slab, WORK)
    eng_s, got_slab = serve_port(model, slab, jreqs)
    assert eng_s.layout == "slab"
    assert tokens_of(got_slab) == tokens_of(want_slab) == tokens_of(got)


def test_int8_pool_matches_reference(model):
    knobs = dict(PAGED, kv_dtype="int8")
    jreqs, want = serve_ref(model, knobs, WORK)
    eng, got = serve_port(model, knobs, jreqs)
    assert tokens_of(got) == tokens_of(want)
    eng.reset()
    assert eng._cache["self"]["kp"].dtype == torch.int8
    assert eng._cache["cross"][0]["k"].dtype == torch.int8
    assert "k_scale" in eng._cache["cross"][0]


def test_prefix_cache_shares_pages_only_under_the_same_media(model):
    knobs = dict(PREFIX, prefix_cache=True)
    jreqs, want = serve_ref(model, knobs, PREFIX_WORK)
    _, got = serve_port(model, knobs, jreqs)
    _, off = serve_port(model, PREFIX, jreqs)
    assert tokens_of(got) == tokens_of(want) == tokens_of(off)
    assert got.prefix_hit_rate == want.prefix_hit_rate > 0
    assert got.pages_shared == want.pages_shared > 0
    assert got.prefill_tokens_skipped == want.prefill_tokens_skipped
    # same templates, every request its own media: nothing may match
    other = [np.asarray(r.media) + 1e-3 * i for i, r in enumerate(jreqs)]
    _, miss = serve_port(model, knobs, jreqs, other)
    _, miss_off = serve_port(model, PREFIX, jreqs, other)
    assert miss.prefix_hit_rate == 0 and miss.pages_shared == 0
    assert tokens_of(miss) == tokens_of(miss_off)


def test_ngram_drafts_match_reference(model, paged_ref):
    knobs = dict(PAGED, spec_decode="ngram", draft_len=3)
    jreqs, want = serve_ref(model, knobs, WORK)
    _, got = serve_port(model, knobs, jreqs)
    assert tokens_of(got) == tokens_of(want) == tokens_of(paged_ref[1])
    assert got.draft_tokens == want.draft_tokens > 0
    assert got.spec_accept_rate == want.spec_accept_rate


def test_preemption_and_defrag_leave_the_cross_slab(model, paged_ref):
    """A pool of 5 pages for 2 slots of up to 4 (the preempted request
    re-prefills and re-encodes), then a defrag mid-flight on the plain
    pool: the reference's tokens either way."""
    jreqs, want = paged_ref
    eng, tight = serve_port(model, dict(PAGED, n_pages=5), jreqs)
    assert tight.preemptions > 0
    assert tokens_of(tight) == tokens_of(want)
    _, cfg, _, params = model
    eng = Engine(cfg, params, ServeConfig(**PAGED), device="cpu")
    for r in port_requests(jreqs):
        eng.submit(r)
    for _ in range(5):
        eng.step()
    cross = [c["k"].clone() for c in eng._cache["cross"]]
    eng.defrag()
    assert all(torch.equal(a, c["k"]) for a, c in zip(cross,
                                                      eng._cache["cross"]))
    eng.drain()
    assert tokens_of(eng.finalize(0.0)) == tokens_of(want)


def test_trainer_trajectory_and_eval_match_reference():
    jcfg, cfg = cfgs()
    jtr = JaxTrainer(jcfg, single_device_mesh(),
                     JaxTrainerConfig(total_steps=3, eval_every=3,
                                      log_every=0))
    tree = jax.tree_util.tree_map(np.asarray, jtr.state["params"])
    kw = dict(batch=4, seq=16, steps=3, seed=0)
    ev = dict(batch=4, seq=16)
    for a, b in zip(jax_data.synthetic_lm_batches(jcfg, **kw),
                    data.synthetic_lm_batches(cfg, **kw)):
        assert set(a) == set(b) == {"tokens", "media"}
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    want = jtr.fit(jax_data.synthetic_lm_batches(jcfg, **kw),
                   jax_data.synthetic_eval_set(jcfg, **ev))
    tr = Trainer(cfg, TrainerConfig(total_steps=3, eval_every=3, log_every=0),
                 device="cpu", params=encdec.params_from_numpy(
                     tree, cfg, device="cpu", dtype=torch.float32))
    got = tr.fit(data.synthetic_lm_batches(cfg, **kw),
                 data.synthetic_eval_set(cfg, **ev))
    for key in ("loss", "nll"):
        np.testing.assert_allclose([r[key] for r in got],
                                   [r[key] for r in want], rtol=1e-4)
    np.testing.assert_allclose(got[-1]["eval_nll"], want[-1]["eval_nll"],
                               rtol=1e-4)
    assert got[0]["loss"] > got[-1]["loss"]
    # checkpoints name the state as the reference's tree flattens
    names, _ = ckpt._flatten_with_names(tr.checkpoint_tree())
    flat, _ = jax.tree_util.tree_flatten_with_path(jtr.state)
    assert names == [jax.tree_util.keystr(p) for p, _ in flat]
    assert "['params']['dec_blocks']['cross_attn']['wq']" in names


def test_cli_resume_equals_uninterrupted_run(tmp_path, capsys):
    base = ["--arch", ARCH, "--device", "cpu", "--steps", "4", "--batch",
            "2", "--seq", "16"]
    assert train_cli.main(base + ["--checkpoint-every", "2",
                                  "--checkpoint-dir",
                                  str(tmp_path / "a")]) == 0
    full = capsys.readouterr().out.splitlines()
    assert train_cli.main(base + ["--resume", str(tmp_path / "a" / "step_2"),
                                  "--checkpoint-dir",
                                  str(tmp_path / "b")]) == 0
    cont = capsys.readouterr().out.splitlines()
    strip = lambda ln: ln.split(" (")[0]  # noqa: E731 — drop the wall time
    assert cont[0].startswith("step 3: loss=")
    assert [strip(x) for x in cont[:2]] == [strip(x) for x in full[2:4]]


def test_synthetic_media_and_cli(capsys):
    """The port's own media: one (enc_source_len, d) fp32 array a
    request from a seeded generator, shared per template; the CLI serves
    whisper on the CPU."""
    cfg = get_config(ARCH).reduced()
    reqs = synthetic_requests(cfg, n=4, tokens=2, prompt_len=8, seed=0,
                              shared_prefix_len=4, n_templates=2)
    assert reqs[0].media.shape == (cfg.enc_source_len, cfg.d_model)
    assert reqs[0].media.dtype == np.float32
    assert np.array_equal(reqs[0].media, reqs[2].media)
    assert not np.array_equal(reqs[0].media, reqs[1].media)
    again = synthetic_requests(cfg, n=2, tokens=2, prompt_len=8, seed=0)
    assert np.array_equal(again[1].media, synthetic_requests(
        cfg, n=2, tokens=2, prompt_len=8, seed=0)[1].media)
    assert not np.array_equal(again[0].media, again[1].media)
    assert serve_cli.main(["--arch", ARCH, "--device", "cpu", "--tokens",
                           "3", "--batch", "2"]) == 0
    out = capsys.readouterr().out
    assert out.startswith("whisper-medium [offline, device=cpu, slots=2, "
                          "kv=paged]: 2 requests, 6 tokens")
