"""The port's slab serving path against the JAX reference: reduced
jamba-1.5-large (Mamba, MoE and attention layers) in fp32 — prefill
logits and caches, then 4 decode steps — and the slab engine's greedy
tokens; the slab KV pieces (per-row insert, int8 too; decode attention
with a window; slot write and invalidation); reduced gemma-7b on the
slab against the paged layout in the port; the layout refusals with the
reference's exception types; the CLI on the CPU."""
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
from repro.kernels import ops as jax_ops  # noqa: E402
from repro.models import layers as jax_layers  # noqa: E402
from repro.models import lm as jax_lm  # noqa: E402
from repro.serve import Engine as JaxEngine  # noqa: E402
from repro.serve import ServeConfig as JaxServeConfig  # noqa: E402
from repro.serve import cache as jax_slab  # noqa: E402
from repro.serve import run_offline as jax_run_offline  # noqa: E402
from repro.serve.engine import synthetic_requests as jax_requests  # noqa: E402
from repro.train.steps import ModelAPI  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.serve import cache as slab  # noqa: E402
from repro_torch.serve.engine import (  # noqa: E402
    Engine,
    ServeConfig,
    synthetic_requests,
)
from repro_torch.serve.request import Request  # noqa: E402
from repro_torch.serve.scenarios import run_offline  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")
JAMBA = "jamba-1.5-large-398b"
FP32 = dict(dtype="float32", kv_cache_dtype="float32")


def _models(arch):
    ref_cfg = dataclasses.replace(jax_get_config(arch).reduced(), **FP32)
    cfg = dataclasses.replace(get_config(arch).reduced(), **FP32)
    # jitted init: one compile instead of one per eager op
    vals = jax.jit(lambda k: split_tree(ModelAPI(ref_cfg).init(ref_cfg, k))[0])(
        jax.random.PRNGKey(0))
    params = lm.params_from_numpy(jax.tree_util.tree_map(np.asarray, vals),
                                  cfg, device="cpu")
    return ref_cfg, vals, cfg, params


@pytest.fixture(scope="module")
def jamba():
    return _models(JAMBA)


def _close_to(got, want, what):
    """Within 1e-4 of the reference's largest entry."""
    want = np.asarray(want)
    err = np.abs(np.asarray(got) - want).max()
    assert err <= 1e-4 * np.abs(want).max(), f"{what}: {err}"


def test_reduced_jamba_has_every_layer_kind(jamba):
    _, _, cfg, params = jamba
    kinds = [(s.mixer, s.ffn) for s in cfg.block_pattern]
    assert kinds == [("mamba", "dense"), ("mamba", "moe"), ("attn", "dense")]
    assert "head" in params and params["head"].shape == (cfg.d_model,
                                                         cfg.vocab)
    mamba = params["layers"][0]["mixer"]
    assert mamba["x_proj"].dtype == torch.float32
    assert params["layers"][1]["ffn"]["router"].dtype == torch.float32


def test_prefill_and_decode_match_reference(jamba):
    """Prefill of 2 rows of 11 tokens into a 16-slot cache, then 4 greedy
    decode steps at per-row positions: logits within 1e-4 of the largest,
    caches (Mamba conv and SSM state, attention K/V and slot map)
    alike."""
    ref_cfg, vals, cfg, params = jamba
    toks = np.random.RandomState(0).randint(0, cfg.vocab, (2, 11))
    want, wcache = jax_lm.prefill(vals, ref_cfg, jnp.asarray(toks, jnp.int32),
                                  cache_len=16)
    with torch.inference_mode():
        got, cache = lm.prefill(params, cfg, torch.from_numpy(toks),
                                cache_len=16)
    _close_to(got.numpy(), want, "prefill logits")
    P = len(cfg.block_pattern)
    for i, layer in enumerate(cache):
        ref = jax.tree_util.tree_map(lambda a: np.asarray(a)[i // P],
                                     wcache[i % P])
        assert sorted(layer) == sorted(ref)
        for name, t in layer.items():
            if name == "slot_pos":
                np.testing.assert_array_equal(t.numpy(), ref[name])
            else:
                np.testing.assert_allclose(t.numpy(), ref[name], rtol=1e-4,
                                           atol=1e-5, err_msg=name)
    pos = np.array([11, 11], np.int32)
    tok = np.argmax(np.asarray(want), -1)[:, None]
    for step in range(4):
        want, wcache = jax_lm.decode_step(vals, ref_cfg,
                                          jnp.asarray(tok, jnp.int32),
                                          wcache, jnp.asarray(pos))
        with torch.inference_mode():
            got, cache = lm.decode_step(params, cfg, torch.from_numpy(tok),
                                        cache, torch.from_numpy(pos))
        _close_to(got.numpy(), want, f"decode step {step}")
        tok = np.argmax(np.asarray(want), -1)[:, None]
        pos = pos + 1


def _ids(reqs, base=1000):
    for i, r in enumerate(reqs):
        r.id = base + i
    return reqs


def _tokens(report):
    return [r.tokens for r in sorted(report.requests, key=lambda r: r.id)]


def test_slab_engine_tokens_identical_to_reference(jamba):
    ref_cfg, vals, cfg, params = jamba
    knobs = dict(max_batch=3, max_len=32)
    work = dict(n=5, tokens=6, prompt_len=14, prompt_lens=(3, 9, 14, 5, 11))
    want = jax_run_offline(
        JaxEngine(ref_cfg, vals, None, JaxServeConfig(kv_layout="slab",
                                                      **knobs)),
        _ids(jax_requests(ref_cfg, scenario="offline", seed=7, **work)))
    eng = Engine(cfg, params, ServeConfig(**knobs), device="cpu")
    assert eng.layout == "slab"
    got = run_offline(eng, _ids(synthetic_requests(cfg, seed=7, **work)))
    assert _tokens(got) == _tokens(want)
    assert all(len(t) == work["tokens"] for t in _tokens(got))
    assert [s.kind for s in got.steps].count("prefill") == 5


def test_gemma_slab_tokens_equal_paged_and_reference():
    ref_cfg, vals, cfg, params = _models("gemma-7b")
    cfg, ref_cfg = (dataclasses.replace(c, n_layers=1) for c in (cfg,
                                                                ref_cfg))
    params["layers"] = params["layers"][:1]
    vals = {**vals, "blocks": jax.tree_util.tree_map(lambda a: a[:1],
                                                     vals["blocks"])}
    work = dict(n=5, tokens=6, prompt_len=14, prompt_lens=(3, 9, 14, 5, 11))
    slab_knobs = dict(max_batch=3, max_len=32, prefill_len=16)
    got = run_offline(
        Engine(cfg, params, ServeConfig(kv_layout="slab", **slab_knobs),
               device="cpu"),
        synthetic_requests(cfg, seed=7, **work))
    paged = run_offline(
        Engine(cfg, params, ServeConfig(max_batch=3, max_len=32, page_size=4,
                                        prefill_chunk=4), device="cpu"),
        synthetic_requests(cfg, seed=7, **work))
    assert _tokens(got) == _tokens(paged)
    want = jax_run_offline(
        JaxEngine(ref_cfg, vals, None, JaxServeConfig(kv_layout="slab",
                                                      **slab_knobs)),
        jax_requests(ref_cfg, scenario="offline", seed=7, **work))
    assert _tokens(got) == _tokens(want)


@pytest.mark.parametrize("kv", ["float32", "int8"])
def test_per_row_cache_insert_matches_reference(kv):
    ref_cfg = dataclasses.replace(jax_get_config("gemma-7b").reduced(),
                                  dtype="float32", kv_cache_dtype=kv)
    cfg = dataclasses.replace(get_config("gemma-7b").reduced(),
                              dtype="float32", kv_cache_dtype=kv)
    B, Lc, K, hd = 3, 6, cfg.n_kv_heads, cfg.head_dim
    rng = np.random.default_rng(0)
    wcache = jax_layers.init_kv_cache(ref_cfg, B, Lc)
    cache = L.init_kv_cache(cfg, B, Lc, device="cpu")
    assert {k: v.shape for k, v in cache.items()} == {
        k: tuple(v.shape) for k, v in wcache.items()}
    for pos in ([0, 3, 5], [7, 4, 6], 2):  # rings wrap past L; a scalar
        k_new = rng.standard_normal((B, K, hd)).astype(np.float32)
        v_new = rng.standard_normal((B, K, hd)).astype(np.float32)
        wcache = jax_layers.cache_insert(wcache, jnp.asarray(k_new),
                                         jnp.asarray(v_new),
                                         jnp.asarray(pos, jnp.int32))
        L.cache_insert(cache, torch.from_numpy(k_new),
                       torch.from_numpy(v_new), torch.tensor(pos))
    for name, t in cache.items():
        np.testing.assert_array_equal(t.numpy(), np.asarray(wcache[name]),
                                      err_msg=name)
    if kv == "float32":
        return
    with pytest.raises(TypeError, match="quantization scales"):
        bare = {k: v for k, v in cache.items() if "scale" not in k}
        L.cache_insert(bare, torch.zeros(B, K, hd), torch.zeros(B, K, hd), 0)


@pytest.mark.parametrize("window", [None, 3])
def test_decode_attention_matches_reference(window):
    rng = np.random.default_rng(1)
    B, Lc, H, K, D = 3, 8, 4, 2, 16
    q = rng.standard_normal((B, 1, H, D)).astype(np.float32)
    k = rng.standard_normal((B, Lc, K, D)).astype(np.float32)
    v = rng.standard_normal((B, Lc, K, D)).astype(np.float32)
    sp = np.array([[0, 1, 2, 3, -1, -1, -1, -1], [8, 9, 2, 3, 4, 5, 6, 7],
                   [-1] * 8], np.int32)  # a ring that wrapped; an idle row
    pos = np.array([3, 9, 0], np.int32)
    want = jax_ops._decode_attention_jnp(
        *map(jnp.asarray, (q, k, v, sp)), pos=jnp.asarray(pos),
        window=window, scale=None, k_scale=None, v_scale=None)
    from repro_torch.kernels import ops

    got = ops.decode_attention(*map(torch.from_numpy, (q, k, v, sp)),
                               pos=torch.from_numpy(pos), window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_write_slot_and_invalidate_match_reference(jamba):
    ref_cfg, vals, cfg, params = jamba
    toks = np.random.RandomState(2).randint(0, cfg.vocab, (1, 7))
    _, wc = jax_lm.prefill(vals, ref_cfg, jnp.asarray(toks, jnp.int32),
                           cache_len=12)
    wslab = jax_slab.write_slot(
        jax_lm.init_cache(ref_cfg, 3, 12),
        jax_slab.invalidate_beyond(wc, jnp.asarray([5])), jnp.int32(1))
    with torch.inference_mode():
        _, c = lm.prefill(params, cfg, torch.from_numpy(toks), cache_len=12)
        s = slab.write_slot(slab.init_slab(cfg, 3, 12, device="cpu"),
                            slab.invalidate_beyond(c, torch.tensor([5])), 1)
    P = len(cfg.block_pattern)
    for i, layer in enumerate(s):
        for name, t in layer.items():
            want = np.asarray(wslab[i % P][name])[i // P]
            np.testing.assert_allclose(t.numpy(), want, rtol=1e-4, atol=1e-5,
                                       err_msg=name)
    got = slab.read_slot(s, 1)
    assert all(torch.equal(a[name], b[name][1:2])
               for a, b in zip(got, s) for name in a)
    assert (s[2]["slot_pos"][1] == torch.tensor(
        [0, 1, 2, 3, 4] + [-1] * 7, dtype=torch.int32)).all()


def test_layout_refusals_match_reference(jamba):
    """The reference's refusals, with its exception types: the paged
    layout, the prefix cache and drafts on a recurrent stack; int4 on
    the slab; a prompt over prefill_len on a padded slab; defrag of a
    slab."""
    ref_cfg, vals, cfg, params = jamba
    g_ref = jax_get_config("gemma-7b").reduced()
    g_cfg = get_config("gemma-7b").reduced()
    g_params = lm.init_lm(g_cfg, 0, device="cpu")
    cases = [
        (ref_cfg, cfg, params, dict(kv_layout="paged"), "attention-only"),
        (ref_cfg, cfg, params, dict(prefix_cache=True), "prefix_cache"),
        (ref_cfg, cfg, params, dict(spec_decode="ngram"), "paged"),
        (g_ref, g_cfg, g_params, dict(kv_layout="slab", kv_dtype="int4"),
         "int4"),
    ]
    for rc, c, p, knobs, match in cases:
        with pytest.raises(ValueError, match=match):
            JaxEngine(rc, None, None, JaxServeConfig(**knobs))
        with pytest.raises(ValueError, match=match):
            Engine(c, p, ServeConfig(**knobs), device="cpu")
    with pytest.raises(ValueError, match="attention-only"):
        jax_lm.init_paged_cache(ref_cfg, 4, 4)
    with pytest.raises(ValueError, match="attention-only"):
        lm.init_paged_cache(cfg, 4, 4, device="cpu")
    eng = Engine(g_cfg, g_params, ServeConfig(kv_layout="slab", max_len=32,
                                              prefill_len=8), device="cpu")
    with pytest.raises(ValueError, match="prefill_len"):
        eng.submit(Request(prompt=[1] * 9, max_new_tokens=2))
    with pytest.raises(ValueError, match="paged-layout"):
        eng.defrag()
    with pytest.raises(ValueError, match="prefill_len exceeds max_len"):
        ServeConfig(kv_layout="slab", max_len=16, prefill_len=32)
    # a recurrent stack prefills at the exact length: prefill_len unused
    jeng = Engine(cfg, params, ServeConfig(max_len=32, prefill_len=4),
                  device="cpu")
    jeng.submit(Request(prompt=[1] * 9, max_new_tokens=2))


def test_serve_cli_serves_jamba_on_cpu():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", JAMBA,
         "--device", "cpu", "--kv-layout", "slab", "--tokens", "3",
         "--batch", "2"],
        capture_output=True, text=True, env=env, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert lines[0].startswith(f"{JAMBA} [offline, device=cpu, slots=2, "
                               f"kv=slab]: 2 requests, 6 tokens")
    assert [ln.split(":")[0] for ln in lines[1:]] == ["  req 0", "  req 1"]
    assert all("-> 3 tokens" in ln for ln in lines[1:])
