"""yi-9b, qwen1.5-32b, command-r-35b, mixtral-8x7b and grok-1-314b in the
port against the JAX reference on the same numpy weights: the config
copies, forward logits, the paged engine's greedy tokens (qwen from its
int8 pool) and a train step's loss and every gradient, each arch
reduced; GQA at 4/2 and 6/2 heads; LayerNorm and the q/k/v biases layer
by layer; the norm leaves kept in fp32 at a bf16 compute dtype; and
mixtral served past its window, which neither side applies.

Tolerances: fp32 logits rtol 1e-4 / atol 1e-5, fp32 gradients rtol
1e-4 / atol 1e-6, losses rtol 1e-5 (both sides fp32, sums in other
orders); greedy tokens exactly."""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.dist import Rules, split_tree  # noqa: E402
from repro.launch.mesh import single_device_mesh  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import lm as jax_lm  # noqa: E402
from repro.optim.base import Optimizer as JaxOptimizer  # noqa: E402
from repro.serve import Engine as JaxEngine  # noqa: E402
from repro.serve import ServeConfig as JaxServeConfig  # noqa: E402
from repro.serve import run_offline as jax_run_offline  # noqa: E402
from repro.serve.engine import synthetic_requests as jax_requests  # noqa: E402
from repro.train import steps as JT  # noqa: E402
from repro_torch.configs import get_config, list_archs  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.data import pipeline as data  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.optim.base import Optimizer  # noqa: E402
from repro_torch.serve.engine import (  # noqa: E402
    Engine,
    ServeConfig,
    synthetic_requests,
)
from repro_torch.serve.scenarios import run_offline  # noqa: E402
from repro_torch.train import steps as T  # noqa: E402

ARCHS = ("yi-9b", "qwen1.5-32b", "command-r-35b", "mixtral-8x7b",
         "grok-1-314b")
# The reduced models in fp32 compute on both sides; each keeps its
# config's KV pool dtype when quantized (qwen1.5-32b: int8), fp32
# otherwise. Gradients are summed in fp32 here; grok's bf16 path has its
# own test (tests/test_torch_moe_train.py).
SERVE_KNOBS = dict(max_batch=3, max_len=40, page_size=4, prefill_chunk=8)
WORK = dict(n=5, tokens=6, prompt_len=24, prompt_lens=(3, 17, 24, 5, 11))


def cfgs(arch, **kw):
    """The same reduced ``arch`` on both sides, fp32 compute and grads
    (a quantized KV pool kept), with ``kw`` applied to both."""
    base = jax_get_config(arch).reduced()
    kv = (base.kv_cache_dtype if base.kv_cache_dtype in ("int8", "int4")
          else "float32")
    kw = dict(dict(dtype="float32", kv_cache_dtype=kv,
                   grad_dtype="float32"), **kw)
    return (dataclasses.replace(base, **kw),
            dataclasses.replace(get_config(arch).reduced(), **kw))


def ref_tree(jcfg, seed=0):
    """The reference's parameters for ``jcfg`` as numpy, perturbed."""
    vals = split_tree(JT.ModelAPI(jcfg).init(jcfg, jax.random.PRNGKey(seed)))
    return lm.perturb_norms(vals[0], seed + 100)


def flat_jax_grads(g, n_layers):
    """The reference's gradient tree in the port's layout: one dict per
    layer instead of leaves stacked over blocks (layer i is pattern
    position i % P of block i // P)."""
    blocks = g["blocks"]
    P = len(blocks)
    out = {k: v for k, v in g.items() if k != "blocks"}
    out["layers"] = [jax.tree_util.tree_map(
        lambda a, i=i: np.asarray(a)[i // P], blocks[i % P])
        for i in range(n_layers)]
    return out


def tokens_of(report):
    return [r.tokens for r in sorted(report.requests, key=lambda r: r.id)]


def serve_both(jcfg, cfg, tree, knobs=SERVE_KNOBS, work=WORK, seed=7):
    """Greedy tokens of the reference's and the port's paged engines on
    the same offline workload."""
    want = jax_run_offline(
        JaxEngine(jcfg, tree, None, JaxServeConfig(kv_layout="paged",
                                                   **knobs)),
        jax_requests(jcfg, scenario="offline", seed=seed, **work))
    eng = Engine(cfg, lm.params_from_numpy(tree, cfg, device="cpu"),
                 ServeConfig(**knobs), device="cpu")
    assert eng.layout == "paged"
    got = run_offline(eng, synthetic_requests(cfg, seed=seed, **work))
    return tokens_of(want), tokens_of(got), eng


def capture():
    """An optimizer on each side whose update leaves the weights and
    returns the gradient it was given as its state."""
    return (JaxOptimizer("capture", lambda p: {},
                         lambda g, s, p, step=None: (p, g)),
            Optimizer("capture", lambda p: {},
                      lambda g, s, p, step=None: (p, g)))


def train_step_both(jcfg, cfg, tree, tokens, jopt=None, opt=None):
    """One step of each side's ``make_train_step`` (the reference's
    with its rules and axes, so ``compute_cast`` runs) from the same
    weights and batch. Returns ((ref state, ref metrics), (state,
    metrics))."""
    if jopt is None:
        jopt, opt = capture()
    _, axes = JT.init_params_and_axes(jcfg, jax.random.PRNGKey(0))
    mesh = single_device_mesh()
    rules = Rules(mesh, jcfg.param_sharding, seq_parallel=jcfg.seq_parallel)
    jstep = JT.make_train_step(jcfg, jopt, rules, axes)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    with mesh:
        want = jax.jit(jstep)({"params": jparams,
                               "opt": jopt.init(jparams)},
                              {"tokens": jnp.asarray(tokens)})
    params = lm.params_from_numpy(tree, cfg, device="cpu",
                                  dtype=torch.float32)
    step = T.make_train_step(cfg, opt)
    got = step({"params": params, "opt": opt.init(params)},
               {"tokens": torch.from_numpy(tokens)})
    return want, got


def assert_grads_match(want_tree, got_list, n_layers, rtol=1e-4, atol=1e-6):
    want = jax.tree_util.tree_leaves(flat_jax_grads(want_tree, n_layers))
    assert len(got_list) == len(want)
    for g, w in zip(got_list, want):
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w, np.float32), rtol=rtol,
                                   atol=atol)


def _plain(value):
    if dataclasses.is_dataclass(value):
        return dataclasses.asdict(value)
    if isinstance(value, tuple):
        return [_plain(v) for v in value]
    return value


# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", ARCHS)
def test_config_fields_match_reference(arch):
    assert arch in list_archs()
    for reduce in (False, True):
        ref, cfg = jax_get_config(arch), get_config(arch)
        if reduce:
            ref, cfg = ref.reduced(), cfg.reduced()
        for f in dataclasses.fields(ModelConfig):
            assert _plain(getattr(cfg, f.name)) == _plain(
                getattr(ref, f.name)), (arch, reduce, f.name)
        assert cfg.param_count() == ref.param_count()
    assert get_config(arch.replace("-", "_").replace(".", "_")) is \
        get_config(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_match_reference(arch):
    jcfg, cfg = cfgs(arch)
    tree = ref_tree(jcfg, seed=1)
    tokens = data._zipf_tokens(np.random.default_rng(4), (2, 33), cfg.vocab)
    want, _ = jax_lm.forward(tree, jcfg, tokens)
    with torch.no_grad():
        got = lm.forward(lm.params_from_numpy(tree, cfg, device="cpu"), cfg,
                         torch.from_numpy(tokens))
    assert got.shape == (2, 33, cfg.vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_engine_tokens_match_reference(arch):
    jcfg, cfg = cfgs(arch)
    want, got, eng = serve_both(jcfg, cfg, ref_tree(jcfg, seed=2))
    assert got == want
    assert all(len(t) == WORK["tokens"] for t in got)
    if arch == "qwen1.5-32b":  # served from its config's int8 pool
        assert eng.cfg.kv_cache_dtype == "int8"
        assert eng._cache["kp"].dtype == torch.int8 and "kp_scale" in \
            eng._cache


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_loss_and_every_gradient_match_reference(arch):
    jcfg, cfg = cfgs(arch)
    tree = ref_tree(jcfg, seed=3)
    tokens = data._zipf_tokens(np.random.default_rng(5), (4, 24), cfg.vocab)
    (wstate, wm), (state, m) = train_step_both(jcfg, cfg, tree, tokens)
    np.testing.assert_allclose(m["loss"].item(), float(wm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(m["nll"].item(), float(wm["nll"]), rtol=1e-5)
    if cfg.uses_moe:  # the aux term is in the loss
        assert m["loss"].item() > m["nll"].item()
    assert_grads_match(wstate["opt"], state["opt"], cfg.n_layers)


@pytest.mark.parametrize("heads", [(4, 2), (6, 2)])
@pytest.mark.parametrize("arch", ["yi-9b", "mixtral-8x7b"])
def test_gqa_groups_of_2_and_3_match_reference(arch, heads):
    """reduced() makes these archs MHA (4/4 heads): GQA set on both
    sides, head_dim 32, so the groups are 2 and 3."""
    H, K = heads
    jcfg, cfg = cfgs(arch, n_heads=H, n_kv_heads=K, head_dim=32)
    tree = ref_tree(jcfg, seed=4)
    tokens = data._zipf_tokens(np.random.default_rng(6), (2, 24), cfg.vocab)
    want, _ = jax_lm.forward(tree, jcfg, tokens)
    with torch.no_grad():
        got = lm.forward(lm.params_from_numpy(tree, cfg, device="cpu"), cfg,
                         torch.from_numpy(tokens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)
    want_t, got_t, _ = serve_both(jcfg, cfg, tree)
    assert got_t == want_t
    (wstate, wm), (state, m) = train_step_both(jcfg, cfg, tree, tokens)
    np.testing.assert_allclose(m["loss"].item(), float(wm["loss"]),
                               rtol=1e-5)
    assert_grads_match(wstate["opt"], state["opt"], cfg.n_layers)


# ---- LayerNorm and the q/k/v biases, layer by layer ------------------------ #
def test_layernorm_matches_reference():
    jcfg, cfg = cfgs("command-r-35b")
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 9, cfg.d_model)).astype(np.float32) * 3 + 1
    prm = {"scale": (1 + 0.1 * rng.standard_normal(cfg.d_model)
                     ).astype(np.float32),
           "bias": (0.1 * rng.standard_normal(cfg.d_model)).astype(np.float32)}
    want = JL.apply_norm({k: jnp.asarray(v) for k, v in prm.items()},
                         jnp.asarray(x), jcfg)
    got = L.apply_norm({k: torch.from_numpy(v) for k, v in prm.items()},
                       torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    # init: fp32 ones and zeros, as the reference's
    ref = JL.init_norm(jcfg, cfg.d_model)
    mine = L.init_norm(cfg, device="cpu")
    assert set(mine) == set(ref) == {"scale", "bias"}
    for k in mine:
        assert mine[k].dtype == torch.float32
        np.testing.assert_array_equal(mine[k].numpy(), np.asarray(ref[k][0]))
    assert set(L.init_norm(cfgs("yi-9b")[1], device="cpu")) == {"scale"}


def _attn_case(seed=8):
    jcfg, cfg = cfgs("qwen1.5-32b", n_heads=4, n_kv_heads=2, head_dim=32,
                     kv_cache_dtype="float32")
    layer = ref_tree(jcfg, seed)["blocks"][0]
    jprm = {k: np.array(v[0]) for k, v in layer["mixer"].items()}
    assert {"bq", "bk", "bv"} <= set(jprm)
    prm = {k: torch.from_numpy(v) for k, v in jprm.items()}
    return jcfg, cfg, jax.tree_util.tree_map(jnp.asarray, jprm), prm


def test_qkv_bias_attention_full_matches_reference():
    jcfg, cfg, jprm, prm = _attn_case()
    x = np.random.default_rng(9).standard_normal((2, 11, cfg.d_model)
                                                 ).astype(np.float32)
    pos = np.broadcast_to(np.arange(11), (2, 11))
    want, (wk, wv) = JL.attention_full(jprm, jnp.asarray(x), jcfg,
                                       positions=jnp.asarray(pos))
    got, (k, v) = L.attention_full(prm, torch.from_numpy(x), cfg,
                                   positions=torch.from_numpy(pos.copy()))
    for a, b in ((got, want), (k, wk), (v, wv)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-5)
    # the biases are in: dropping them changes the output
    bare = {n: t for n, t in prm.items() if not n.startswith("b")}
    nob, _ = L.attention_full(bare, torch.from_numpy(x), cfg,
                              positions=torch.from_numpy(pos.copy()))
    assert (nob - got).abs().max() > 1e-3


def test_qkv_bias_paged_and_slab_decode_match_reference():
    jcfg, cfg, jprm, prm = _attn_case(seed=10)
    rng = np.random.default_rng(11)
    B, C, page, P = 2, 3, 4, 6
    x = rng.standard_normal((B, C, cfg.d_model)).astype(np.float32)
    pt = np.array([[0, 1, -1], [2, -1, -1]], np.int32)
    pos = np.array([2, 0], np.int32)
    nv = np.array([3, 2], np.int32)
    jcache = JL.init_paged_kv_cache(jcfg, P, page)
    want, _ = JL.attention_decode_paged(
        jprm, jnp.asarray(x), jcfg, jcache, jnp.asarray(pt),
        jnp.asarray(pos), jnp.asarray(nv))
    cache = L.init_paged_kv_cache(cfg, P, page, device="cpu")
    cache = {k: v[0] for k, v in cache.items()}
    got = L.attention_decode_paged(prm, torch.from_numpy(x), cfg, cache,
                                   torch.from_numpy(pt), torch.from_numpy(pos),
                                   torch.from_numpy(nv))
    for b in range(B):
        np.testing.assert_allclose(got[b, :nv[b]].numpy(),
                                   np.asarray(want)[b, :nv[b]], rtol=1e-4,
                                   atol=1e-5)
    # slab: one token against a cache of 5 slots at per-row positions
    x1 = x[:, :1]
    posv = np.array([3, 1], np.int32)
    jslab = JL.init_kv_cache(jcfg, B, 5)
    want, _ = JL.attention_decode(jprm, jnp.asarray(x1), jcfg, jslab,
                                  pos=jnp.asarray(posv))
    slab = L.init_kv_cache(cfg, B, 5, device="cpu")
    got, _ = L.attention_decode(prm, torch.from_numpy(x1), cfg, slab,
                                pos=torch.from_numpy(posv))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)


# ---- the norm leaves stay fp32 at a bf16 compute dtype --------------------- #
BF16_NOISE = 0.0625  # 2 bf16 ulps at 8, the logits' size here


def test_norm_leaves_stay_fp32_so_bf16_serving_matches_reference():
    """Reduced gemma-7b with norm scales 1 + 0.1 N(0, 1), bridged at
    bf16. The norm leaves stay fp32 and exact, as the reference reads
    them; each of the model's norms applied to the same bf16 input
    differs from the reference's in at most 1e-3 of its outputs (rounding
    the scales to bf16 made 27% differ); one chunk step's logits, cast
    to fp32, are within 2 bf16 ulps at 8 (0.0625) of the reference's;
    and the paged engine's greedy tokens equal the reference engine's up
    to a near tie: where a request's tokens first differ, the two tokens'
    logits in the reference's own forward over that prefix lie within
    0.0625 (bf16 products round differently in XLA and PyTorch), and the
    rest of that request is not compared."""
    jcfg = jax_get_config("gemma-7b").reduced()
    cfg = get_config("gemma-7b").reduced()
    assert cfg.dtype == "bfloat16"
    tree = ref_tree(jcfg, seed=0)
    params = lm.params_from_numpy(tree, cfg, device="cpu")
    pairs = [(params["final_norm"], tree["final_norm"])]
    for i, lp in enumerate(params["layers"]):
        for n in ("norm1", "norm2"):
            pairs.append((lp[n], {k: v[i] for k, v in
                                  tree["blocks"][0][n].items()}))
    x = np.random.default_rng(3).standard_normal((4, 64, cfg.d_model))
    xj = jnp.asarray(x, jnp.bfloat16)
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).bfloat16()
    for mine, ref in pairs:
        assert mine["scale"].dtype == torch.float32
        np.testing.assert_array_equal(mine["scale"].numpy(), ref["scale"])
        want = np.asarray(JL.apply_norm(
            {k: jnp.asarray(v) for k, v in ref.items()}, xj, jcfg
        ).astype(jnp.float32))
        got = L.apply_norm(mine, xt).float().numpy()
        assert (got != want).mean() <= 1e-3
    assert params["embed"].dtype == torch.bfloat16
    fresh = lm.init_lm(cfg, 0, device="cpu")
    assert fresh["final_norm"]["scale"].dtype == torch.float32
    assert fresh["layers"][0]["mixer"]["wq"].dtype == torch.bfloat16

    B, C, P, page = 2, 8, 8, 4
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (B, C)
                                             ).astype(np.int32)
    pt = np.array([[0, 1, -1, -1], [2, 3, -1, -1]], np.int32)
    pos, nv = np.zeros(B, np.int32), np.array([8, 5], np.int32)
    wl, _ = jax_lm.decode_chunk(tree, jcfg, jnp.asarray(toks),
                                jax_lm.init_paged_cache(jcfg, P, page),
                                jnp.asarray(pt), jnp.asarray(pos),
                                jnp.asarray(nv), full_logits=True)
    cache = lm.init_paged_cache(cfg, P, page, device="cpu")
    with torch.inference_mode():
        gl, _ = lm.decode_chunk(params, cfg, torch.from_numpy(toks), cache,
                                torch.from_numpy(pt), torch.from_numpy(pos),
                                torch.from_numpy(nv), full_logits=True)
    wl = np.asarray(wl.astype(jnp.float32))
    for b in range(B):
        np.testing.assert_allclose(gl[b, :nv[b]].float().numpy(),
                                   wl[b, :nv[b]], rtol=0, atol=BF16_NOISE)

    knobs = dict(max_batch=3, max_len=40, page_size=4, prefill_chunk=8)
    work = dict(n=5, tokens=8, prompt_len=24, prompt_lens=(3, 17, 24, 5, 11))
    want, got, _ = serve_both(jcfg, cfg, tree, knobs, work)
    prompts = [r.prompt for r in jax_requests(jcfg, scenario="offline",
                                              seed=7, **work)]
    compared = 0
    for prompt, a, b in zip(prompts, got, want):
        n = next((t for t, (x, y) in enumerate(zip(a, b)) if x != y), len(b))
        compared += n
        if n < len(b):
            seq = jnp.asarray([list(prompt) + list(b[:n])], jnp.int32)
            lg, _ = jax_lm.forward(tree, jcfg, seq)
            last = np.asarray(lg[0, -1].astype(jnp.float32))
            assert abs(last[a[n]] - last[b[n]]) <= BF16_NOISE, (n, a, b)
    assert compared >= 30  # of 40


# ---- mixtral past its window ---------------------------------------------- #
def test_mixtral_serves_past_its_window_without_one():
    """An 80-token prompt on reduced mixtral (window 64): the reference
    applies no window when serving (``serve/engine.py:214-228``), and
    the port's tokens equal its tokens. The prompt is long enough for a
    window of 64 to change the logits."""
    jcfg, cfg = cfgs("mixtral-8x7b")
    assert cfg.sliding_window == 64
    tree = ref_tree(jcfg, seed=12)
    knobs = dict(max_batch=2, max_len=96, page_size=8, prefill_chunk=8)
    work = dict(n=2, tokens=6, prompt_len=80, prompt_lens=(80, 71))
    want, got, _ = serve_both(jcfg, cfg, tree, knobs, work, seed=5)
    assert got == want
    params = lm.params_from_numpy(tree, cfg, device="cpu")
    toks = torch.from_numpy(data._zipf_tokens(np.random.default_rng(13),
                                              (1, 80), cfg.vocab))
    with torch.no_grad():
        full = lm.forward(params, cfg, toks)
        windowed = lm.forward(params, cfg, toks, window=cfg.sliding_window)
    assert (full[0, 70:] - windowed[0, 70:]).abs().max() > 1e-3
    np.testing.assert_allclose(full[0, :64].numpy(),
                               windowed[0, :64].numpy(), rtol=1e-4,
                               atol=1e-5)


# ---- what the train step and eval read at a bf16 compute dtype ------------- #
@pytest.mark.parametrize("arch", ["command-r-35b", "mixtral-8x7b",
                                  "jamba-1.5-large-398b"])
def test_compute_cast_rounds_what_the_reference_rounds(arch):
    """The reference's train step casts its stacked tree, so a layer's
    norm scales and biases ((n_blocks, d)), its router and Mamba's
    ``dt_bias``, ``A_log`` and ``D`` are rounded to bf16, the final norm
    ((d,)) is not: the port's compute copy holds the same dtypes and
    values, leaf for leaf (two blocks of each arch's reduced pattern)."""
    from repro.optim.precision import compute_cast as jax_compute_cast
    from repro_torch.optim import compute_cast
    from repro_torch.utils import tree_leaves

    P = len(get_config(arch).reduced().block_pattern)
    jcfg, cfg = cfgs(arch, dtype="bfloat16", n_layers=2 * P)
    tree = ref_tree(jcfg, seed=30)
    _, axes = JT.init_params_and_axes(jcfg, jax.random.PRNGKey(0))
    rules = Rules(single_device_mesh(), jcfg.param_sharding,
                  seq_parallel=jcfg.seq_parallel)
    want = jax_compute_cast(jax.tree_util.tree_map(jnp.asarray, tree), axes,
                            rules, "bfloat16")
    got = compute_cast(lm.params_from_numpy(tree, cfg, device="cpu",
                                            dtype=torch.float32), "bfloat16")
    want = jax.tree_util.tree_leaves(flat_jax_grads(want, cfg.n_layers))
    got = tree_leaves(got)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert str(g.dtype).replace("torch.", "") == str(w.dtype)
        np.testing.assert_array_equal(g.float().numpy(),
                                      np.asarray(jnp.asarray(w, jnp.float32)))
    assert got[0].dtype == torch.bfloat16  # embed
    layer = compute_cast(lm.params_from_numpy(tree, cfg, device="cpu",
                                              dtype=torch.float32))
    assert all(t.dtype == torch.bfloat16
               for t in layer["layers"][0]["norm1"].values())
    assert layer["final_norm"]["scale"].dtype == torch.float32


def test_eval_reads_fp32_leaves_unrounded():
    """The reference's eval step casts nothing ahead: its layers cast
    each weight at use and read norm leaves and the router in fp32; the
    port's eval copy (``lm.use_cast``) is what they read."""
    jcfg, cfg = cfgs("mixtral-8x7b", dtype="bfloat16")
    tree = ref_tree(jcfg, seed=31)
    masters = lm.params_from_numpy(tree, cfg, device="cpu",
                                   dtype=torch.float32)
    use = lm.use_cast(masters, cfg)
    served = lm.params_from_numpy(tree, cfg, device="cpu")
    lp = use["layers"][0]
    assert lp["ffn"]["router"].dtype == torch.float32
    assert lp["norm1"]["scale"].dtype == torch.float32
    assert lp["ffn"]["wu"].dtype == torch.bfloat16
    assert use["final_norm"]["scale"].dtype == torch.float32
    from repro_torch.utils import tree_leaves
    for a, b in zip(tree_leaves(use), tree_leaves(served), strict=True):
        assert a.dtype == b.dtype and torch.equal(a, b)
