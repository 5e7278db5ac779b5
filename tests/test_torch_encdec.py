"""The port's encoder-decoder model (``repro_torch.models.encdec``)
against the JAX reference (``repro.models.encdec``): reduced
whisper-medium (2 encoder layers over 64 frames, 1 decoder layer, d 256,
4 heads of 64, LayerNorm, q/k/v biases, tanh GeLU), its weights from
the reference's ``init_encdec`` through the bridge with perturbed norm
scales and biases, inputs from a numpy seed, fp32 compute on both sides.

Held: the config copy; the sinusoid position table (bf16 bitwise where
the two frameworks' ``sin`` agree; the differences counted); the encoder
output, the forward logits, the loss and every gradient; prefill +
decode steps and the encoder's cross K/V + the paged chunk program,
greedy tokens exactly; the chunk program's cross-attention on a slot
that never admitted (finite, the reference's values); an int4 pool and
a request without media refused on both sides.

Tolerances: fp32 activations and logits rtol 1e-4 / atol 1e-5, fp32
gradients rtol 1e-4 / atol 1e-6, the loss rtol 1e-5 (sums in other
orders); tokens exactly."""
import dataclasses
import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.dist import split_tree  # noqa: E402
from repro.models import encdec as jed  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.serve import Engine as JaxEngine  # noqa: E402
from repro.serve import ServeConfig as JaxServeConfig  # noqa: E402
from repro.serve.request import Request as JaxRequest  # noqa: E402
from repro_torch.configs import get_config, list_archs  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.data import pipeline as data  # noqa: E402
from repro_torch.models import encdec  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.serve.engine import Engine, ServeConfig  # noqa: E402
from repro_torch.serve.request import Request  # noqa: E402
from repro_torch.utils import tree_leaves, tree_map  # noqa: E402

ARCH = "whisper-medium"
FP32 = dict(dtype="float32", kv_cache_dtype="float32")


def cfgs(**kw):
    kw = {**FP32, **kw}
    return (dataclasses.replace(jax_get_config(ARCH).reduced(), **kw),
            dataclasses.replace(get_config(ARCH).reduced(), **kw))


def ref_tree(jcfg, seed=0):
    """The reference's enc-dec weights as numpy, norm scales and biases
    perturbed (``lm.perturb_norms``)."""
    vals = jax.jit(lambda k: split_tree(jed.init_encdec(jcfg, k))[0])(
        jax.random.PRNGKey(seed))
    return lm.perturb_norms(jax.tree_util.tree_map(np.asarray, vals),
                            seed + 100)


def inputs(cfg, seed, B=2, S=12):
    rng = np.random.default_rng(seed)
    frames = rng.standard_normal((B, cfg.enc_source_len, cfg.d_model)
                                 ).astype(np.float32)
    return frames, data._zipf_tokens(rng, (B, S), cfg.vocab)


def per_layer(g, cfg):
    """The reference's tree with ``enc_blocks``/``dec_blocks`` stacked
    over layers, in the port's layout: one dict a layer."""
    def split(stacked, n):
        return [jax.tree_util.tree_map(lambda a, i=i: np.asarray(a)[i],
                                       stacked) for i in range(n)]
    out = {k: v for k, v in g.items() if k not in ("enc_blocks",
                                                    "dec_blocks")}
    out["enc_blocks"] = split(g["enc_blocks"], cfg.n_enc_layers)
    out["dec_blocks"] = split(g["dec_blocks"], cfg.n_layers)
    return out


def close(got, want, rtol=1e-4, atol=1e-5):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=atol)


@pytest.fixture(scope="module")
def model():
    jcfg, cfg = cfgs()
    tree = ref_tree(jcfg)
    return jcfg, cfg, tree, encdec.params_from_numpy(tree, cfg, device="cpu")


# --------------------------------------------------------------------------- #
def test_config_matches_reference_and_is_ported():
    assert ARCH in list_archs()
    for reduce in (False, True):
        ref, cfg = jax_get_config(ARCH), get_config(ARCH)
        if reduce:
            ref, cfg = ref.reduced(), cfg.reduced()
        for f in dataclasses.fields(ModelConfig):
            assert getattr(cfg, f.name) == getattr(ref, f.name) or \
                f.name == "block_pattern", (reduce, f.name)
        assert [(s.mixer, s.ffn) for s in cfg.block_pattern] == \
            [(s.mixer, s.ffn) for s in ref.block_pattern]
        assert cfg.is_encdec and cfg.param_count() == ref.param_count()
    full = get_config("whisper_medium")
    assert (full.n_layers, full.n_enc_layers, full.d_model, full.n_heads,
            full.head_dim, full.d_ff, full.vocab, full.enc_source_len) == \
        (24, 24, 1024, 16, 64, 4096, 51865, 1500)
    assert full.param_count() == 810_862_592
    small = get_config(ARCH).reduced()
    assert (small.n_enc_layers, small.enc_source_len, small.n_layers) == \
        (2, 64, 1)


# ---- the sinusoid trap ----------------------------------------------------- #
def test_sinusoid_table_matches_reference():
    """The position table against ``jed.sinusoid`` at whisper's d 1024,
    all 65,536 rows. The denominators are bitwise XLA's; XLA's fp32
    ``sin``/``cos`` differ from the port's (fp64, rounded) in 871,778
    entries by at most 5.96e-8 (one fp32 ulp at 1); cast to bf16, 13
    entries differ, each by one bf16 ulp, none below position 3885, so
    the table is bitwise the reference's over every position a serving
    stream reaches here (max_len <= 3885). Row p of ``sinusoid(S)``
    (prefill) is bitwise row p of the table (chunk and decode), in both
    dtypes, and ``frames + positions`` adds in the compute dtype as the
    reference's ``encode`` does."""
    S, d = encdec.MAX_POSITIONS, 1024
    cfg = dataclasses.replace(get_config(ARCH).reduced(), d_model=d)
    got32 = encdec.sinusoid_table(cfg, torch.float32, "cpu").numpy()
    want32 = np.asarray(jed.sinusoid(S, d, jnp.float32)[0])
    diff32 = np.abs(got32 - want32)
    assert diff32.max() <= 6e-8
    gotbf = encdec.sinusoid_table(cfg, torch.bfloat16, "cpu").float().numpy()
    wantbf = np.asarray(jed.sinusoid(S, d, jnp.bfloat16)[0], np.float32)
    rows, _ = np.nonzero(gotbf != wantbf)
    assert len(rows) <= 16 and rows.min() >= 3885, rows
    np.testing.assert_array_equal(gotbf[:3885], wantbf[:3885])
    assert np.abs(gotbf - wantbf).max() <= 2 ** -8  # one ulp below 1
    for dt in (torch.float32, torch.bfloat16):
        np.testing.assert_array_equal(
            encdec.sinusoid(448, d, dt).float().numpy(),
            encdec.sinusoid_table(cfg, dt, "cpu")[:448].float().numpy())
    # the encoder's input: frames cast, then the positions added, in bf16
    frames = np.random.default_rng(0).standard_normal((64, d)).astype(
        np.float32)
    want = np.asarray((jnp.asarray(frames).astype(jnp.bfloat16)
                       + jed.sinusoid(64, d, jnp.bfloat16))[0], np.float32)
    got = (torch.from_numpy(frames).to(torch.bfloat16)
           + encdec.sinusoid(64, d, torch.bfloat16)).float().numpy()
    np.testing.assert_array_equal(got, want)


# ---- the model ------------------------------------------------------------- #
def test_encode_and_forward_logits_match_reference(model):
    jcfg, cfg, tree, params = model
    frames, tokens = inputs(cfg, 1)
    want_enc = jed.encode(tree, jcfg, frames)
    want, _ = jed.forward(tree, jcfg, frames, tokens)
    with torch.no_grad():
        enc = encdec.encode(params, cfg, torch.from_numpy(frames))
        got = encdec.forward(params, cfg, torch.from_numpy(frames),
                             torch.from_numpy(tokens))
    close(enc, want_enc)
    assert got.shape == (2, 12, cfg.vocab)
    close(got, want)


@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_every_gradient_match_reference(remat):
    jcfg, cfg = cfgs(remat=remat)
    tree = ref_tree(jcfg, seed=2)
    frames, tokens = inputs(cfg, 3)
    batch = {"media": frames, "tokens": tokens}
    (want_loss, want_m), want_g = jax.jit(jax.value_and_grad(
        jed.loss_fn, has_aux=True), static_argnums=1)(tree, jcfg, batch)
    params = encdec.params_from_numpy(tree, cfg, device="cpu",
                                      dtype=torch.float32)
    for w in tree_leaves(params):
        w.requires_grad_(True)
    loss, m = encdec.loss_fn(params, cfg, {k: torch.from_numpy(v)
                                           for k, v in batch.items()})
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    np.testing.assert_allclose(m["nll"].item(), float(want_m["nll"]),
                               rtol=1e-5)
    want = jax.tree_util.tree_leaves(per_layer(want_g, cfg))
    got = tree_leaves(tree_map(lambda w: w.grad, params))
    # embed, head, 2 LayerNorms of 2 leaves; an encoder layer's 4 norm +
    # 7 attention + 2 FFN leaves; a decoder layer's 6 + 14 + 2
    assert len(got) == len(want) == 6 + 13 * cfg.n_enc_layers + 22 * \
        cfg.n_layers
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-6)


def test_prefill_and_decode_steps_match_reference(model):
    """Prefill at a cache of 20 slots, then 5 greedy decode steps at
    per-row positions: logits close, tokens equal."""
    jcfg, cfg, tree, params = model
    frames, tokens = inputs(cfg, 4, S=9)
    jlogits, jcache = jed.prefill(tree, jcfg, frames, tokens, cache_len=20)
    jstep = jax.jit(functools.partial(jed.decode_step, cfg=jcfg))
    with torch.no_grad():
        logits, cache = encdec.prefill(params, cfg, torch.from_numpy(frames),
                                       torch.from_numpy(tokens), cache_len=20)
        close(logits, jlogits)
        for layer, jlayer in zip(cache["cross"], range(cfg.n_layers)):
            close(layer["k"], jcache["cross"]["k"][jlayer])
        pos = 9
        for _ in range(5):
            want_tok = np.argmax(np.asarray(jlogits), -1)
            got_tok = torch.argmax(logits, -1).numpy()
            np.testing.assert_array_equal(got_tok, want_tok)
            jlogits, jcache = jstep(tree, token=jnp.asarray(
                want_tok[:, None], jnp.int32), cache=jcache,
                pos=jnp.full((2,), pos, jnp.int32))
            logits, cache = encdec.decode_step(
                params, cfg, torch.from_numpy(got_tok[:, None]), cache,
                torch.full((2,), pos))
            close(logits, jlogits)
            pos += 1


def test_encode_cross_and_chunk_program_match_reference(model):
    """The encoder's cross K/V into a 2-slot cross slab, then the paged
    chunk program (page 4, chunk 4) over ragged rows: row 0 prefills 7
    prompt tokens, row 1 3, in chunks, then both decode greedily for 4
    steps. Logits of each row's last valid token close, tokens equal;
    the pools are written in place and the cross slab is not."""
    jcfg, cfg, tree, params = model
    frames, _ = inputs(cfg, 5)
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, cfg.vocab, 7).tolist(),
               rng.integers(0, cfg.vocab, 3).tolist()]
    B, C, page, npg = 2, 4, 4, 4
    pt = np.array([[0, 1, 2, 3], [4, 5, 6, 7]], np.int32)
    jcache = jed.init_paged_cache(jcfg, B, B * npg, page)
    jcache = {**jcache, "cross": jed.encode_cross(tree, jcfg, frames)}
    jchunk = jax.jit(functools.partial(jed.decode_chunk, cfg=jcfg))
    cache = encdec.init_paged_cache(cfg, B, B * npg, page, device="cpu")
    with torch.no_grad():
        kv = encdec.encode_cross(params, cfg, torch.from_numpy(frames))
        for dst, src in zip(cache["cross"], kv):
            for name in dst:
                dst[name].copy_(src[name])
        close(cache["cross"][0]["v"], jcache["cross"]["v"][0])
        cross_before = [c["k"].clone() for c in cache["cross"]]
        streams = [list(p) for p in prompts]
        pos = np.zeros(B, np.int32)
        out = [[], []]
        for _ in range(8):
            toks = np.zeros((B, C), np.int32)
            nv = np.ones(B, np.int32)
            for b in range(B):
                n = min(C, len(streams[b])) if streams[b] else 1
                feed = streams[b][:n] if streams[b] else [out[b][-1]]
                toks[b, :len(feed)] = feed
                nv[b] = len(feed)
            jl, jcache = jchunk(tree, tokens=jnp.asarray(toks), cache=jcache,
                                page_table=jnp.asarray(pt),
                                pos=jnp.asarray(pos), n_valid=jnp.asarray(nv))
            gl, cache = encdec.decode_chunk(
                params, cfg, torch.from_numpy(toks), cache,
                torch.from_numpy(pt), torch.from_numpy(pos),
                torch.from_numpy(nv))
            close(gl, jl)
            want_tok = np.argmax(np.asarray(jl), -1)
            np.testing.assert_array_equal(torch.argmax(gl, -1).numpy(),
                                          want_tok)
            for b in range(B):
                pos[b] += nv[b]
                streams[b] = streams[b][nv[b]:]
                if not streams[b]:
                    out[b].append(int(want_tok[b]))
        assert all(len(o) >= 4 for o in out)
        for before, c in zip(cross_before, cache["cross"]):
            assert torch.equal(before, c["k"])
        close(cache["self"]["kp"][0, :8], jcache["self"]["kp"][0, :8])


def test_cross_chunk_on_an_idle_slot_is_finite_and_the_reference(model):
    """A slot that never admitted has ``slot_pos`` -1 throughout: its
    fully masked rows are a uniform mean of V under the finite -1e30
    mask, not NaN, on both sides."""
    jcfg, cfg, tree, params = model
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 3, cfg.d_model)).astype(np.float32)
    jc = JL.init_kv_cache(jcfg, 2, cfg.enc_source_len)
    kv = rng.standard_normal(jc["k"].shape).astype(np.float32)
    jc = {**jc, "k": jnp.asarray(kv), "v": jnp.asarray(kv[::-1].copy()),
          "slot_pos": jnp.asarray(np.stack([np.arange(64), -np.ones(64)]
                                           ).astype(np.int32))}
    jprm = jax.tree_util.tree_map(lambda a: jnp.asarray(a[0]),
                                  tree["dec_blocks"]["cross_attn"])
    want = JL.attention_cross_chunk(jprm, jnp.asarray(x), jcfg, jc)
    c = {k: torch.from_numpy(np.array(v)) for k, v in jc.items()}
    got = L.attention_cross_chunk(params["dec_blocks"][0]["cross_attn"],
                                  torch.from_numpy(x), cfg, c)
    assert torch.isfinite(got).all()
    close(got, want)


def test_int4_pool_and_missing_media_refused(model):
    """An int4 pool (the cross slab cannot be int4) and a request
    without media raise ``ValueError`` on both sides."""
    jcfg, cfg, tree, params = model
    with pytest.raises(ValueError, match="int4"):
        JaxEngine(jcfg, tree, None, JaxServeConfig(kv_dtype="int4"))
    with pytest.raises(ValueError, match="int4"):
        Engine(cfg, params, ServeConfig(kv_dtype="int4"), device="cpu")
    with pytest.raises(ValueError, match="requires media"):
        JaxEngine(jcfg, tree, None, JaxServeConfig(max_len=32)).submit(
            JaxRequest(prompt=[1, 2, 3], max_new_tokens=2))
    with pytest.raises(ValueError, match="requires media"):
        Engine(cfg, params, ServeConfig(max_len=32), device="cpu").submit(
            Request(prompt=[1, 2, 3], max_new_tokens=2))
