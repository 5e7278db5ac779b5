"""qwen2-vl-7b, the vision-language model, in the port against the JAX
reference on the same numpy weights (the reference's init through the
bridge, norms and q/k/v biases perturbed), reduced, fp32 on both sides:
the config copy; M-RoPE's sections, angles and rotation; the media
grid's positions (n_media 16, 32 whose side 5 is not exact, and 0); the
forward, loss and every gradient with a media prefix, at the reduced 4/4
heads and at GQA 7/1; prefill plus a decode step at an absolute position
that counts the media; the vision batches and eval set byte for byte;
the Trainer's 3 Adam steps and eval over them;
the layout rule (slab) and the paged layout's refusal; the slab
engine's greedy tokens against the reference engine's on the
reference's media. The flash kernels at qwen2-vl's GQA 7 are held on
the card in ``tests/test_torch_vlm_cuda.py``.

Tolerances: fp32 logits rtol 1e-4 / atol 1e-5, the loss rtol 1e-5,
gradients rtol 1e-4 / atol 1e-6, Trainer losses rtol 1e-4 (both sides
fp32, sums in other orders); RoPE and M-RoPE angles exactly (the
frequencies are XLA's correctly rounded fp32 power), rotations 1e-5
(XLA's and torch's fp32 sine and cosine differ by up to ~3e-6 at angles
of thousands of radians); positions, batches and greedy tokens
exactly."""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import list_archs as jax_list_archs  # noqa: E402
from repro.data import pipeline as jax_data  # noqa: E402
from repro.launch.mesh import single_device_mesh  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import lm as jax_lm  # noqa: E402
from repro.serve import Engine as JaxEngine  # noqa: E402
from repro.serve import ServeConfig as JaxServeConfig  # noqa: E402
from repro.serve import run_offline as jax_run_offline  # noqa: E402
from repro.serve.engine import synthetic_requests as jax_requests  # noqa: E402
from repro.train import Trainer as JaxTrainer  # noqa: E402
from repro.train import TrainerConfig as JaxTrainerConfig  # noqa: E402
from repro_torch.configs import get_config, list_archs  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.data import pipeline as data  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.serve.engine import (  # noqa: E402
    Engine,
    ServeConfig,
    synthetic_requests,
)
from repro_torch.serve.request import Request  # noqa: E402
from repro_torch.serve.scenarios import run_offline  # noqa: E402
from repro_torch.train import Trainer, TrainerConfig  # noqa: E402
from repro_torch.utils import tree_leaves  # noqa: E402
from test_torch_archs import _plain, flat_jax_grads, ref_tree  # noqa: E402

ARCH = "qwen2-vl-7b"
FP32 = dict(dtype="float32", kv_cache_dtype="float32")
SLAB = dict(max_batch=2, max_len=40, prefill_len=16)
WORK = dict(n=4, tokens=5, prompt_len=16, seed=5,
            prompt_lens=(3, 16, 9, 12))


def cfgs(**kw):
    kw = {**FP32, **kw}
    return (dataclasses.replace(jax_get_config(ARCH).reduced(), **kw),
            dataclasses.replace(get_config(ARCH).reduced(), **kw))


@pytest.fixture(scope="module")
def model():
    jcfg, cfg = cfgs()
    tree = ref_tree(jcfg, seed=3)
    return jcfg, cfg, tree, lm.params_from_numpy(tree, cfg, device="cpu")


def _media(B, n, d, seed):
    return np.random.default_rng(seed).standard_normal(
        (B, n, d)).astype(np.float32)


# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("reduced", [False, True])
def test_config_copy_and_registry_match_reference(reduced):
    ref, cfg = jax_get_config(ARCH), get_config(ARCH)
    if reduced:
        ref, cfg = ref.reduced(), cfg.reduced()
    for f in dataclasses.fields(ModelConfig):
        assert _plain(getattr(cfg, f.name)) == _plain(getattr(ref, f.name)), \
            f.name
    assert cfg.param_count() == ref.param_count()
    assert (cfg.rope, cfg.frontend) == ("mrope", "vision_patches")
    assert list_archs() == jax_list_archs()
    assert get_config("qwen2_vl_7b") is get_config(ARCH)


@pytest.mark.parametrize("D", [128, 64, 20])
def test_mrope_angles_and_rotation_match_reference(D):
    """Sections 1/4, 3/8, 3/8 of the half-dims (D 20: 2, 4 and 4), each
    frequency reading its stream's position, on positions whose three
    streams all differ; standard RoPE on (B, S) positions alike. The
    angles are bitwise the reference's: ``theta ** (-j / half)`` in fp32
    through ``torch.pow`` is an ulp off XLA's in 2-5 of 16-128
    frequencies, which moved a rotation at position ~5000 by 2.5e-4."""
    half = D // 2
    s1 = half // 4
    s2 = (half - s1) // 2
    assert L.mrope_sections(half).tolist() == (
        [0] * s1 + [1] * s2 + [2] * (half - s1 - s2))
    rng = np.random.default_rng(D)
    pos3 = rng.integers(0, 5000, (2, 9, 3)).astype(np.int32)
    x = rng.standard_normal((2, 9, 3, D)).astype(np.float32)
    for pos, mr in ((pos3, True), (pos3[..., 1], False)):
        want = JL._rope_angles(jnp.asarray(pos), half, 1e6, mr)
        got = L.rope_angles(torch.from_numpy(pos), half, 1e6, device="cpu")
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        want = JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta=1e6,
                             mrope=mr)
        got = L.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                           theta=1e6)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("n_media", [16, 32, 0])
def test_positions_match_reference(n_media):
    """The media grid (0, idx // side, idx % side) with side
    int(n ** 0.5) (n 32: side 5, so h runs to 6), text at its absolute
    index on all streams; a non-M-RoPE config's (B, S) positions."""
    jcfg, cfg = cfgs()
    S = n_media + 11
    want = np.asarray(jax_lm._positions(jcfg, 2, S, n_media))
    got = lm._positions(cfg, 2, S, "cpu", n_media)
    assert got.shape == (2, S, 3)
    np.testing.assert_array_equal(got.numpy(), want)
    if n_media == 32:
        assert got[0, 31].tolist() == [0, 6, 1]
    jg, g = jax_get_config("gemma-7b"), get_config("gemma-7b")
    np.testing.assert_array_equal(lm._positions(g, 2, S, "cpu").numpy(),
                                  np.asarray(jax_lm._positions(jg, 2, S)))


@pytest.mark.parametrize("heads", [(4, 4), (7, 1)], ids=str)
def test_forward_loss_and_gradients_with_media(heads):
    """Media prepended (cast to the compute dtype first), the loss over
    text positions only: logits, the loss and every gradient against
    ``jax.grad`` of the reference's ``loss_fn``; GQA at 7/1 heads of 32
    set on both sides (the reduced config is MHA)."""
    H, K = heads
    kw = {} if heads == (4, 4) else dict(n_heads=H, n_kv_heads=K, head_dim=32)
    jcfg, cfg = cfgs(**kw)
    tree = ref_tree(jcfg, seed=H)
    rng = np.random.default_rng(H)
    toks = data._zipf_tokens(rng, (2, 12), cfg.vocab)
    media = _media(2, cfg.n_media_tokens, cfg.d_model, H)
    jtree = jax.tree_util.tree_map(jnp.asarray, tree)
    jbatch = {"tokens": jnp.asarray(toks), "media": jnp.asarray(media)}
    want_logits, _ = jax_lm.forward(jtree, jcfg, jbatch["tokens"],
                                    media=jbatch["media"])
    (want_loss, _), want_g = jax.value_and_grad(
        lambda p: jax_lm.loss_fn(p, jcfg, jbatch), has_aux=True)(jtree)

    params = lm.params_from_numpy(tree, cfg, device="cpu")
    batch = {"tokens": torch.from_numpy(toks),
             "media": torch.from_numpy(media)}
    logits = lm.forward(params, cfg, batch["tokens"], media=batch["media"])
    assert logits.shape == (2, cfg.n_media_tokens + 12, cfg.vocab)
    np.testing.assert_allclose(logits.detach().numpy(),
                               np.asarray(want_logits), rtol=1e-4, atol=1e-5)
    leaves = [w.requires_grad_() for w in tree_leaves(params)]
    loss, _ = lm.loss_fn(params, cfg, batch)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    got = torch.autograd.grad(loss, leaves)
    want = jax.tree_util.tree_leaves(flat_jax_grads(want_g, cfg.n_layers))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-6)


def test_prefill_then_decode_at_the_absolute_position(model):
    """Prefill of the media and all but the last token, then one decode
    step at position n_media + S - 1 (M-RoPE: that index on all three
    streams): both against the full forward's logits, and against the
    reference's prefill and decode."""
    jcfg, cfg, tree, params = model
    S, n = 10, cfg.n_media_tokens
    toks = data._zipf_tokens(np.random.default_rng(8), (2, S), cfg.vocab)
    media = _media(2, n, cfg.d_model, 8)
    full = lm.forward(params, cfg, torch.from_numpy(toks),
                      media=torch.from_numpy(media))[:, n:]
    with torch.no_grad():
        pre, cache = lm.prefill(params, cfg, torch.from_numpy(toks[:, :-1]),
                                media=torch.from_numpy(media),
                                cache_len=n + S)
        dec, _ = lm.decode_step(params, cfg, torch.from_numpy(toks[:, -1:]),
                                cache, n + S - 1)
    jtree = jax.tree_util.tree_map(jnp.asarray, tree)
    jpre, jcache = jax_lm.prefill(jtree, jcfg, jnp.asarray(toks[:, :-1]),
                                  media=jnp.asarray(media), cache_len=n + S)
    jdec, _ = jax_lm.decode_step(jtree, jcfg, jnp.asarray(toks[:, -1:]),
                                 jcache, jnp.int32(n + S - 1))
    for got, want, ref in ((pre, full[:, S - 2], jpre),
                           (dec, full[:, S - 1], jdec)):
        np.testing.assert_allclose(got.numpy(), want.detach().numpy(),
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                                   atol=1e-5)


@pytest.mark.parametrize("seq", [24, 40])
def test_vision_batches_and_eval_set_are_the_references(seq):
    """Tokens (batch, seq - n) first, then media (batch, n, d) with n =
    min(n_media_tokens, seq // 2), from the same generator; the eval set
    draws full-length tokens and cuts them, as the reference does."""
    jcfg, cfg = jax_get_config(ARCH).reduced(), get_config(ARCH).reduced()
    for got, want in zip(
            data.synthetic_lm_batches(cfg, batch=3, seq=seq, steps=2, seed=4),
            jax_data.synthetic_lm_batches(jcfg, batch=3, seq=seq, steps=2,
                                          seed=4)):
        assert got.keys() == want.keys() == {"tokens", "media"}
        n = min(cfg.n_media_tokens, seq // 2)
        assert got["media"].shape == (3, n, cfg.d_model)
        assert got["tokens"].shape == (3, seq - n)
        for k in got:
            assert got[k].dtype == want[k].dtype
            assert got[k].tobytes() == want[k].tobytes()
    got = list(data.synthetic_eval_set(cfg, batch=2, seq=seq)())
    want = list(jax_data.synthetic_eval_set(jcfg, batch=2, seq=seq)())
    assert len(got) == len(want) == 4
    for (gb, gm), (wb, wm) in zip(got, want):
        assert np.array_equal(gm, wm)
        for k in ("tokens", "media"):
            assert np.asarray(gb[k]).tobytes() == np.asarray(wb[k]).tobytes()


def test_trainer_adam_steps_and_eval_with_media_match_reference():
    """3 ``Trainer.fit`` steps of the default Adam over vision batches
    (12 media + 12 text positions) with an eval at step 3, from the
    reference trainer's initial weights: losses and eval nll."""
    jcfg, cfg = cfgs()
    jtr = JaxTrainer(jcfg, single_device_mesh(),
                     JaxTrainerConfig(total_steps=3, eval_every=3,
                                      log_every=0))
    tree = jax.tree_util.tree_map(np.asarray, jtr.state["params"])
    kw = dict(batch=2, seq=24, steps=3, seed=0)
    ev = dict(batch=2, seq=24)
    want = jtr.fit(jax_data.synthetic_lm_batches(jcfg, **kw),
                   jax_data.synthetic_eval_set(jcfg, **ev))
    tr = Trainer(cfg, TrainerConfig(total_steps=3, eval_every=3, log_every=0),
                 device="cpu", params=lm.params_from_numpy(
                     tree, cfg, device="cpu", dtype=torch.float32))
    got = tr.fit(data.synthetic_lm_batches(cfg, **kw),
                 data.synthetic_eval_set(cfg, **ev))
    for key in ("loss", "nll"):
        np.testing.assert_allclose([r[key] for r in got],
                                   [r[key] for r in want], rtol=1e-4)
    np.testing.assert_allclose(got[-1]["eval_nll"], want[-1]["eval_nll"],
                               rtol=1e-4)


def test_layout_rule_refuses_paged_and_validates_lengths(model):
    """``kv_layout="auto"`` serves a vision frontend from the slab; an
    explicit ``"paged"`` raises the reference's ``ValueError`` on both
    sides; a request whose media and padded prompt outrun ``max_len``,
    or whose prompt outruns ``prefill_len``, is refused at submit on
    both sides; synthetic requests carry (n_media_tokens, d) fp32
    media."""
    jcfg, cfg, tree, params = model
    assert Engine(cfg, params, ServeConfig(), device="cpu").layout == "slab"
    for make in (lambda: Engine(cfg, params, ServeConfig(kv_layout="paged"),
                                device="cpu"),
                 lambda: JaxEngine(jcfg, tree, None,
                                   JaxServeConfig(kv_layout="paged"))):
        with pytest.raises(ValueError, match="vision frontend"):
            make()
    media = np.zeros((cfg.n_media_tokens, cfg.d_model), np.float32)
    knobs = dict(max_batch=1, max_len=30, prefill_len=16)
    for eng in (Engine(cfg, params, ServeConfig(**knobs), device="cpu"),
                JaxEngine(jcfg, tree, None, JaxServeConfig(**knobs))):
        with pytest.raises(ValueError, match="padded prompt"):
            eng.submit(Request(prompt=[1, 2], max_new_tokens=2, media=media))
        with pytest.raises(ValueError, match="prefill_len"):
            eng.submit(Request(prompt=[1] * 17, max_new_tokens=1))
    reqs = synthetic_requests(cfg, n=2, tokens=2, prompt_len=8, seed=1)
    assert all(r.media.shape == (cfg.n_media_tokens, cfg.d_model)
               and r.media.dtype == np.float32 for r in reqs)
    assert not np.array_equal(reqs[0].media, reqs[1].media)


def test_slab_engine_tokens_equal_the_references(model):
    """Both engines serve the reference's requests (its media drawn with
    ``jax.random``; ids set) from the slab, prompts padded to
    ``prefill_len`` after the media: greedy tokens exactly."""
    jcfg, cfg, tree, params = model
    jreqs = jax_requests(jcfg, **WORK)
    want = jax_run_offline(JaxEngine(jcfg, tree, None,
                                     JaxServeConfig(**SLAB)), jreqs)
    reqs = [Request(prompt=list(r.prompt), max_new_tokens=r.max_new_tokens,
                    media=np.asarray(r.media), id=r.id) for r in jreqs]
    eng = Engine(cfg, params, ServeConfig(**SLAB), device="cpu")
    got = run_offline(eng, reqs)
    assert eng.layout == "slab"

    def toks(report):
        return [list(r.tokens) for r in sorted(report.requests,
                                               key=lambda r: r.id)]

    assert toks(got) == toks(want)
    assert all(len(t) == WORK["tokens"] for t in toks(got))


def test_cli_serves_from_the_slab_with_media(capsys):
    """The serve CLI sizes ``max_len`` for the media ahead of each prompt
    (the reference's run dispatcher's rule) and serves the reduced VLM
    from the slab."""
    assert serve_cli.main(["--arch", ARCH, "--device", "cpu", "--tokens",
                           "3", "--batch", "2"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith(f"{ARCH} [offline, device=cpu, slots=2, "
                             f"kv=slab]: 2 requests, 6 tokens")
    assert [ln.split(" -> ")[1].split(" [")[0] for ln in out[1:3]] == \
        ["3 tokens"] * 2
