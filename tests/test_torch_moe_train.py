"""The MoE aux loss in the port's train path, against the JAX reference
on the same numpy weights: reduced mixtral-8x7b with ``remat`` on and
off and at the published capacity factor 1.25 (tokens drop), grok-1's
step with 4 microbatches and bf16 gradients and Adam moments at 8
experts, and the paged engine at capacity 1.25, where the chunk's
padding takes expert capacity.

Tolerances: fp32 gradients rtol 1e-4 / atol 1e-6 and losses rtol 1e-5
(both sides fp32); bf16 gradients and moments within 2^-6 relative plus
2^-6 of the leaf's largest entry (a few bf16 ulps: one microbatch's fp32
gradient rounds to bf16 differently when the two sides' fp32 sums differ
in their last bits); greedy tokens exactly."""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.models import lm as jax_lm  # noqa: E402
from repro.optim import adam as jax_adam  # noqa: E402
from repro.optim import constant as jax_constant  # noqa: E402
from repro_torch.data import pipeline as data  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.optim import adam, constant  # noqa: E402
from repro_torch.utils import tree_leaves  # noqa: E402
from test_torch_archs import (  # noqa: E402
    assert_grads_match,
    cfgs,
    flat_jax_grads,
    ref_tree,
    serve_both,
    train_step_both,
)

LR = 1e-3


def moe_cfgs(arch, **kw):
    """Reduced ``arch`` on both sides at the published capacity factor
    1.25 (``reduced()`` sets a no-drop one)."""
    jcfg, cfg = cfgs(arch, **kw)
    cf = dict(capacity_factor=1.25)
    return (dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe, **cf)),
            dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **cf)))


def drops_tokens(cfg, params, tokens):
    """Whether layer 0's router drops a token of this batch (capacity
    ``ceil(Sg * k * cf / E)`` a group of ``Sg = min(256, S)``)."""
    B, S = tokens.shape
    x = lm._embed(params, torch.from_numpy(tokens))
    h = lm.L.apply_norm(params["layers"][0]["norm2"], x)
    E, k = cfg.moe.n_experts, cfg.moe.top_k
    Sg = min(256, S)
    cap = int(np.ceil(Sg * k * cfg.moe.capacity_factor / E))
    dispatch, _, _ = ops.moe_gating(h.reshape(B * S // Sg, Sg, -1),
                                    params["layers"][0]["ffn"]["router"],
                                    top_k=k, capacity=cap)
    return dispatch.sum().item() < B * S * k


@pytest.mark.parametrize("remat", [False, True])
def test_mixtral_aux_loss_and_gradients_at_capacity_1_25(remat):
    """The loss is nll + 0.01 aux; with remat the checkpointed layers
    recompute the router, and the aux term's gradient reaches it."""
    jcfg, cfg = moe_cfgs("mixtral-8x7b", remat=remat)
    tree = ref_tree(jcfg, seed=20)
    tokens = data._zipf_tokens(np.random.default_rng(21), (4, 24), cfg.vocab)
    fp32 = lm.params_from_numpy(tree, cfg, device="cpu", dtype=torch.float32)
    assert drops_tokens(cfg, fp32, tokens)
    (wstate, wm), (state, m) = train_step_both(jcfg, cfg, tree, tokens)
    np.testing.assert_allclose(m["loss"].item(), float(wm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(m["nll"].item(), float(wm["nll"]), rtol=1e-5)
    assert_grads_match(wstate["opt"], state["opt"], cfg.n_layers)

    # the aux term itself, and that it is in the loss
    want_loss, want_m = jax_lm.loss_fn(tree, jcfg, {"tokens": tokens})
    with torch.no_grad():
        loss, got_m = lm.loss_fn(fp32, cfg,
                                 {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(got_m["aux"].item(), float(want_m["aux"]),
                               rtol=1e-5)
    np.testing.assert_allclose(
        loss.item(), got_m["nll"].item() + 0.01 * got_m["aux"].item(),
        rtol=1e-6)
    # the router's gradient is the aux term's too: without the term the
    # routers' gradients change
    router = [g for g, w in zip(state["opt"], tree_leaves(fp32))
              if w.shape == (cfg.d_model, cfg.moe.n_experts)]
    assert router
    nll_only = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, aux_loss_weight=0.0))
    params = lm.params_from_numpy(tree, cfg, device="cpu",
                                  dtype=torch.float32)
    leaves = tree_leaves(params)
    for w in leaves:
        w.requires_grad_(True)
    loss0, _ = lm.loss_fn(params, nll_only,
                          {"tokens": torch.from_numpy(tokens)})
    g0 = torch.autograd.grad(loss0, leaves)
    g0_router = [g for g, w in zip(g0, leaves)
                 if w.shape == (cfg.d_model, cfg.moe.n_experts)]
    assert all((a - b).abs().max() > 1e-7 for a, b in zip(router, g0_router))


def test_remat_on_and_off_give_the_same_step():
    jcfg, cfg = moe_cfgs("mixtral-8x7b")
    tree = ref_tree(jcfg, seed=22)
    tokens = data._zipf_tokens(np.random.default_rng(23), (2, 40), cfg.vocab)
    out = {}
    for remat in (False, True):
        c = dataclasses.replace(cfg, remat=remat)
        params = lm.params_from_numpy(tree, c, device="cpu",
                                      dtype=torch.float32)
        leaves = tree_leaves(params)
        for w in leaves:
            w.requires_grad_(True)
        loss, m = lm.loss_fn(params, c, {"tokens": torch.from_numpy(tokens)})
        out[remat] = (loss.item(), m["aux"].item(),
                      torch.autograd.grad(loss, leaves))
    assert out[True][:2] == out[False][:2]
    for a, b in zip(out[True][2], out[False][2]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-9)


def assert_bf16_close(got, want):
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    tol = 2.0 ** -6
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * max(np.abs(want).max(), 1e-30))


def test_grok_microbatched_bf16_step_matches_reference():
    """grok-1 reduced with 8 experts (``reduced()`` keeps 4) at capacity
    1.25, 4 microbatches, gradients summed in bf16 in microbatch order
    and divided by 4 in bf16, Adam with bf16 moments: the gradient the
    optimizer gets, then one Adam step's weights and moments."""
    jcfg, cfg = cfgs("grok-1-314b", grad_dtype="bfloat16", microbatches=4)
    assert (cfg.moment_dtype, cfg.grad_dtype) == ("bfloat16",) * 2
    cf = dict(n_experts=8, capacity_factor=1.25)
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe, **cf))
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **cf))
    tree = ref_tree(jcfg, seed=24)
    tokens = data._zipf_tokens(np.random.default_rng(25), (8, 24), cfg.vocab)

    (wstate, wm), (state, m) = train_step_both(jcfg, cfg, tree, tokens)
    np.testing.assert_allclose(m["loss"].item(), float(wm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(m["nll"].item(), float(wm["nll"]), rtol=1e-5)
    want = jax.tree_util.tree_leaves(flat_jax_grads(wstate["opt"],
                                                    cfg.n_layers))
    assert len(state["opt"]) == len(want)
    for g, w in zip(state["opt"], want):
        assert g.dtype == torch.bfloat16 and w.dtype == jnp.bfloat16
        assert_bf16_close(g, w)

    jopt = jax_adam(jax_constant(LR), b1=0.9, b2=0.95, eps=1e-8,
                    moment_dtype="bfloat16")
    opt = adam(constant(LR), b1=0.9, b2=0.95, eps=1e-8,
               moment_dtype="bfloat16")
    (wstate, _), (state, _) = train_step_both(jcfg, cfg, tree, tokens,
                                              jopt, opt)
    n = cfg.n_layers
    for name in ("m", "v"):
        got = tree_leaves(state["opt"][name])
        ref = jax.tree_util.tree_leaves(flat_jax_grads(
            wstate["opt"][name], n))
        for g, w in zip(got, ref, strict=True):
            assert g.dtype == torch.bfloat16
            assert_bf16_close(g, w)
    # Adam's first step moves each weight by about lr * sign(g): a weight
    # whose bf16 gradient is near 0 may move differently, no other.
    got = tree_leaves(state["params"])
    ref = jax.tree_util.tree_leaves(flat_jax_grads(wstate["params"], n))
    moved = off = 0
    for g, w in zip(got, ref, strict=True):
        d = np.abs(g.detach().numpy() - np.asarray(w))
        moved += d.size
        off += int((d > 1e-3 * LR).sum())
        assert d.max() <= 2.01 * LR
    assert off <= 1e-3 * moved


def test_paged_engine_at_capacity_1_25_and_padding_takes_capacity():
    """Greedy tokens equal the reference engine's when experts drop
    tokens: the chunk step routes its padding too (groups of ``min(256,
    C)`` tokens a row), so both engines must feed the same padding
    (zeros); other padding changes the valid tokens' logits."""
    jcfg, cfg = moe_cfgs("mixtral-8x7b")
    tree = ref_tree(jcfg, seed=26)
    want, got, _ = serve_both(jcfg, cfg, tree)
    assert got == want
    params = lm.params_from_numpy(tree, cfg, device="cpu")
    # one valid token a row, 7 of padding: the padding's first choices
    # (round 1) can fill the expert a valid token picks second (round 2)
    B, C = 2, 8
    toks = torch.from_numpy(np.random.default_rng(27).integers(
        1, cfg.vocab, (B, 1)))
    nv = torch.ones(B, dtype=torch.int32)
    pt = torch.tensor([[0, 1], [2, 3]], dtype=torch.int32)
    pos = torch.zeros(B, dtype=torch.int32)

    def logits(pad):
        t = torch.cat([toks, torch.full((B, C - 1), pad)], dim=1)
        cache = lm.init_paged_cache(cfg, 4, 4, device="cpu")
        with torch.inference_mode():
            return lm.decode_chunk(params, cfg, t, cache, pt, pos, nv)[0]

    base = logits(0)
    assert any((logits(pad) - base).abs().max() > 1e-4
               for pad in range(1, 65))
