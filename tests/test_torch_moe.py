"""The port's MoE FFN against the JAX reference: ``moe_gating`` (dispatch
bit for bit, combine and aux to 1e-6) at a capacity that drops tokens,
a no-drop one and under argmax ties; ``apply_moe`` on the reference's
weights, in a prefill-sized group and per decode slot; and the group
rule's refusal of a token count that 256 does not divide."""
import dataclasses
import math

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.dist import split_tree  # noqa: E402
from repro.kernels import ref as jax_ref  # noqa: E402
from repro.models import layers as jax_layers  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402

ARCH = "jamba-1.5-large-398b"
FP32 = dict(dtype="float32", kv_cache_dtype="float32")
# jitted: one compile instead of one per eager op
ref_gating = jax.jit(jax_ref.moe_gating, static_argnames=("top_k",
                                                         "capacity"))
ref_apply_moe = jax.jit(jax_layers.apply_moe, static_argnums=2)


def _gating_case(G, S, d, E, seed, tie=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((G, S, d)).astype(np.float32)
    w = (np.zeros((d, E), np.float32) if tie
         else rng.standard_normal((d, E)).astype(np.float32) * d ** -0.5)
    return x, w


# (G, S, d, E, top_k, capacity, ties): the full-width cf 1.25 drops tokens
# (capacity ceil(S * k * 1.25 / E)); reduced() uses cf = E, no drops.
GATING = {
    "drop_cf1.25": (2, 64, 32, 16, 2, math.ceil(64 * 2 * 1.25 / 16), False),
    "drop_tight": (1, 40, 16, 4, 2, 3, False),
    "nodrop_cf4": (3, 24, 16, 4, 2, math.ceil(24 * 2 * 4.0 / 4), False),
    "ties_first_index": (2, 12, 8, 4, 2, 4, True),
    "decode_cap1": (8, 1, 32, 16, 2, 1, False),
}


@pytest.mark.parametrize("name", sorted(GATING))
def test_moe_gating_matches_reference(name):
    G, S, d, E, k, cap, tie = GATING[name]
    x, w = _gating_case(G, S, d, E, seed=len(name), tie=tie)
    wd, wc, waux = ref_gating(jnp.asarray(x), jnp.asarray(w), top_k=k,
                              capacity=cap)
    dispatch, combine, aux = ops.moe_gating(
        torch.from_numpy(x), torch.from_numpy(w), top_k=k, capacity=cap)
    np.testing.assert_array_equal(dispatch.numpy(), np.asarray(wd))
    np.testing.assert_allclose(combine.numpy(), np.asarray(wc), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(aux.item(), float(waux), rtol=1e-6)
    routed = dispatch.sum().item()
    if name.startswith("drop"):
        assert routed < G * S * k, "this capacity should drop tokens"
    elif not tie:
        assert routed == G * S * k
    if tie:  # equal gates: the first experts take the tokens
        assert (dispatch.sum((1, 3))[:, 2:] == 0).all()


@pytest.fixture(scope="module")
def moe():
    ref_cfg = dataclasses.replace(jax_get_config(ARCH).reduced(), **FP32)
    cfg = dataclasses.replace(get_config(ARCH).reduced(), **FP32)
    vals, _ = split_tree(jax_layers.init_moe(ref_cfg, jax.random.PRNGKey(5)))
    vals = jax.tree_util.tree_map(np.asarray, vals)
    params = {k: torch.from_numpy(np.array(v)) for k, v in vals.items()}
    return ref_cfg, vals, cfg, params


@pytest.mark.parametrize("B,S,cf", [(2, 40, None), (1, 512, None),
                                    (3, 16, 1.25)])
def test_apply_moe_matches_reference(moe, B, S, cf):
    ref_cfg, vals, cfg, params = moe
    if cf is not None:  # full width's dropping capacity factor
        ref_cfg = dataclasses.replace(
            ref_cfg, moe=dataclasses.replace(ref_cfg.moe, capacity_factor=cf))
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=cf))
    x = np.random.default_rng(B * S).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)
    want, waux = ref_apply_moe(vals, jnp.asarray(x), ref_cfg)
    got, aux = L.apply_moe(params, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(aux.item(), float(waux), rtol=1e-5)


def test_decode_tokens_route_alone(moe):
    """A decode step's (B, 1, d) tokens each form their own group of
    capacity 1: a row's output does not depend on the other rows."""
    _, _, cfg, params = moe
    cfg = dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=1.25))
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (5, 1, cfg.d_model)).astype(np.float32))
    y, _ = L.apply_moe(params, x, cfg)
    for b in range(5):
        yb, _ = L.apply_moe(params, x[b:b + 1], cfg)
        torch.testing.assert_close(yb[0], y[b], rtol=1e-6, atol=1e-6)


def test_ungroupable_prompt_raises_like_the_reference(moe):
    ref_cfg, vals, cfg, params = moe
    x = np.zeros((1, 300, cfg.d_model), np.float32)
    with pytest.raises(TypeError):  # the reference fails to reshape
        ref_apply_moe(vals, jnp.asarray(x), ref_cfg)
    with pytest.raises(ValueError, match="groups of 256"):
        L.apply_moe(params, torch.from_numpy(x), cfg)
