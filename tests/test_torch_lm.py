"""The port's model path against the JAX reference on the same weights:
config copy, layer pins (GeLU tanh form, RMSNorm, half-split RoPE), the
paged cache scatter (trash page included) and ``decode_chunk`` logits
on a mixed prefill / decode / idle batch."""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.dist import split_tree  # noqa: E402
from repro.models import layers as jax_layers  # noqa: E402
from repro.models import lm as jax_lm  # noqa: E402
from repro.train.steps import ModelAPI  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import lm  # noqa: E402

FP32 = dict(dtype="float32", kv_cache_dtype="float32", n_layers=2)


def _cfgs():
    """The same reduced gemma-7b on both sides, fp32, two layers."""
    return (dataclasses.replace(jax_get_config("gemma-7b").reduced(), **FP32),
            dataclasses.replace(get_config("gemma-7b").reduced(), **FP32))


def _plain(value):
    """A field for comparison across the two packages' dataclasses."""
    if dataclasses.is_dataclass(value):
        return dataclasses.asdict(value)
    if isinstance(value, tuple):
        return [_plain(v) for v in value]
    return value


@pytest.mark.parametrize("arch", ["gemma-7b", "jamba-1.5-large-398b"])
@pytest.mark.parametrize("reduced", [False, True])
def test_config_copy_matches_reference(reduced, arch):
    ref_cfg, cfg = jax_get_config(arch), get_config(arch.replace("-", "_")
                                                   .replace(".", "_"))
    if reduced:
        ref_cfg, cfg = ref_cfg.reduced(), cfg.reduced()
    for f in dataclasses.fields(ModelConfig):
        assert _plain(getattr(cfg, f.name)) == _plain(getattr(ref_cfg,
                                                              f.name)), f.name
    assert cfg.n_blocks == ref_cfg.n_blocks
    assert cfg.param_count() == ref_cfg.param_count()
    want = {("gemma-7b", False): (256, 28), ("gemma-7b", True): (64, 1),
            ("jamba-1.5-large-398b", False): (128, 72),
            ("jamba-1.5-large-398b", True): (64, 3)}[arch, reduced]
    assert (cfg.head_dim, cfg.n_layers) == want


def test_other_archs_refused_by_name():
    """Every arch of the JAX package is ported, in its registry's order
    (module-style ids too); an unknown id raises ``KeyError`` naming it,
    and a layer kind the port does not know ``NotImplementedError``."""
    from repro.configs import list_archs as jax_list_archs
    from repro_torch.configs import list_archs
    from repro_torch.configs.base import LayerSpec

    assert list_archs() == jax_list_archs()
    assert get_config("rwkv6_3b") is get_config("rwkv6-3b")
    assert get_config("qwen2_vl_7b") is get_config("qwen2-vl-7b")
    with pytest.raises(KeyError, match="no-such-arch"):
        get_config("no-such-arch")
    cfg = ModelConfig("t", 1, 8, 8, 8, block_pattern=(LayerSpec("conv"),))
    with pytest.raises(NotImplementedError, match=r"\(conv, dense\) layer "
                       r"is not ported.*attn/mamba/rwkv6"):
        lm.init_lm(cfg, device="cpu")


def test_gelu_is_the_tanh_form():
    x = np.linspace(-6, 6, 97).astype(np.float32)
    cfg = ModelConfig("t", 1, 8, 8, 8, activation="gelu")
    got = L._ACT[cfg.activation](torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax.nn.gelu(x)), rtol=1e-6,
                               atol=1e-6)
    erf = torch.nn.functional.gelu(torch.from_numpy(x)).numpy()
    assert np.abs(got - erf).max() > 1e-4  # the erf form would diverge


def test_rmsnorm_matches_reference():
    rng = np.random.RandomState(0)
    x = rng.standard_normal((2, 3, 16)).astype(np.float32) * 3
    scale = rng.standard_normal(16).astype(np.float32)
    want = jax_layers.apply_norm({"scale": jnp.asarray(scale)},
                                 jnp.asarray(x), None)
    got = L.apply_norm({"scale": torch.from_numpy(scale)},
                       torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_rope_half_split_matches_reference():
    rng = np.random.RandomState(1)
    x = rng.standard_normal((2, 5, 3, 64)).astype(np.float32)
    posm = (np.array([[0], [37]]) + np.arange(5)[None]).astype(np.int32)
    want = jax_layers.apply_rope(jnp.asarray(x), jnp.asarray(posm),
                                 theta=10000.0)
    got = L.apply_rope(torch.from_numpy(x), torch.from_numpy(posm),
                       theta=10000.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_paged_cache_insert_matches_reference_trash_page_included():
    """Valid tokens land in their rows' pages; past-n_valid tokens and an
    unmapped (idle) row land in the trash page, at non-colliding offsets
    here so its content is defined on both sides."""
    P1, page, K, hd = 6, 4, 2, 8
    rng = np.random.RandomState(2)
    pool = rng.standard_normal((P1, page, K, hd)).astype(np.float32)
    k_new = rng.standard_normal((3, 2, K, hd)).astype(np.float32)
    v_new = rng.standard_normal((3, 2, K, hd)).astype(np.float32)
    pt = np.array([[3, -1], [1, 4], [-1, -1]], np.int32)
    pos = np.array([0, 5, 0], np.int32)
    nv = np.array([2, 1, 1], np.int32)
    want = jax_layers.paged_cache_insert(
        {"kp": jnp.asarray(pool), "vp": jnp.asarray(pool)},
        jnp.asarray(k_new), jnp.asarray(v_new), jnp.asarray(pt),
        jnp.asarray(pos), jnp.asarray(nv))
    cache = {"kp": torch.from_numpy(pool.copy()),
             "vp": torch.from_numpy(pool.copy())}
    got = L.paged_cache_insert(cache, torch.from_numpy(k_new),
                               torch.from_numpy(v_new), torch.from_numpy(pt),
                               torch.from_numpy(pos), torch.from_numpy(nv))
    for name in ("kp", "vp"):
        np.testing.assert_array_equal(got[name].numpy(),
                                      np.asarray(want[name]))
    assert not np.array_equal(got["kp"][P1 - 1].numpy(), pool[P1 - 1])


def test_paged_copy_pages_matches_reference():
    rng = np.random.RandomState(3)
    pool = rng.standard_normal((2, 5, 2, 1, 4)).astype(np.float32)
    want = jax_layers.paged_copy_pages(
        {"kp": jnp.asarray(pool), "vp": jnp.asarray(pool)}, [0, 3], [2, 1])
    got = L.paged_copy_pages({"kp": torch.from_numpy(pool.copy()),
                              "vp": torch.from_numpy(pool.copy())},
                             [0, 3], [2, 1])
    np.testing.assert_array_equal(got["kp"].numpy(), np.asarray(want["kp"]))


def _mixed_batch(cfg_vocab, n_pages, page):
    """Row 0 prefills a 4-token chunk, row 1 decodes at position 5 over
    two mapped pages, row 2 is idle (n_valid 1, no pages)."""
    rng = np.random.RandomState(4)
    toks = rng.randint(0, cfg_vocab, size=(3, 4)).astype(np.int32)
    pt = np.full((3, 4), -1, np.int32)
    pt[0, 0] = 7
    pt[1, :2] = [2, 9]
    pos = np.array([0, 5, 0], np.int32)
    nv = np.array([4, 1, 1], np.int32)
    return toks, pt, pos, nv


def test_decode_chunk_logits_and_cache_match_reference():
    ref_cfg, cfg = _cfgs()
    vals, _ = split_tree(ModelAPI(ref_cfg).init(ref_cfg,
                                                jax.random.PRNGKey(0)))
    tree = jax.tree_util.tree_map(np.asarray, vals)
    params = lm.params_from_numpy(tree, cfg, device="cpu")
    assert len(params["layers"]) == 2
    assert params["layers"][0]["mixer"]["wo"].shape == (4, 64, 256)

    n_pages, page = 12, 4
    jcache = jax_lm.init_paged_cache(ref_cfg, n_pages, page)
    shape = jcache[0]["kp"].shape  # (n_blocks, n_pages + 1, page, K, hd)
    rng = np.random.RandomState(5)  # earlier tokens already in the pool
    kp0 = rng.standard_normal(shape).astype(np.float32)
    vp0 = rng.standard_normal(shape).astype(np.float32)
    toks, pt, pos, nv = _mixed_batch(cfg.vocab, n_pages, page)

    want, wcache = jax_lm.decode_chunk(
        vals, ref_cfg, jnp.asarray(toks),
        ({"kp": jnp.asarray(kp0), "vp": jnp.asarray(vp0)},),
        jnp.asarray(pt), jnp.asarray(pos), jnp.asarray(nv))
    cache = lm.init_paged_cache(cfg, n_pages, page, device="cpu")
    assert tuple(cache["kp"].shape) == shape
    cache["kp"].copy_(torch.from_numpy(kp0))
    cache["vp"].copy_(torch.from_numpy(vp0))
    with torch.inference_mode():
        got, cache = lm.decode_chunk(
            params, cfg, torch.from_numpy(toks), cache,
            torch.from_numpy(pt), torch.from_numpy(pos),
            torch.from_numpy(nv))
    assert got.shape == (3, cfg.vocab)
    np.testing.assert_allclose(got[:2].numpy(), np.asarray(want)[:2],
                               rtol=1e-4, atol=1e-4)
    # real pages agree; the trash page takes colliding garbage writes
    for name in ("kp", "vp"):
        np.testing.assert_allclose(
            cache[name][:, :n_pages].numpy(),
            np.asarray(wcache[0][name])[:, :n_pages], rtol=1e-5, atol=1e-5)


def test_init_lm_shapes_scales_and_seed():
    cfg = get_config("gemma-7b").reduced()
    a = lm.init_lm(cfg, 0, device="cpu")
    b = lm.init_lm(cfg, 0, device="cpu")
    assert a["embed"].dtype == torch.bfloat16
    assert torch.equal(a["embed"], b["embed"])
    wo = a["layers"][0]["mixer"]["wo"].float()
    assert wo.shape == (4, 64, 256)
    assert abs(wo.std().item() - 256 ** -0.5) < 0.1 * 256 ** -0.5
    assert a["final_norm"]["scale"].dtype == torch.float32  # read in fp32
    assert torch.equal(a["final_norm"]["scale"], torch.ones(256))
