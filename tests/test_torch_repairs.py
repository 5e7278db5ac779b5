"""Faults of the port against the reference, each pinned: a float write
into an integer KV pool without its scales raises ``TypeError`` before
anything is written (as ``tests/test_cache.py::
test_insert_refuses_silent_upcast_into_integer_pool`` pins for the
reference); a batch that does not split into the microbatches raises
``ValueError`` instead of training on a subset of its rows; the
messages of what is not ported name ROADMAP items, not queue numbers
(the serve CLI's sharded and fleet flags, refused before, now serve, and
the enc-dec family, refused on a mesh before, serves there with one
device's tokens); and Mamba's softplus passes ``jax.nn.softplus``'s
gradient at 0."""
import dataclasses
import types

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.dist import spmd  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.serve.engine import ServeConfig  # noqa: E402
from repro_torch.train import steps  # noqa: E402
from repro_torch.utils import tree_leaves  # noqa: E402


@pytest.mark.parametrize("kv", ["int8", "int4"])
def test_insert_refuses_float_into_integer_pool_without_scales(kv):
    """The reference's paged pools, scales stripped, copied into the
    port: a float write raises before the pools change; the intact
    quantized cache takes the same write."""
    cfg = dataclasses.replace(jax_get_config("yi-9b").reduced(),
                              kv_cache_dtype=kv)
    K, hd = cfg.n_kv_heads, cfg.head_dim
    ref = JL.init_paged_kv_cache(cfg, 2, 4)
    cache = {k: torch.from_numpy(np.array(v)) for k, v in ref.items()}
    bare = {k: v.clone() for k, v in cache.items()
            if k not in ("kp_scale", "vp_scale")}
    assert bare["kp"].dtype == torch.int8
    pt = torch.tensor([[0, 1]], dtype=torch.int32)
    pos = torch.tensor([0], dtype=torch.int32)
    nv = torch.tensor([2], dtype=torch.int32)
    kc = torch.full((1, 2, K, hd), 0.7)
    before = {k: v.clone() for k, v in bare.items()}
    with pytest.raises(TypeError, match="quantization scales"):
        L.paged_cache_insert(bare, kc, kc, pt, pos, nv)
    for k in bare:
        assert torch.equal(bare[k], before[k])
    with pytest.raises(TypeError, match="quantization scales"):
        L.paged_cache_insert(bare, kc.bfloat16(), kc.bfloat16(), pt, pos, nv)
    L.paged_cache_insert(cache, kc, kc, pt, pos, nv)
    assert (cache["kp_scale"][0, :2] > 0).all()
    # the reference refuses the same write
    jbare = {k: v for k, v in ref.items() if k not in ("kp_scale", "vp_scale")}
    with pytest.raises(TypeError, match="quantization scales"):
        JL.paged_cache_insert(jbare, jnp.asarray(kc.numpy()),
                              jnp.asarray(kc.numpy()), jnp.asarray(pt.numpy()),
                              jnp.asarray(pos.numpy()), jnp.asarray(nv.numpy()))


def test_float_pools_still_take_float_writes():
    cfg = get_config("gemma-7b").reduced()
    cache = L.init_paged_kv_cache(cfg, 2, 4, device="cpu")
    layer = {k: v[0] for k, v in cache.items()}
    K, hd = cfg.n_kv_heads, cfg.head_dim
    kc = torch.ones((1, 2, K, hd), dtype=torch.float32)
    L.paged_cache_insert(layer, kc, kc, torch.tensor([[0, 1]]),
                         torch.tensor([0]), torch.tensor([2]))
    assert (layer["kp"][0, :2] == 1).all()


def test_microbatches_that_do_not_divide_the_batch_raise():
    cfg = dataclasses.replace(get_config("gemma-7b").reduced(),
                              dtype="float32", n_layers=1, microbatches=2)
    opt = steps.make_optimizer(cfg)
    state = steps.init_train_state(cfg, opt, device="cpu")
    before = [w.clone() for w in tree_leaves(state["params"])]
    step = steps.make_train_step(cfg, opt)
    batch = {"tokens": torch.randint(0, cfg.vocab, (5, 8),
                                     generator=torch.Generator().manual_seed(0))}
    with pytest.raises(ValueError, match="5 rows .* 2 microbatches"):
        step(state, batch)
    assert all(torch.equal(a, b) for a, b in zip(
        before, tree_leaves(state["params"])))
    assert int(state["opt"]["step"]) == 0


def test_not_ported_messages_name_roadmap_items(capsys):
    assert ServeConfig(temperature=0.5, seed=1).temperature == 0.5  # ported
    assert get_config("qwen2-vl-7b").frontend == "vision_patches"  # ported
    from repro_torch.models import resnet

    # ported: without a mesh, bn_group_size is inert, as in the reference
    cfg = dataclasses.replace(resnet.RESNET_TINY, bn_group_size=2,
                              dtype="float32")
    params = resnet.init_resnet(cfg, device="cpu")
    x = torch.randn((2, 16, 16, 3), generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        assert torch.equal(
            resnet.forward(params, cfg, x),
            resnet.forward(params, dataclasses.replace(cfg, bn_group_size=1),
                           x))
    # ported: sharded serving and the fleet
    assert serve_cli.main(["--arch", "gemma-7b", "--device", "cpu",
                           "--tokens", "2", "--batch", "2",
                           "--serve-mode", "fsdp"]) == 0
    assert capsys.readouterr().out.startswith(
        "gemma-7b [offline, mode=fsdp, device=cpu, slots=2, kv=paged]: ")
    assert serve_cli.main(["--arch", "gemma-7b", "--device", "cpu",
                           "--tokens", "2", "--batch", "2",
                           "--n-replicas", "2"]) == 0
    assert capsys.readouterr().out.startswith(
        "gemma-7b [fleet x2, routing=prefix, slots=2/replica, kv=paged]: ")
    # ported: MoE layers over a model axis (no refusal), and the MoE
    # model's tokens on a mesh those of one device
    mesh = types.SimpleNamespace(shape={"data": 1, "model": 2})
    argv = ["--arch", "mixtral-8x7b", "--device", "cpu", "--tokens", "2",
            "--batch", "2"]
    assert serve_cli.main(argv) == 0
    plain = capsys.readouterr().out.splitlines()
    assert serve_cli.main(argv + ["--serve-mode", "tp2d"]) == 0
    meshed = capsys.readouterr().out.splitlines()
    assert meshed[0].startswith("mixtral-8x7b [offline, mode=tp2d, ")
    def reqs(lines):  # "  req ID: prompt P -> N tokens [...]", ids apart
        return [ln.split(":", 1)[1] for ln in lines if ln.startswith("  req ")]

    assert reqs(meshed) == reqs(plain) and len(reqs(plain)) == 2
    for what in ("train", "serve"):
        assert spmd.check_supported(get_config("mixtral-8x7b").reduced(),
                                    mesh, what) is None
        # ported: the enc-dec family on a mesh; a mesh without a data
        # axis is what stays refused
        assert spmd.check_supported(get_config("whisper-medium").reduced(),
                                    mesh, what) is None
        with pytest.raises(ValueError, match="needs a 'data' axis"):
            spmd.check_supported(get_config("whisper-medium").reduced(),
                                 types.SimpleNamespace(shape={"model": 2}),
                                 what)
    # and whisper's tokens on a mesh those of one device
    argv[1] = "whisper-medium"
    assert serve_cli.main(argv) == 0
    plain = capsys.readouterr().out.splitlines()
    assert serve_cli.main(argv + ["--serve-mode", "tp2d"]) == 0
    meshed = capsys.readouterr().out.splitlines()
    assert meshed[0].startswith("whisper-medium [offline, mode=tp2d, ")
    assert reqs(meshed) == reqs(plain) and len(reqs(plain)) == 2


def test_softplus_gradient_at_zero_is_the_references():
    """``jax.nn.softplus`` is ``logaddexp(x, 0)``, whose gradient at x = 0
    is 0.5; the port's written-out softplus (Mamba's dt) passed 1 there
    (``clamp_min``). Values and gradients at and around 0 now match."""
    x = np.asarray([-30., -2., -1e-3, 0., 1e-3, 0.5, 30.], np.float32)
    want = np.asarray(jax.vmap(jax.grad(jax.nn.softplus))(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = L._softplus(xt)
    got.sum().backward()
    np.testing.assert_allclose(got.detach().numpy(),
                               np.asarray(jax.nn.softplus(x)), rtol=1e-6)
    np.testing.assert_allclose(xt.grad.numpy(), want, rtol=1e-6, atol=1e-7)
    assert xt.grad[3].item() == 0.5
