"""The port's ResNet v1.5 against ``repro.models.resnet`` on the same
(bridged) weights: parameter count, names and the weight bridge; SAME
padding where it is asymmetric (stride 2), which symmetric padding gets
wrong; batch norm and the masked eval metric; forward logits in fp32 and
bf16 over configs that exercise the stride-2 stem, its max pool and the
basic block; feature shapes; loss, accuracy and every gradient against
``jax.grad``; 3 LARS steps of each rule against the reference's jitted
example step; the reference's convergence test on the port; the CLI on
the CPU and its refusal without a card; and, on a card only (marked
``cuda``), the reduced model card against CPU."""
import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import distributed_eval as jax_eval  # noqa: E402
from repro.core import distributed_norm as jax_dn  # noqa: E402
from repro.dist import split_tree  # noqa: E402
from repro.models import resnet as JR  # noqa: E402
from repro.optim import lars as jax_lars  # noqa: E402
from repro.optim import polynomial_warmup as jax_poly  # noqa: E402
from repro_torch.core import distributed_eval as ev  # noqa: E402
from repro_torch.core.distributed_norm import batch_norm  # noqa: E402
from repro_torch.kernels import lars as lk  # noqa: E402
from repro_torch.launch import resnet as cli  # noqa: E402
from repro_torch.models import resnet as R  # noqa: E402
from repro_torch.optim import lars, polynomial_warmup  # noqa: E402
from repro_torch.utils import tree_leaves  # noqa: E402

KEY = jax.random.PRNGKey(0)
# name -> (config overrides on RESNET_TINY, image size): the example's
# 16 x 16; the stride-2 stem and its max pool at 32 (where the stem, the
# pool and the stride-2 3 x 3 all pad (lo, lo + 1): the SAME trap) and at
# 30 (an odd map after the stem); the basic block.
CONFIGS = {
    "tiny16": ({}, 16),
    "pool32": (dict(stem_stride=2, stem_pool=True), 32),
    "pool30": (dict(stem_stride=2, stem_pool=True), 30),
    "basic30": (dict(block="basic", stem_stride=2, stem_pool=True), 30),
}


def _cfgs(name, dtype="float32"):
    kw, size = CONFIGS[name]
    kw = dict(kw, dtype=dtype)
    return (dataclasses.replace(JR.RESNET_TINY, **kw),
            dataclasses.replace(R.RESNET_TINY, **kw), size)


def _jax_params(cfg, key=KEY):
    tree = split_tree(JR.init_resnet(cfg, key))[0]
    return jax.tree_util.tree_map(np.asarray, tree)


def _images(n, size, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (n, size, size, 3)).astype(np.float32)


def _batch(n, size, classes, seed=0):
    imgs = _images(n, size, seed)
    labels = (imgs.mean((1, 2, 3)) * 25).astype(np.int32) % classes
    return imgs, labels


def test_resnet50_param_count_and_leaves():
    params = R.init_resnet(R.RESNET50, seed=0, device="cpu")
    leaves = tree_leaves(params)
    assert sum(p.numel() for p in leaves) == 25_557_032
    kernel = [p for p in leaves if p.dim() > 1]
    assert len(kernel) == 54 and len(leaves) - len(kernel) == 107
    # every kernel leaf takes the kernels (the smallest is 1x1x64x64)
    assert min(p.numel() for p in kernel) == 4096
    assert sum(p.numel() for p in kernel) == 25_502_912
    want = jax.eval_shape(lambda k: split_tree(
        JR.init_resnet(JR.RESNET50, k))[0], KEY)
    assert sum(int(np.prod(s.shape))
               for s in jax.tree_util.tree_leaves(want)) == 25_557_032


@pytest.mark.parametrize("name", ["tiny16", "basic30"])
def test_init_matches_reference_names_shapes_and_scales(name):
    jcfg, cfg, _ = _cfgs(name)
    tree = _jax_params(jcfg)
    params = R.init_resnet(cfg, seed=0, device="cpu")
    assert sorted(params) == sorted(tree)
    got = R.params_to_numpy(params)
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(tree)):
        assert a.shape == b.shape
    s1 = params["s1b0"]
    assert s1["conv2"].std().item() == pytest.approx(
        (2 / (9 * s1["conv2"].shape[1])) ** 0.5, rel=0.05)
    assert params["head"].std().item() == pytest.approx(
        params["head"].shape[0] ** -0.5, rel=0.1)
    assert (params["stem_bn"]["scale"] == 1).all()
    assert (params["head_bias"] == 0).all()
    again = R.init_resnet(cfg, seed=0, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(params),
                                                 tree_leaves(again)))


def test_weight_bridge_round_trip():
    jcfg, _, _ = _cfgs("pool32")
    tree = _jax_params(jcfg)
    params = R.params_from_numpy(tree, device="cpu")
    assert params["stem_conv"].shape == (16, 3, 7, 7)
    assert all(p.is_contiguous() and p.dtype == torch.float32
               for p in tree_leaves(params))
    back = R.params_to_numpy(params)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(tree)):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("size,k,stride,pads", [
    (224, 7, 2, (2, 3)), (56, 3, 2, (0, 1)), (112, 3, 2, (0, 1)),
    (56, 1, 2, (0, 0)), (56, 3, 1, (1, 1)), (30, 7, 2, (2, 3)),
    (15, 3, 2, (1, 1))])
def test_same_pads_split_as_xla(size, k, stride, pads):
    assert R.same_pads(size, k, stride) == pads


@pytest.mark.parametrize("size,k,stride", [(32, 7, 2), (16, 3, 2),
                                           (16, 1, 2), (15, 3, 2),
                                           (16, 3, 1)])
def test_conv_and_pool_match_xla_same(size, k, stride):
    """The port's conv and 3 x 3 stride-2 max pool against XLA's "SAME";
    where the pad is asymmetric, symmetric padding (``padding=k // 2``)
    differs."""
    rng = np.random.default_rng(k * 100 + size)
    x = rng.standard_normal((2, size, size, 4)).astype(np.float32)
    w = rng.standard_normal((k, k, 4, 5)).astype(np.float32)
    want = np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (stride, stride), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC")))
    cfg = dataclasses.replace(R.RESNET_TINY, dtype="float32")
    tw = torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1)))
    got = R.conv(torch.from_numpy(x), tw, stride, cfg).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    lo, hi = R.same_pads(size, k, stride)
    if lo != hi:
        sym = F.conv2d(torch.from_numpy(x).permute(0, 3, 1, 2), tw,
                       stride=stride, padding=k // 2).permute(0, 2, 3, 1)
        assert sym.shape != want.shape or np.abs(
            sym.numpy() - want).max() > 1e-2
    want_pool = np.asarray(jax.lax.reduce_window(
        jnp.asarray(x), -jnp.inf, jax.lax.max, (1, 3, 3, 1), (1, 2, 2, 1),
        "SAME"))
    np.testing.assert_array_equal(R.max_pool(torch.from_numpy(x)).numpy(),
                                  want_pool)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(4, 5, 6, 8), (7, 8)], ids=str)
def test_batch_norm_matches_reference(shape, dtype):
    """Batch statistics (no running ones), fp32, biased variance, eps
    1e-5, result in the input's dtype: y within 1e-5 (fp32) or one bf16
    rounding, mean and variance within 1e-6."""
    rng = np.random.default_rng(1)
    x = (3 + 2 * rng.standard_normal(shape)).astype(np.float32)
    scale = rng.standard_normal(shape[-1]).astype(np.float32)
    bias = rng.standard_normal(shape[-1]).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    wy, wmu, wvar = jax_dn.batch_norm(jnp.asarray(x, jdt), jnp.asarray(scale),
                                      jnp.asarray(bias))
    y, mu, var = batch_norm(torch.from_numpy(x).to(tdt),
                            torch.from_numpy(scale), torch.from_numpy(bias))
    assert y.dtype == tdt and mu.dtype == var.dtype == torch.float32
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(y.float().numpy(), np.asarray(wy, np.float32),
                               rtol=tol, atol=tol)
    np.testing.assert_allclose(mu.numpy(), np.asarray(wmu), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(var.numpy(), np.asarray(wvar), rtol=1e-5,
                               atol=1e-6)


def test_masked_metrics_match_reference():
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((11, 10)).astype(np.float32)
    labels = rng.integers(0, 10, 11)
    labels[:4] = logits[:4].argmax(-1)
    mask = np.array([1] * 8 + [0] * 3, np.float32)
    losses = rng.standard_normal(11).astype(np.float32)
    for fn, args in ((ev.masked_top1, (logits, labels, mask)),
                     (ev.masked_mean_loss, (losses, mask))):
        got = fn(*map(torch.from_numpy, args))
        want = getattr(jax_eval, fn.__name__)(*map(jnp.asarray, args))
        for a, b in zip(got, want):
            assert a.item() == pytest.approx(float(b), abs=1e-6)
    assert ev.masked_top1(*map(torch.from_numpy, (logits, labels, mask))
                          )[1].item() == 8


# fp32: the two sides differ in the order of their sums (measured
# ~5e-7 of the largest logit). bf16: both round to bf16 at the same
# places; one rounding flip moves a logit by ~0.4%.
FWD_TOL = {"float32": 1e-5, "bfloat16": 2e-2}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_forward_logits_match_reference(name, dtype):
    """Logits within FWD_TOL of the largest reference logit."""
    jcfg, cfg, size = _cfgs(name, dtype)
    tree = _jax_params(jcfg)
    x = _images(4, size)
    want = np.asarray(JR.forward(tree, jcfg, jnp.asarray(x)))
    got = R.forward(R.params_from_numpy(tree, device="cpu"), cfg,
                    torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == want.shape
    scale = np.abs(want).max()
    np.testing.assert_allclose(got.detach().numpy() / scale, want / scale,
                               rtol=0, atol=FWD_TOL[dtype])


@pytest.mark.parametrize("name", ["tiny16", "pool32"])
def test_features_shapes_and_values(name):
    """v1.5: the stride of a stage's first block is on the 3x3, so each
    later stage halves the map (tests/test_models_mlperf.py's check)."""
    jcfg, cfg, size = _cfgs(name)
    tree = _jax_params(jcfg)
    x = np.ones((1, size, size, 3), np.float32)
    want = JR.features(tree, jcfg, jnp.asarray(x))
    got = R.features(R.params_from_numpy(tree, device="cpu"), cfg,
                     torch.from_numpy(x))
    assert [tuple(f.shape) for f in got] == [f.shape for f in want]
    stem = size // 4 if cfg.stem_pool else size
    assert [f.shape[1] for f in got] == [stem, stem // 2]
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-4)
    one = R.features(R.params_from_numpy(tree, device="cpu"), cfg,
                     torch.from_numpy(x), n_stages=1)
    assert len(one) == 1 and torch.equal(one[0], got[0])


def _reference_relu_masks(jcfg, tree, batch, monkeypatch):
    """The reference's loss (eager) and, in call order, the inputs of
    every ReLU in its forward."""
    seen, relu = [], jax.nn.relu

    def record(x):
        seen.append(np.asarray(x))
        return relu(x)

    with monkeypatch.context() as mp:
        mp.setattr(jax.nn, "relu", record)
        JR.loss_fn(tree, jcfg, batch)
    return seen


# A ReLU input within fp32 noise of 0 can fall on either side in the two
# frameworks (measured: -8.7e-7 here, +4.1e-8 in the reference, where
# neighbouring values differ by up to 1.4e-6), and then the element's
# gradient passes on one side only.
KINK = 1e-5


@pytest.mark.parametrize("name", ["tiny16", "pool32", "basic30"])
def test_loss_acc_and_every_gradient_match_reference(name, monkeypatch):
    """Loss within 1e-5, acc exactly, every leaf's gradient within 1e-4
    of its largest reference entry; fp32. The port's ReLUs take the
    reference's masks, after asserting that the two sides agree on the
    sign of every ReLU input but those within ``KINK`` of 0."""
    jcfg, cfg, size = _cfgs(name)
    tree = _jax_params(jcfg)
    imgs, labels = _batch(8, size, jcfg.num_classes, seed=3)
    jb = {"images": jnp.asarray(imgs), "labels": jnp.asarray(labels)}
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p: JR.loss_fn(p, jcfg, jb), has_aux=True))(tree)
    masks = iter(_reference_relu_masks(jcfg, tree, jb, monkeypatch))
    relu, flips = torch.relu, []

    def relu_with_reference_mask(x):
        want = torch.from_numpy(np.array(next(masks)))
        assert want.shape == x.shape
        differ = (x.detach() > 0) != (want > 0)
        assert (x.detach()[differ].abs() < KINK).all()
        assert (want[differ].abs() < KINK).all()
        flips.append(int(differ.sum()))
        return torch.where(want > 0, x, torch.zeros((), dtype=x.dtype))

    params = R.params_from_numpy(tree, device="cpu")
    leaves = tree_leaves(params)
    for w in leaves:
        w.requires_grad_(True)
    batch = {"images": torch.from_numpy(imgs),
             "labels": torch.from_numpy(labels)}
    with torch.no_grad():
        plain_loss, _ = R.loss_fn(params, cfg, batch)
    monkeypatch.setattr(torch, "relu", relu_with_reference_mask)
    loss, aux = R.loss_fn(params, cfg, batch)
    monkeypatch.setattr(torch, "relu", relu)
    assert next(masks, None) is None and sum(flips) <= 2
    grads = torch.autograd.grad(loss, leaves)
    for got in (loss.item(), plain_loss.item()):
        np.testing.assert_allclose(got, float(jl), rtol=1e-5, atol=1e-5)
    assert aux["nll"] is loss
    assert aux["acc"].item() == pytest.approx(float(jm["acc"]), abs=1e-7)
    got = R.params_to_numpy(_unflatten(params, list(grads)))
    jleaves = jax.tree_util.tree_leaves(jg)
    assert len(jleaves) == len(grads)
    for g, w in zip(jax.tree_util.tree_leaves(got), jleaves):
        w = np.asarray(w)
        assert g.shape == w.shape
        scale = max(float(np.abs(w).max()), 1e-12)
        np.testing.assert_allclose(g / scale, w / scale, rtol=0, atol=1e-4)


def _unflatten(like, leaves):
    """``leaves`` (in ``tree_leaves`` order: keys sorted) in the structure
    of the dict ``like``."""
    it = iter(leaves)

    def fill(t):
        return {k: fill(t[k]) if isinstance(t[k], dict) else next(it)
                for k in sorted(t)}

    return fill(like)


def _jax_example_losses(jcfg, tree, imgs, labels, scaled, steps, sched):
    """The reference example's jitted train step (LARS under
    ``polynomial_warmup``), ``steps`` losses."""
    opt = jax_lars(jax_poly(*sched), scaled_momentum=scaled)
    st = opt.init(tree)
    batch = {"images": jnp.asarray(imgs), "labels": jnp.asarray(labels)}

    @jax.jit
    def train_step(vals, st):
        (l, m), g = jax.value_and_grad(
            lambda p: JR.loss_fn(p, jcfg, batch), has_aux=True)(vals)
        vals, st = opt.update(g, st, vals)
        return vals, st, l

    losses, vals = [], tree
    for _ in range(steps):
        vals, st, l = train_step(vals, st)
        losses.append(float(l))
    return losses


@pytest.mark.parametrize("scaled", [True, False], ids=["scaled", "unscaled"])
@pytest.mark.parametrize("name", ["tiny16", "pool32"])
def test_three_lars_steps_match_reference_example(name, scaled):
    """examples/mlperf_resnet_lars.py's step (LARS under
    ``polynomial_warmup(0.25, 10, 60)``) for 3 steps from the same
    weights and batch: losses within 1e-5 (fp32)."""
    jcfg, cfg, size = _cfgs(name)
    tree = _jax_params(jcfg)
    imgs, labels = _batch(16, size, jcfg.num_classes, seed=4)
    want = _jax_example_losses(jcfg, tree, imgs, labels, scaled, 3,
                               (0.25, 10, 60))
    params = R.params_from_numpy(tree, device="cpu")
    hist = cli.train(cfg, params,
                     lars(polynomial_warmup(0.25, 10, 60),
                          scaled_momentum=scaled),
                     {"images": torch.from_numpy(imgs),
                      "labels": torch.from_numpy(labels.astype(np.int64))},
                     steps=3, device="cpu", log=lambda _: None)
    got = [r["loss"] for r in hist]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert all(r["norm_launches"] == r["update_launches"] == 0 for r in hist)


def test_resnet_lars_converges_on_the_port():
    """tests/test_models_mlperf.py::test_resnet_lars_converges on the port,
    from the same (bridged) weights: RESNET_TINY, 16 images, unscaled LARS
    under ``polynomial_warmup(0.5, 2, 30)``, 25 steps, the last loss under
    0.6 of the first."""
    cfg = R.RESNET_TINY
    tree = _jax_params(JR.RESNET_TINY)
    imgs = _images(16, 16)
    labels = (imgs.mean((1, 2, 3)) * 20).astype(np.int32) % 10
    params = R.params_from_numpy(tree, device="cpu")
    hist = cli.train(cfg, params,
                     lars(polynomial_warmup(0.5, 2, 30),
                          scaled_momentum=False),
                     {"images": torch.from_numpy(imgs),
                      "labels": torch.from_numpy(labels.astype(np.int64))},
                     steps=25, device="cpu", log=lambda _: None)
    losses = [r["loss"] for r in hist]
    assert losses[-1] < losses[0] * 0.6, losses[::6]


def test_cli_runs_on_cpu(capsys):
    assert cli.main(["--device", "cpu", "--steps", "2"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "LARS variant: scaled (Fig. 5)"
    assert out[1].startswith("step 1: loss=") and out[2].startswith(
        "step 2: loss=")
    assert out[3].startswith("step 2: train_acc=") and out[3].endswith(
        "(over 19 real examples, padded to 24)")
    assert out[-1].startswith("done {'step': 2, 'loss': ")
    assert "'norm_launches': 0, 'update_launches': 0" in out[-1]
    assert cli.main(["--device", "cpu", "--steps", "1", "--unscaled"]) == 0
    assert capsys.readouterr().out.startswith(
        "LARS variant: unscaled (Fig. 6)")


def test_cli_data_equals_the_example():
    """The CLI's images, labels and eval set are the example's."""
    rng = np.random.default_rng(0)
    imgs = jnp.asarray(rng.standard_normal((64, 16, 16, 3)), jnp.float32)
    labels = (imgs.mean((1, 2, 3)) * 25).astype(jnp.int32) % 10
    ev_imgs = np.asarray(rng.standard_normal((19, 16, 16, 3)), np.float32)
    rng = np.random.default_rng(0)
    got_imgs, got_labels = cli.synthetic_images(64, 16, 10, rng)
    assert np.array_equal(got_imgs, np.asarray(imgs))
    assert np.array_equal(got_labels, np.asarray(labels))
    eval_set = cli.padded_eval_set(R.RESNET_TINY, 16, rng, "cpu")
    assert [tuple(b[0].shape) for b in eval_set] == [(8, 16, 16, 3)] * 3
    got_ev = torch.cat([b[0] for b in eval_set]).numpy()
    assert np.array_equal(got_ev[:19], ev_imgs) and not got_ev[19:].any()
    assert torch.cat([b[2] for b in eval_set]).sum().item() == 19


def test_cli_and_init_refuse_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["--steps", "1"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        R.init_resnet(R.RESNET_TINY)


@pytest.mark.parametrize("kw", [dict(bn_group_size=2),
                                dict(spatial_partition=True)], ids=str)
def test_mesh_only_options_raise(kw):
    cfg = dataclasses.replace(R.RESNET_TINY, **kw)
    params = R.init_resnet(R.RESNET_TINY, seed=0, device="cpu")
    x = torch.zeros(1, 16, 16, 3)
    for fn in (R.forward, R.features):
        with pytest.raises(NotImplementedError,
                           match="distribution, fleet and bench"):
            fn(params, cfg, x)


# --------------------------------------------------------------------------- #
# On the card (skipped without one).
# --------------------------------------------------------------------------- #
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("scaled", [True, False], ids=["scaled", "unscaled"])
def test_cuda_three_lars_steps_match_cpu(cuda_device, scaled):
    """pool32 in fp32 (TF32 off) on the card against the CPU: 3 LARS
    steps' losses within rtol 1e-4; on the card a step makes one norms
    launch and one update launch over the leaves of >= 1024 elements."""
    jcfg, cfg, size = _cfgs("pool32")
    tree = _jax_params(jcfg)
    imgs, labels = _batch(8, size, jcfg.num_classes, seed=5)
    n_kernel = sum(a.ndim > 1 and a.size >= 1024
                   for a in jax.tree_util.tree_leaves(tree))
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        out = {}
        for dev in ("cpu", cuda_device):
            params = R.params_from_numpy(tree, device=dev)
            hist = cli.train(cfg, params, lars(polynomial_warmup(0.5, 2, 30),
                                               scaled_momentum=scaled),
                             {"images": torch.from_numpy(imgs).to(dev),
                              "labels": torch.from_numpy(
                                  labels.astype(np.int64)).to(dev)},
                             steps=3, device=dev, log=lambda _: None)
            out[str(dev)] = hist
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    card = out[str(cuda_device)]
    assert n_kernel > 0
    assert all((r["norm_launches"], r["update_launches"]) == (1, 1)
               for r in card)
    np.testing.assert_allclose([r["loss"] for r in card],
                               [r["loss"] for r in out["cpu"]], rtol=1e-4)
    assert lk.lars_norms_multi_cuda.launches >= 3
