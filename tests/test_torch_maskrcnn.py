"""The port's Mask R-CNN (``repro_torch.models.maskrcnn``) and one-device
graph partitioning (``repro_torch.core.graph_partitioning``) against the
JAX reference (``repro.models.maskrcnn``): ``MASKRCNN_TINY`` (the
2-stage tiny ResNet at 32 x 32, FPN 16, 4 proposals, RoI 4, mask 8, 5
classes) in fp32, its weights from the reference's ``init_maskrcnn``
through ``maskrcnn.params_from_numpy`` (batch norms perturbed), batches
drawn as ``tests/test_models_mlperf.py`` draws them.

Held: the configs; the published parameter count (26,296,040) and the
1,024 RPN locations from shapes; the bridge (dense heads untransposed);
every forward output; the loss and every gradient; the five traps of the
reference, each against JAX itself: ``jax.lax.top_k``'s tie order on the
reference's own bf16 RPN scores (which tie), ``jax.image.resize``
nearest at 4 -> 7 (where ``mode="nearest"`` differs) and bilinear at 7
-> 14 (a shrink refused), ``roi_align`` and its gradients with the
whole-image box (whose samples sit on the clip bounds, where
``jnp.clip``'s gradient is half), the BCE's gradient at its clip bounds
and at 0; ``run_partitioned`` equal to the branches in order, a mesh
refused; ``launch/mlperf.py`` on the CPU, twice.

Tolerances: fp32 outputs rtol 1e-4 / atol 1e-5, the masks atol 2e-5 of
their largest entry (``MASK_TOL``: the crops' positions carry the RPN's
rounding); the loss rtol 1e-5;
gradients within 1e-4 of (their leaf's largest entry + 1e-6), sums in
other orders; resizes and ``roi_align`` within 1e-6 and their
gradients 1e-5 (the bilinear weights are formed as JAX forms them; the
sums' order differs), the boxes' gradient rtol 1e-5 / atol 1e-4; top-k
indices and nearest resizes exactly."""
import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.dist import split_tree  # noqa: E402
from repro.models import maskrcnn as JM  # noqa: E402
from repro_torch.core import graph_partitioning as GP  # noqa: E402
from repro_torch.launch import mlperf as cli  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models import maskrcnn as M  # noqa: E402
from repro_torch.utils import tree_leaves  # noqa: E402


def fp32(cfg):
    return dataclasses.replace(cfg, dtype="float32", backbone=dataclasses.
                               replace(cfg.backbone, dtype="float32"))


JCFG, CFG = fp32(JM.MASKRCNN_TINY), fp32(M.MASKRCNN_TINY)
# The masks read the features at the proposals' positions, which carry the
# RPN's rounding (5e-7 of the image, 1.6e-5 of a pixel at 32) times the
# features' slope: 1.1e-4 on crops of up to 9.8, 7.2e-5 on masks of up to
# ~6. Held within 2e-5 of their largest entry.
MASK_TOL = 2e-5


def ref_tree(jcfg=JCFG, seed=0, perturb=True):
    vals = jax.jit(lambda k: split_tree(JM.init_maskrcnn(jcfg, k))[0])(
        jax.random.PRNGKey(seed))
    vals = jax.tree_util.tree_map(np.asarray, vals)
    return lm.perturb_norms(vals, seed + 100) if perturb else vals


def batch_of(seed, B=2):
    """``test_maskrcnn_forward_loss_and_grads``'s draws, in its order."""
    rng = np.random.default_rng(seed)
    n, P, ms = CFG.image_size, CFG.num_proposals, CFG.mask_size
    images = rng.standard_normal((B, n, n, 3)).astype(np.float32)
    A = M.rpn_size(CFG) ** 2
    return {"images": images,
            "rpn_labels": rng.integers(0, 2, (B, A)).astype(np.int32),
            "cls_targets": rng.integers(0, CFG.num_classes,
                                        (B, P)).astype(np.int32),
            "box_targets": rng.standard_normal((B, P, 4)).astype(np.float32),
            "mask_targets": rng.integers(0, 2, (B, P, ms, ms)).astype(
                np.int32)}


def t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread while this file runs: the suite runs several
    workers on the machine's cores, and oversubscribed ones made the
    small convolutions here ~100x slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tree():
    return ref_tree()


@pytest.fixture(scope="module")
def reference(tree):
    b = batch_of(1)
    out = jax.jit(lambda p, im: JM.forward(p, JCFG, im))(tree, b["images"])
    (loss, m), g = jax.jit(jax.value_and_grad(
        lambda p: JM.loss_fn(p, JCFG, b), has_aux=True))(tree)
    return b, jax.tree_util.tree_map(np.asarray, out), float(loss), \
        {k: float(v) for k, v in m.items()}, g


# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("name", ["full", "tiny"])
def test_config_copy_and_param_count(name):
    ref, cfg = {"full": (JM.MaskRCNNConfig(), M.MaskRCNNConfig()),
                "tiny": (JM.MASKRCNN_TINY, M.MASKRCNN_TINY)}[name]
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
    shapes = jax.eval_shape(lambda k: split_tree(JM.init_maskrcnn(ref, k))[0],
                            jax.random.PRNGKey(0))
    want = sum(int(np.prod(a.shape))
               for a in jax.tree_util.tree_leaves(shapes))
    assert M.param_count(cfg) == want
    if name == "full":
        assert want == 26_296_040 and M.rpn_size(cfg) ** 2 == 1024


def test_init_and_bridge(tree):
    mine = M.init_maskrcnn(CFG, seed=0, device="cpu")
    params = M.params_from_numpy(tree, device="cpu")
    shape = lambda t: {k: shape(v) if isinstance(v, dict)  # noqa: E731
                       else tuple(v.shape) for k, v in t.items()}
    assert shape(mine) == shape(params)
    roi_feat = CFG.fpn_channels * CFG.roi_size ** 2
    assert params["head_cls"].shape == (roi_feat, CFG.num_classes)
    np.testing.assert_array_equal(params["head_cls"].numpy(),
                                  tree["head_cls"])
    assert params["mask_out"].shape == (CFG.num_classes, 16, 1, 1)
    back = M.params_to_numpy(params)
    for k in ("fpn_lat1", "rpn_box", "head_box", "mask_conv"):
        np.testing.assert_array_equal(back[k], tree[k])
    assert abs(mine["head_cls"].std().item() - roi_feat ** -0.5) < \
        0.1 * roi_feat ** -0.5


def test_forward_outputs_match_reference(tree, reference):
    b, want, *_ = reference
    params = M.params_from_numpy(tree, device="cpu")
    with torch.no_grad():
        got = M.forward(params, CFG, torch.from_numpy(b["images"]))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        atol = MASK_TOL * np.abs(want[k]).max() if k == "masks" else 1e-5
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=1e-4,
                                   atol=atol, err_msg=k)


def _unflatten(params, flat):
    it = iter(flat)

    def walk(t):
        return {k: walk(t[k]) if isinstance(t[k], dict) else next(it)
                for k in sorted(t)}

    return walk(params)


def test_loss_and_every_gradient_match_reference(tree, reference):
    b, _, want_loss, want_m, want_g = reference
    params = M.params_from_numpy(tree, device="cpu")
    leaves = tree_leaves(params)
    for w in leaves:
        w.requires_grad_(True)
    loss, m = M.loss_fn(params, CFG, t(b))
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(w) if g is None else g
             for w, g in zip(leaves, grads)]
    np.testing.assert_allclose(loss.item(), want_loss, rtol=1e-5)
    for k in ("rpn", "cls", "box", "mask"):
        np.testing.assert_allclose(m[k].item(), want_m[k], rtol=1e-5)
    got = jax.tree_util.tree_leaves(M.params_to_numpy(_unflatten(params,
                                                                  grads)))
    want = jax.tree_util.tree_leaves(want_g)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=1e-4 * (np.abs(w).max() + 1e-6))


# ---- the traps --------------------------------------------------------------- #
def test_top_k_breaks_ties_as_jax_on_the_reference_scores():
    """Trap 1: ``MASKRCNN_TINY`` at seed 0 in bf16 (the reference's own
    config) gives RPN scores that tie; on those very scores the port's
    top-k picks ``jax.lax.top_k``'s indices, the lower index first."""
    tree = ref_tree(JM.MASKRCNN_TINY, perturb=False)
    images = np.random.default_rng(0).standard_normal(
        (2, 32, 32, 3)).astype(np.float32)
    cfg = JM.MASKRCNN_TINY
    flat_s = np.array(jax.jit(lambda p, im: JM.rpn(
        p, cfg, JM.fpn_features(p, cfg, im))[2])(tree, images))
    assert len(np.unique(flat_s)) < flat_s.size // 2  # bf16 ties
    for k in (4, 16, 64):
        want_v, want_i = jax.lax.top_k(flat_s, k)
        got_v, got_i = M.top_k(torch.from_numpy(flat_s), k)
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
        np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    ties = np.asarray([[1., 3., 3., 2., 3.]], np.float32)
    assert M.top_k(torch.from_numpy(ties), 3)[1].tolist() == [[1, 2, 4]]


def test_nearest_resize_matches_jax_where_mode_nearest_does_not():
    """Trap 2: at 4 -> 7 ``jax.image.resize`` nearest picks ``floor((i +
    0.5) * 4 / 7)``, ``mode="nearest-exact"``; ``mode="nearest"``
    (``floor(i * 4 / 7)``) differs. At 2x both agree."""
    x = np.random.default_rng(2).standard_normal((2, 4, 4, 3)).astype(
        np.float32)
    for size in (7, 8):
        want = np.asarray(jax.image.resize(x, (2, size, size, 3), "nearest"))
        got = M.resize_nearest(torch.from_numpy(x), (size, size)).numpy()
        np.testing.assert_array_equal(got, want)
    plain = F.interpolate(torch.from_numpy(x).permute(0, 3, 1, 2),
                          size=(7, 7), mode="nearest").permute(0, 2, 3, 1)
    assert not np.array_equal(plain.numpy(), np.asarray(jax.image.resize(
        x, (2, 7, 7, 3), "nearest")))


def test_bilinear_resize_matches_jax_and_refuses_a_shrink():
    """Trap 3: upsampling 7 -> 14 (and the tiny config's 4 -> 8) as
    ``jax.image.resize`` bilinear, values and the gradient; shrinking,
    where JAX antialiases, raises."""
    rng = np.random.default_rng(3)
    for n, m in ((7, 14), (4, 8), (5, 5)):
        x = rng.standard_normal((3, n, n, 4)).astype(np.float32)
        w = rng.standard_normal((3, m, m, 4)).astype(np.float32)
        want, vjp = jax.vjp(lambda a: jax.image.resize(
            a, (3, m, m, 4), "bilinear"), x)
        xt = torch.from_numpy(x).requires_grad_(True)
        got = M.resize_bilinear(xt, m)
        got.backward(torch.from_numpy(w))
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=0, atol=1e-6)
        np.testing.assert_allclose(xt.grad.numpy(), np.asarray(vjp(w)[0]),
                                   rtol=0, atol=1e-5)
    with pytest.raises(NotImplementedError, match="antialias"):
        M.resize_bilinear(torch.zeros(1, 14, 14, 2), 7)


@pytest.mark.parametrize("whole", [True, False])
def test_roi_align_and_its_gradients_match_reference(whole):
    """The reference's crop-resize, values and the gradients with respect
    to the features and the boxes. The whole-image box at ``out_size ==
    H`` samples exactly at the clip bounds 0 and H - 1 (trap 4: there
    ``jnp.clip`` passes half the gradient, ``torch.clamp`` all of it)."""
    rng = np.random.default_rng(5)
    feat = rng.standard_normal((2, 8, 8, 3)).astype(np.float32)
    if whole:
        rois = np.tile(np.asarray([0., 0., 1., 1.], np.float32), (2, 3, 1))
    else:
        lo = rng.random((2, 3, 2)).astype(np.float32) * 0.6
        rois = np.concatenate([lo, lo + 0.3], -1).astype(np.float32)
    w = rng.standard_normal((2, 3, 8, 8, 3)).astype(np.float32)
    want, vjp = jax.vjp(lambda f, r: JM.roi_align(f, r, 8), feat, rois)
    want_df, want_dr = vjp(w)
    ft = torch.from_numpy(feat).requires_grad_(True)
    rt = torch.from_numpy(rois).requires_grad_(True)
    got = M.roi_align(ft, rt, 8)
    got.backward(torch.from_numpy(w))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(ft.grad.numpy(), np.asarray(want_df), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(rt.grad.numpy(), np.asarray(want_dr),
                               rtol=1e-5, atol=1e-4)
    if whole:  # the reference's identity-box test, on the port
        np.testing.assert_allclose(got[0, 0].detach().numpy(), feat[0],
                                   rtol=1e-5, atol=1e-5)


def test_clip_abs_and_bce_gradients_at_their_bounds():
    """Trap 4 in the loss: ``_bce`` clips the logits to +-30, takes
    ``max(z, 0)`` and ``|z|``; at exactly -30 and 30 the reference's
    gradient of the clip is the half one, at 0 that of the maximum is
    half and that of ``jnp.abs`` is 1 (``torch.abs``'s is 0); the box
    L1's ``|diff|`` at an exact hit likewise."""
    z = np.asarray([-31., -30., -1., 0., 0.5, 30., 31.], np.float32)
    y = np.asarray([1., 0., 1., 1., 0., 0., 1.], np.float32)
    want = np.asarray(jax.grad(lambda a: JM._bce(a, y).sum())(z))
    zt = torch.from_numpy(z).requires_grad_(True)
    M._bce(zt, torch.from_numpy(y)).sum().backward()
    np.testing.assert_allclose(zt.grad.numpy(), want, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(
        M._bce(torch.from_numpy(z), torch.from_numpy(y)).numpy(),
        np.asarray(JM._bce(z, y)), rtol=1e-6)
    x = torch.tensor([0., 0.5, 1.], requires_grad=True)
    L.jnp_clip(x, 0.0, 1.0).sum().backward()
    assert x.grad.tolist() == [0.5, 1.0, 0.5]
    d = torch.tensor([-1., 0., 2.], requires_grad=True)
    L.jnp_abs(d).sum().backward()
    assert d.grad.tolist() == np.asarray(jax.grad(lambda a: jnp.abs(
        a).sum())(np.asarray([-1., 0., 2.], np.float32))).tolist() == \
        [-1.0, 1.0, 1.0]


def test_run_partitioned_equals_branches_in_order():
    """C10 on one device: each output is its branch's, through fp32 and
    back to its dtype; a mesh waits on item 6."""
    a = torch.randn(3, 4)
    b = torch.randn(5).to(torch.bfloat16)
    branches = [lambda: a @ a.T, lambda: b * 2, lambda: a.sum(0)]
    got = GP.run_partitioned(branches)
    want = [f() for f in branches]
    assert [g.dtype for g in got] == [torch.float32, torch.bfloat16,
                                      torch.float32]
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    with pytest.raises(NotImplementedError, match="distribution, fleet"):
        GP.run_partitioned(branches, mesh=object())


def test_stage2_runs_its_branches_through_run_partitioned(tree, monkeypatch):
    params = M.params_from_numpy(tree, device="cpu")
    calls = []
    real = M.run_partitioned

    def spy(branches, **kw):
        calls.append(len(branches))
        return real(branches, **kw)

    monkeypatch.setattr(M, "run_partitioned", spy)
    with torch.no_grad():
        M.forward(params, CFG, torch.zeros(1, 32, 32, 3))
    assert calls == [3]


def test_spatial_partition_refused(tree):
    params = M.params_from_numpy(tree, device="cpu")
    cfg = dataclasses.replace(CFG, spatial_partition=True)
    with pytest.raises(NotImplementedError, match="distribution, fleet"):
        M.forward(params, cfg, torch.zeros(1, 32, 32, 3))


def test_cli_on_cpu_repeats(capsys):
    """``launch/mlperf.py --model maskrcnn --device cpu``
    (``MASKRCNN_TINY``, bf16 compute, batch 2): 3 finite losses, the same
    in a second run."""
    runs = []
    for _ in range(2):
        assert cli.main(["--model", "maskrcnn", "--device", "cpu"]) == 0
        lines = capsys.readouterr().out.splitlines()
        assert lines[3].startswith("done")
        runs.append([float(ln.split("loss=")[1].split()[0])
                     for ln in lines[:3]])
    assert all(np.isfinite(runs[0])) and runs[0] == runs[1]
    b = cli.synthetic_batch("maskrcnn", M.MASKRCNN_TINY, 2,
                            np.random.default_rng(0))
    assert b["rpn_labels"].shape == (2, 1024)
    assert b["mask_targets"].shape == (2, 4, 8, 8)
