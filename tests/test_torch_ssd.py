"""The port's SSD (``repro_torch.models.ssd``) against the JAX reference
(``repro.models.ssd``): ``SSD_TINY`` (a basic-block ResNet of 2 stages,
width 16, at 64 x 64; extras (64, 64); 11 classes, 4 anchors a
location: 5,376 anchors) in fp32, its weights from the reference's
``init_ssd`` through ``ssd.params_from_numpy`` with the batch norms'
scales and biases perturbed (so that a zero image makes constant maps,
not zeros), batches from a numpy seed.

Held: the configs; the published parameter count (31,123,264, stage 4
and the 0-class head included) and the 2,000 anchors of ``SSDConfig()``
from the shapes alone; the bridge; the class and box outputs, anchor by
anchor in the reference's NHWC order; the loss and every gradient on a
random batch, on a batch with no positives, and on the reference's zero
image, where every interior location of a level ties, and the hard
negatives are picked among tied losses by the two stable argsorts
(held through the gradient with respect to the image, which tells the
picked anchors apart; reversing the order among ties fails it); spatial
partitioning refused; ``launch/mlperf.py`` on the CPU, twice.

Tolerances: fp32 outputs rtol 1e-4 / atol 1e-5; the loss rtol 1e-5;
gradients within 1e-4 of (their leaf's largest entry + 1e-6), sums in
other orders; at the zero image the loss rtol 1e-4 and gradients 1e-3
(``ZERO_IMAGE_TOL``: its batch norms divide by near-zero variances),
where the other tie order misses the image gradient by more than 1e-2
of its largest entry."""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.dist import split_tree  # noqa: E402
from repro.models import ssd as JS  # noqa: E402
from repro_torch.launch import mlperf as cli  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models import resnet as R  # noqa: E402
from repro_torch.models import ssd as S  # noqa: E402
from repro_torch.utils import tree_leaves  # noqa: E402


def fp32(cfg):
    return dataclasses.replace(cfg, dtype="float32", backbone=dataclasses.
                               replace(cfg.backbone, dtype="float32"))


JCFG, CFG = fp32(JS.SSD_TINY), fp32(S.SSD_TINY)
# (loss rtol, gradient tolerance) at the zero image: batch norm over maps
# that are constant but at their borders divides by near-zero variances,
# which magnifies the order of sums (measured: 1.2e-5 on the box loss,
# 2.2e-4 on a gradient)
ZERO_IMAGE_TOL = (1e-4, 1e-3)


def ref_tree(seed=0):
    vals = jax.jit(lambda k: split_tree(JS.init_ssd(JCFG, k))[0])(
        jax.random.PRNGKey(seed))
    return lm.perturb_norms(jax.tree_util.tree_map(np.asarray, vals),
                            seed + 100)


def batch_of(seed, *, zero_images=False, positives=True, B=2):
    rng = np.random.default_rng(seed)
    A = S.num_anchors(CFG)
    n = CFG.image_size
    images = rng.standard_normal((B, n, n, 3)).astype(np.float32)
    if zero_images:
        images[:] = 0
    cls = rng.integers(0, CFG.num_classes, (B, A)).astype(np.int32)
    if not positives:
        cls[:] = 0
    elif zero_images:  # a few positives, so that k picks among ties
        cls = np.where(rng.random((B, A)) < 0.004, cls, 0).astype(np.int32)
    box = rng.standard_normal((B, A, 4)).astype(np.float32)
    return {"images": images, "cls_targets": cls, "box_targets": box}


def port_grads(tree, batch, *, image_grad=False):
    params = S.params_from_numpy(tree, device="cpu")
    leaves = tree_leaves(params)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    if image_grad:
        tb["images"].requires_grad_(True)
    for w in leaves:
        w.requires_grad_(True)
    loss, m = S.loss_fn(params, CFG, tb)
    wrt = leaves + ([tb["images"]] if image_grad else [])
    grads = torch.autograd.grad(loss, wrt, allow_unused=True)
    grads = [torch.zeros_like(w) if g is None else g
             for w, g in zip(wrt, grads)]
    as_tree = S.params_to_numpy(_unflatten(params, grads[:len(leaves)]))
    return loss.item(), m, as_tree, (grads[-1] if image_grad else None)


def _unflatten(params, flat):
    it = iter(flat)

    def walk(t):
        return {k: walk(t[k]) if isinstance(t[k], dict) else next(it)
                for k in sorted(t)}

    return walk(params)


def assert_grads_close(got_tree, want_tree, tol):
    got = jax.tree_util.tree_leaves(got_tree)
    want = jax.tree_util.tree_leaves(want_tree)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=tol * (np.abs(w).max() + 1e-6))


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
    """The reference's loss, gradient and image gradient at each batch,
    computed once."""
    def loss(p, im, b):
        return JS.loss_fn(p, JCFG, {**b, "images": im})

    vg = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))
    out = {}
    for name, b in (("random", batch_of(1)),
                    ("no_positives", batch_of(2, positives=False)),
                    ("zero_image_ties", batch_of(3, zero_images=True))):
        (l, m), (g, gi) = vg(tree, b["images"], b)
        out[name] = (b, float(l), {k: float(v) for k, v in m.items()}, g,
                     np.asarray(gi))
    return out


# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("name", ["full", "tiny"])
def test_config_copy_params_and_anchors(name):
    """Every field of both configs (the backbone's too); the parameter
    count from shapes and the anchors from the reckoning equal the
    reference's ``jax.eval_shape`` counts."""
    ref, cfg = {"full": (JS.SSDConfig(), S.SSDConfig()),
                "tiny": (JS.SSD_TINY, S.SSD_TINY)}[name]
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
    shapes = jax.eval_shape(lambda k: split_tree(JS.init_ssd(ref, k))[0],
                            jax.random.PRNGKey(0))
    want = sum(int(np.prod(a.shape))
               for a in jax.tree_util.tree_leaves(shapes))
    assert S.param_count(cfg) == want
    if name == "full":
        assert want == 31_123_264
        assert S.level_sizes(cfg) == [19, 10, 5, 3, 2, 1]
        assert S.num_anchors(cfg) == 4 * (19**2 + 10**2 + 5**2 + 3**2 + 2**2
                                          + 1) == 2000
    else:
        assert S.num_anchors(cfg) == JS.num_anchors(ref) == 5376


def test_init_and_bridge_names_and_shapes(tree):
    mine = S.init_ssd(CFG, seed=0, device="cpu")
    params = S.params_from_numpy(tree, device="cpu")
    shape = lambda t: {k: shape(v) if isinstance(v, dict)  # noqa: E731
                       else tuple(v.shape) for k, v in t.items()}
    assert shape(mine) == shape(params)
    assert params["cls0"].shape == (4 * 11, 32, 3, 3)  # (out, in, kh, kw)
    np.testing.assert_array_equal(S.params_to_numpy(params)["box1"],
                                  tree["box1"])
    w = mine["extra0_b"]
    assert abs(w.std().item() - (2 / (9 * 32)) ** 0.5) < 0.05 * w.std()


def test_outputs_match_reference_in_anchor_order(tree):
    """The class and box outputs, anchor by anchor; anchor (y, x, j) of
    level 0 is row (y * W + x) * 4 + j, the NHWC head output's order (an
    NCHW head reshaped as it is would scramble them)."""
    b = batch_of(4)
    params = S.params_from_numpy(tree, device="cpu")
    want_c, want_b = JS.forward(tree, JCFG, b["images"])
    with torch.no_grad():
        got_c, got_b = S.forward(params, CFG, torch.from_numpy(b["images"]))
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(got_b.numpy(), np.asarray(want_b), rtol=1e-4,
                               atol=1e-5)
    with torch.no_grad():
        feat = R.features(params["backbone"], CFG.backbone,
                          torch.from_numpy(b["images"]), n_stages=2)[-1]
        head = R.same_conv(feat, params["cls0"], 1, torch.float32)
    B, H, W, _ = head.shape
    y, x, j = 5, 11, 3
    row = (y * W + x) * 4 + j
    np.testing.assert_array_equal(
        got_c[:, row].numpy(), head[:, y, x, j * 11:(j + 1) * 11].numpy())
    nchw = head.permute(0, 3, 1, 2).contiguous().reshape(B, -1, 11)
    assert not np.allclose(nchw.numpy(), got_c[:, :H * W * 4].numpy())


@pytest.mark.parametrize("case", ["random", "no_positives",
                                  "zero_image_ties"])
def test_loss_and_every_gradient_match_reference(tree, reference, case):
    b, want_l, want_m, want_g, want_gi = reference[case]
    loss_tol, grad_tol = ZERO_IMAGE_TOL if case == "zero_image_ties" \
        else (1e-5, 1e-4)
    loss, m, got_g, gi = port_grads(tree, b, image_grad=True)
    np.testing.assert_allclose(loss, want_l, rtol=loss_tol)
    for k in ("cls", "box"):
        np.testing.assert_allclose(m[k].item(), want_m[k], rtol=loss_tol,
                                   atol=1e-7)
    assert np.isfinite(loss)
    assert_grads_close(got_g, want_g, grad_tol)
    np.testing.assert_allclose(gi.numpy(), want_gi, rtol=0,
                               atol=grad_tol * np.abs(want_gi).max())
    if case == "no_positives":
        assert want_m["box"] == 0.0 and m["box"].item() == 0.0


def test_hard_negative_ties_pick_as_the_reference(tree, reference,
                                                  monkeypatch):
    """The zero image ties every interior location of a level; the
    reference ranks with two stable argsorts, so among tied losses the
    lower anchor index is kept. Breaking ties the other way keeps other
    anchors: the loss is the same, the image gradient is not."""
    b, want_l, _, _, want_gi = reference["zero_image_ties"]
    ce_ties = _tied_negatives(tree, b)
    assert ce_ties > 100  # many anchors share a loss value
    real_argsort = torch.argsort

    def reversed_ties(x, dim=-1, stable=False, descending=False):
        # ascending by value, ties by descending index
        n = x.shape[dim]
        flipped = real_argsort(x.flip(dim), dim=dim, stable=True)
        return (n - 1 - flipped) if x.dtype.is_floating_point else \
            real_argsort(x, dim=dim, stable=True)

    monkeypatch.setattr(torch, "argsort", reversed_ties)
    loss, _, _, gi = port_grads(tree, b, image_grad=True)
    monkeypatch.undo()
    np.testing.assert_allclose(loss, want_l, rtol=ZERO_IMAGE_TOL[0])
    assert np.abs(gi.numpy() - want_gi).max() > 1e-2 * np.abs(want_gi).max()


def _tied_negatives(tree, b):
    """How many negative anchors share their CE with another one."""
    params = S.params_from_numpy(tree, device="cpu")
    with torch.no_grad():
        c, _ = S.forward(params, CFG, torch.from_numpy(b["images"]))
        ce = -torch.log_softmax(c, -1).gather(
            -1, torch.from_numpy(b["cls_targets"]).long()[..., None])[..., 0]
    ce = ce[torch.from_numpy(b["cls_targets"]) == 0].numpy()
    _, counts = np.unique(ce, return_counts=True)
    return int(counts[counts > 1].sum())


def test_spatial_partition_refused(tree):
    """``spatial_partition=True`` without a mesh: as in the reference
    (``ssd.py:84-91``), the backbone gets ``mesh=None`` and the option is
    inert; the outputs and the loss are the reference's on that config."""
    params = S.params_from_numpy(tree, device="cpu")
    cfg = dataclasses.replace(CFG, spatial_partition=True)
    jcfg = dataclasses.replace(JCFG, spatial_partition=True)
    b = batch_of(5)
    (want_c, want_b), want_l = jax.jit(lambda p, bb: (
        JS.forward(p, jcfg, bb["images"], mesh=None),
        JS.loss_fn(p, jcfg, bb, mesh=None)[0]))(tree, b)
    want_l = float(want_l)
    with torch.no_grad():
        got_c, got_b = S.forward(params, cfg, torch.from_numpy(b["images"]),
                                 mesh=None)
        got_l = S.loss_fn(params, cfg, {k: torch.from_numpy(v)
                                        for k, v in b.items()}, mesh=None)[0]
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(got_b.numpy(), np.asarray(want_b), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(got_l.item(), want_l, rtol=1e-5)


def test_cli_on_cpu_repeats(capsys):
    """``launch/mlperf.py --model ssd --device cpu`` (``SSD_TINY``, bf16
    compute, batch 4 drawn as fig9 draws it): 3 finite losses, the same
    in a second run."""
    runs = []
    for _ in range(2):
        assert cli.main(["--model", "ssd", "--device", "cpu"]) == 0
        lines = capsys.readouterr().out.splitlines()
        assert lines[3].startswith("done")
        runs.append([float(ln.split("loss=")[1].split()[0])
                     for ln in lines[:3]])
    assert all(np.isfinite(runs[0])) and runs[0] == runs[1]
    b = cli.synthetic_batch("ssd", S.SSD_TINY, 4, np.random.default_rng(0))
    assert b["cls_targets"].shape == (4, 5376)
    assert b["box_targets"].shape == (4, 5376, 4)
