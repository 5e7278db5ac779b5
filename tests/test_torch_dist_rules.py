"""The port's sharding policy (``repro_torch.dist.rules``) and spec
derivation (``repro_torch.dist.sharding.Rules``) against the reference's
``build_table`` and ``Rules.spec_for`` / ``param_spec`` / ``opt_spec``,
over every mode, with and without ``seq_parallel`` and the ``pod`` axis,
on shape-only mesh stand-ins (as ``tests/test_sharding.py`` builds them)
and on 300 (names, shape) pairs drawn from a seed, which cover the
divisibility fallback, each mesh axis used once, the ``layer`` dim and the
C1 upgrade of the moments. The reference writes a single axis as its bare
name, the port as a one-name tuple.

On a card only (marked ``cuda``): the ``dist`` phase of ``chip_smoke.py``
at a small size on a 1 x 1 NCCL mesh of one rank.
"""
import dataclasses
import itertools

import numpy as np
import pytest
import torch

from repro_torch.dist import rules as PR
from repro_torch.dist.sharding import Rules
from repro_torch.launch.mesh import production_mesh_shape

NAMES = (None, "fsdp", "heads", "kv_heads", "mlp", "vocab", "expert",
         "batch", "seq_res", "act_heads", "act_mlp", "act_expert", "kv_seq",
         "layer", "unknown")
DIMS = (1, 2, 3, 8, 16, 32, 48, 64, 100, 4096, 24576)
MESHES = {"pod": dict(zip(*production_mesh_shape(multi_pod=True)[::-1])),
          "flat": dict(zip(*production_mesh_shape()[::-1])),
          "small": {"data": 4, "model": 2}}


class FakeMesh:
    """Shape-only stand-in: ``shape`` and ``axis_names``."""

    def __init__(self, shape_map):
        self.shape = shape_map
        self.axis_names = tuple(shape_map)


def pairs(n=300, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        rank = int(rng.integers(1, 5))
        shape = tuple(int(rng.choice(DIMS)) for _ in range(rank))
        k = int(rng.integers(0, rank + 1))  # names may be shorter
        names = tuple(NAMES[int(i)] for i in rng.integers(0, len(NAMES), k))
        out.append((names, shape))
    return out


@pytest.fixture(scope="module")
def ref():
    pytest.importorskip("jax")
    from repro.dist import rules as JRules
    from repro.dist import sharding as JS

    return JRules, JS


def norm(spec):
    """A reference PartitionSpec in the port's form."""
    return tuple(None if e is None else (e,) if isinstance(e, str)
                 else tuple(e) for e in spec)


def test_production_mesh_shapes_are_the_papers():
    """16 x 16 on one pod (256 chips), 2 x 16 x 16 over two (512), as the
    reference's ``make_production_mesh`` lays them out."""
    assert MESHES["flat"] == {"data": 16, "model": 16}
    assert MESHES["pod"] == {"pod": 2, "data": 16, "model": 16}
    assert list(MESHES["pod"]) == ["pod", "data", "model"]


def test_constants_are_the_references(ref):
    JRules, _ = ref
    assert PR.MODES == JRules.MODES
    assert PR.PARAM_AXES == JRules.PARAM_AXES
    assert PR.ACTIVATION_AXES == JRules.ACTIVATION_AXES
    from repro.dist.tagging import LAYER_AXIS

    assert PR.LAYER_AXIS == LAYER_AXIS
    for mode in ("nope", "FSDP"):
        with pytest.raises(ValueError, match="unknown sharding mode"):
            PR.build_table(("data", "model"), mode, False)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("seq_parallel", [False, True])
@pytest.mark.parametrize("mode", PR.MODES)
def test_rules_match_reference(ref, mode, seq_parallel, mesh):
    JRules, JS = ref
    fake = FakeMesh(MESHES[mesh])
    axes = fake.axis_names
    assert PR.build_table(axes, mode, seq_parallel) == \
        JRules.build_table(axes, mode, seq_parallel)
    mine, theirs = (Rules(fake, mode, seq_parallel),
                    JS.Rules(fake, mode, seq_parallel))
    assert mine.table == theirs.table
    for name in NAMES:
        assert PR.lookup(mine.table, name) == JRules.lookup(theirs.table, name)
    for a in itertools.chain(axes, [(), ("pod", "data"), "nope"]):
        assert mine.axis_size(a) == theirs.axis_size(a)
    upgraded = 0
    for names, shape in pairs():
        for fn in ("spec_for", "param_spec", "opt_spec"):
            got = getattr(mine, fn)(names, shape)
            want = norm(getattr(theirs, fn)(names, shape))
            assert got == want, (fn, names, shape)
        def on_data(spec):
            return any(e is not None and "data" in e for e in spec)

        upgraded += (on_data(mine.opt_spec(names, shape))
                     and not on_data(mine.spec_for(names, shape)))
    # the C1 upgrade ran on this mesh exactly where the mode is wus
    assert (upgraded > 0) == (mode == "wus")


# --------------------------------------------------------------------------- #
# On the card (skipped without one).
# --------------------------------------------------------------------------- #
@pytest.fixture
def nccl_mesh():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (NCCL on a 1 x 1 mesh)")
    import torch.distributed as dist

    from repro_torch.launch.mesh import single_device_mesh

    mesh = single_device_mesh(device="cuda")
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield mesh
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
        dist.destroy_process_group()


@pytest.mark.cuda
def test_dist_phase_small_on_the_card(nccl_mesh):
    """The ``dist`` phase at RESNET_TINY size in fp32 (TF32 off) on one
    card: the loss and every gradient on the mesh (distributed batch norm
    over groups of 2, spatially partitioned convs) within rtol 1e-5 / 1e-4
    of ``mesh=None``'s (the one-pass variance); ``lars_sharded_update``
    bitwise the one-device LARS on the same gradients, in one norms and one
    update launch; weight-update-sharded Adam bitwise the port's Adam over
    2 steps; 2-D gradient summation bitwise its input; sequence-parallel
    attention through one flash launch within bf16 tolerance of the
    unsharded call; ``run_partitioned`` bitwise its branches."""
    from repro_torch.core import gradient_summation as GS
    from repro_torch.core import spatial_partitioning as SP
    from repro_torch.core import weight_update_sharding as WUS
    from repro_torch.core.graph_partitioning import run_partitioned
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import lars as lk
    from repro_torch.kernels import ops
    from repro_torch.models import resnet as R
    from repro_torch.optim import adam, constant, lars
    from repro_torch.utils import tree_leaves, tree_map, tree_unflatten

    mesh = nccl_mesh
    cfg = dataclasses.replace(R.RESNET_TINY, dtype="float32", stem_stride=2,
                              stem_pool=True, bn_group_size=2,
                              spatial_partition=True)
    params = R.init_resnet(cfg, seed=0, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    batch = {"images": torch.randn((8, 32, 32, 3), generator=gen,
                                   device="cuda"),
             "labels": torch.randint(0, 10, (8,), generator=gen,
                                     device="cuda")}

    def grads(m):
        leaves = tree_leaves(params)
        for w in leaves:
            w.requires_grad_(True)
        loss, _ = R.loss_fn(params, cfg, batch, mesh=m)
        g = torch.autograd.grad(loss, leaves)
        for w in leaves:
            w.requires_grad_(False)
        return loss.item(), list(g)

    (l_mesh, g_mesh), (l_one, g_one) = grads(mesh), grads(None)
    assert abs(l_mesh - l_one) <= 1e-5 * abs(l_one)
    for a, b in zip(g_mesh, g_one):
        assert (a - b).abs().max() <= 1e-4 * (b.abs().max() + 1e-12)

    g_tree = tree_unflatten(params, g_mesh)
    summed = GS.gradient_allreduce_2d(g_tree, mesh)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(summed), g_mesh))

    p_one = tree_map(torch.clone, params)
    opt = lars(constant(0.1))
    st_one = opt.init(p_one)
    opt.update(g_tree, st_one, p_one)
    init, upd = WUS.lars_sharded_update(constant(0.1), mesh)
    st = init(params)
    lk.reset_launches()
    upd(g_tree, st, params)
    torch.cuda.synchronize()
    assert (lk.lars_norms_multi_cuda.launches,
            lk.lars_apply_multi_cuda.launches) == (1, 1)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(params),
                                                 tree_leaves(p_one)))

    a_opt = adam(constant(1e-3))
    p_a = tree_map(torch.clone, params)
    st_a = a_opt.init(p_a)
    init, upd = WUS.sharded_update(a_opt, constant(1e-3), mesh)
    st_w, p_w = init(params), params
    for _ in range(2):
        _, st_a = a_opt.update(g_tree, st_a, p_a)
        p_w, st_w = upd(g_tree, st_w, p_w)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(p_w),
                                                 tree_leaves(p_a)))

    q, k, v = (torch.randn((1, 256, h, 64), generator=gen, device="cuda")
               .to(torch.bfloat16) for h in (4, 2, 2))
    fa.reset_launches()
    got = SP.seq_parallel_swa(q, k, v, window=64, mesh=mesh)
    torch.cuda.synchronize()
    assert fa.flash_attention_fwd_cuda.launches == 1
    want = ops.attention(q, k, v, causal=True, window=64)
    assert torch.allclose(got.float(), want.float(), rtol=2e-2, atol=1e-3)

    x = torch.randn((4, 8), generator=gen, device="cuda")
    branches = [lambda: x @ x.T, lambda: x.to(torch.bfloat16) * 2]
    for a, b in zip(run_partitioned(branches, mesh=mesh),
                    run_partitioned(branches)):
        assert a.dtype == b.dtype and torch.equal(a, b)
