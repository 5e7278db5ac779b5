"""The paper's distribution techniques in the port, over 8 gloo ranks on
the CPU, against the JAX package's unsharded functions on the same numpy
inputs (the cases of ``tests/dist_checks.py``, and more):

- the mesh layout (row-major ranks, as ``jax.make_mesh``) and the
  collectives' block order;
- C2: 2-D and 1-D gradient summation on a (4, 2) ``("data", "model")``
  mesh and, with the ``pod`` reduce axis, on a (2, 2, 2) ``("pod", "data",
  "model")`` one; the flat buffer against ``flatten_tree``'s;
- C1: weight-update-sharded Adam over two steps (its moment shards also
  against the reference's ``P("data")`` blocks, taken from its
  ``sharded_update`` on 8 host devices in a subprocess), SGD with
  momentum, LARS in both rules, and Adam on the (2, 2, 2) mesh with its
  axes from ``Rules``;
- C3: the spatially partitioned conv at (kh, stride) in {(3, 1), (3, 2),
  (1, 2), (7, 2), (5, 1)}, and on one shard at an odd H (SAME's rows; an
  odd H over several shards raises), and sequence-parallel sliding-window
  attention;
- C5: distributed batch norm at group sizes 4, 2 and 1;
- C10: ``run_partitioned``;
- ResNet (``RESNET_TINY``, fp32) with ``bn_group_size=2`` and
  ``spatial_partition=True`` on the mesh, against the reference's
  ``forward(mesh=None)`` over each statistics group's images, and every
  leaf's gradient against ``jax.grad`` of the same.

The spatial conv, batch norm, ``seq_parallel_swa`` and
``run_partitioned`` cases take gradients too (each rank's loss
``sum(y * ct)`` over its block), against ``jax.vjp``: a replicated input
(``P()``, or the whole tensor a rank takes its block of) gets its whole
gradient on every rank; over ``data`` a batch-norm scale's is a share,
summed over the data line.

One module fixture starts the 8 ranks (this file's ``__main__``, torch
only: one process forks them from a fork server that imports torch once;
a ``FileStore`` rendezvous) and the JAX subprocess side by side; each
rank runs every case and writes its blocks, and each test reads its
case. The tolerance is 1e-5 in fp32, as ``dist_checks.py``'s (the conv
1e-4: sums of 392 products in another order; ResNet's logits 1e-4 after
7 convs and batch norms); gradients within 1e-5 of each tensor's largest
magnitude, ResNet's 2e-5 (sound runs read at most 1.4e-6).
"""
import dataclasses
import os
import pickle
import subprocess
import sys
import tempfile
import traceback

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 8
CONVS = [(3, 1), (3, 2), (1, 2), (7, 2), (5, 1)]
CASES = (["layout", "collectives", "gradsum_2d", "gradsum_1d",
          "gradsum_2d_pod", "gradsum_2d_no_pod", "wus_adam",
          "wus_adam_rules_pod", "wus_sgdm", "wus_lars_scaled",
          "wus_lars_unscaled", "seq_parallel_swa", "bn_group4", "bn_group2",
          "bn_group1", "run_partitioned", "resnet_tiny", "resnet_tiny_grad",
          "spatial_conv_one_shard_odd_h"]
         + [f"spatial_conv_k{k}s{s}" for k, s in CONVS])
SWA = dict(B=2, S=32, H=4, D=16, W=8)
LR = 0.1
WD = 1e-2  # Adam's weight decay on the (2, 2, 2) mesh


# --------------------------------------------------------------------------- #
# Inputs (numpy, from seeds), shared by the reference and the ranks.
# --------------------------------------------------------------------------- #
def _tree(rng, scale=1.0):
    return {"w1": (rng.standard_normal((64, 32)) * scale).astype(np.float32),
            "b": np.full((32,), 0.3, np.float32)
            + (rng.standard_normal(32) * scale * 0.1).astype(np.float32),
            "w2": (rng.standard_normal((32, 16)) * scale).astype(np.float32)}


def make_inputs():
    rng = np.random.default_rng(0)
    params = _tree(rng)
    return {
        "params": params,
        "local_g": [_tree(rng, 0.1) for _ in range(WORLD)],  # one a rank
        "rep_g": _tree(rng, 0.1),  # the same on every rank
        "x_conv": rng.standard_normal((2, 16, 16, 8)).astype(np.float32),
        "w_conv": {k: (rng.standard_normal((k, k, 8, 4)) * 0.1
                       ).astype(np.float32) for k in (1, 3, 5, 7)},
        "qkv": [rng.standard_normal((SWA["B"], SWA["S"], SWA["H"], SWA["D"])
                                    ).astype(np.float32) for _ in range(3)],
        "x_bn": rng.standard_normal((8, 4, 4, 8)).astype(np.float32) * 2 + 1,
        "bn_scale": (1 + 0.1 * rng.standard_normal(8)).astype(np.float32),
        "bn_bias": (0.1 * rng.standard_normal(8)).astype(np.float32),
        "gp": [rng.standard_normal(s).astype(np.float32)
               for s in ((4, 8), (8, 6), (8, 3))],
        "images": rng.standard_normal((8, 16, 16, 3)).astype(np.float32),
        # cotangents of the outputs (the per-rank losses sum(y * ct)), and
        # ResNet's labels
        "ct_conv": {s: rng.standard_normal((2, 16 // s, 16 // s, 4)
                                           ).astype(np.float32)
                    for s in (1, 2)},
        "ct_bn": rng.standard_normal((8, 4, 4, 8)).astype(np.float32),
        "ct_swa": rng.standard_normal((SWA["B"], SWA["S"], SWA["H"],
                                       SWA["D"])).astype(np.float32),
        "ct_gp": [rng.standard_normal(s).astype(np.float32)
                  for s in ((4, 6), (4, 3), (4, 8), (4,))],
        "labels": rng.integers(0, 10, (8,)),
    }


# --------------------------------------------------------------------------- #
# The ranks (``python tests/test_torch_dist.py ranks STORE INPUTS OUTDIR``).
# --------------------------------------------------------------------------- #
def rank_main(rank, store, inputs_path, out_path):
    import warnings

    import torch
    from torch._subclasses.fake_tensor import FakeTensor

    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.core import distributed_norm as DN
    from repro_torch.core import gradient_summation as GS
    from repro_torch.core import spatial_partitioning as SP
    from repro_torch.core import weight_update_sharding as WUS
    from repro_torch.core.graph_partitioning import run_partitioned
    from repro_torch.dist import compat
    from repro_torch.dist.sharding import Rules
    from repro_torch.launch.mesh import (
        init_process_group,
        make_mesh,
        make_test_mesh,
    )
    from repro_torch.models import resnet as R
    from repro_torch.optim import adam, constant, sgd_momentum
    from repro_torch.utils import tree_leaves, tree_map, tree_unflatten

    warnings.filterwarnings("ignore", category=FutureWarning)
    torch.manual_seed(0)
    with open(inputs_path, "rb") as f:
        inp = pickle.load(f)
    init_process_group(device="cpu", rank=rank, world_size=WORLD,
                       store_path=store)
    mesh = make_test_mesh(4, 2, device="cpu")
    mesh3 = make_test_mesh(2, 2, pod=2, device="cpu")
    mesh81 = make_mesh((8, 1), ("data", "model"), device="cpu")

    def t(tree):
        return tree_map(lambda a: torch.from_numpy(np.array(a)), tree)

    def np_(tree):
        return tree_map(lambda x: x.detach().numpy().copy(), tree)

    def grad_of(a):
        """a (numpy) as a replicated leaf that takes a gradient."""
        return torch.from_numpy(np.array(a)).requires_grad_()

    def backward(y, ct, dim=1):
        """The rank's loss sum(y * ct) over its block of ct, backward."""
        (y.float() * compat.shard(torch.from_numpy(ct), mesh, "data",
                                  dim=dim)).sum().backward()

    params, local_g, rep_g = (t(inp["params"]), t(inp["local_g"][rank]),
                              t(inp["rep_g"]))

    def layout():
        return np.array([mesh.axis_index("data"), mesh.axis_index("model"),
                         mesh3.axis_index("pod"), mesh3.axis_index("data"),
                         mesh3.axis_index("model")])

    def collectives():
        x = torch.arange(8, dtype=torch.float32) + 100 * rank
        return {"psum": compat.psum(x, mesh, "data").numpy(),
                "scatter": compat.psum_scatter(x, mesh, "data").numpy(),
                "gather": compat.all_gather(x.reshape(2, 4), mesh, "data",
                                            dim=1).numpy(),
                "ring": compat.ppermute(x, mesh, "data", [
                    (i, (i + 1) % 4) for i in range(4)]).numpy(),
                "halo": SP.halo_exchange(x.reshape(1, 8), mesh, "data", lo=2,
                                         hi=3, dim=1).numpy()}

    def wus_adam():
        init, upd = WUS.sharded_update(adam(constant(LR)), constant(LR), mesh)
        st = init(params)
        p1, st = upd(rep_g, st, params)
        p2, st = upd(rep_g, st, p1)
        return {"p1": np_(p1), "p2": np_(p2), "m": st["m"].numpy(),
                "v": st["v"].numpy(), "step": int(st["step"])}

    def wus_adam_rules_pod():
        init, upd = WUS.sharded_update_from_rules(
            adam(constant(LR), weight_decay=WD), constant(LR),
            Rules(mesh3, "wus"))
        st = init(params)
        p1, st = upd(local_g, st, params)
        p2, _ = upd(local_g, st, p1)
        return np_(p2)

    def wus_sgdm():
        opt = sgd_momentum(constant(0.05), weight_decay=1e-4)
        init, upd = WUS.sharded_update(opt, constant(0.05), mesh)
        st = init(params)
        p1, st = upd(local_g, st, params)
        return np_(upd(local_g, st, p1)[0])

    def wus_lars(scaled):
        init, upd = WUS.lars_sharded_update(constant(LR), mesh,
                                            scaled_momentum=scaled)
        p = tree_map(torch.clone, params)
        st = init(p)
        real, owned = WUS.ops.lars_update_leaves, []

        def spy(ws, *a, **kw):  # the leaves this rank updates by LARS
            owned.append([tuple(w.shape) for w in ws])
            return real(ws, *a, **kw)

        WUS.ops.lars_update_leaves = spy
        try:
            for _ in range(2):
                _, st = upd(local_g, st, p)
        finally:
            WUS.ops.lars_update_leaves = real
        return {"p": np_(p), "m": np_(st["m"]), "owned": owned}

    def spatial_conv(k, s):
        x = grad_of(inp["x_conv"])
        w = grad_of(inp["w_conv"][k].transpose(3, 2, 0, 1))
        y = SP.spatial_conv2d(compat.shard(x, mesh, "data", dim=1), w,
                              stride=s, mesh=mesh, axis_name="data")
        backward(y, inp["ct_conv"][s])
        return {"y": y.detach().numpy(), "dx": x.grad.numpy(),
                "dw": w.grad.numpy().transpose(2, 3, 1, 0)}

    def one_shard_odd_h():
        """H 15 at stride 2: SAME's 8 rows on one model shard; over the 4
        data shards no equal blocks exist, which raises."""
        x = torch.from_numpy(inp["x_conv"][:, :15, :15])
        w = torch.from_numpy(inp["w_conv"][3].transpose(3, 2, 0, 1).copy())
        out = SP.spatial_conv2d(x, w, stride=2, mesh=mesh81).numpy()
        try:
            SP.spatial_conv2d(x[:, :3], w, stride=2, mesh=mesh,
                              axis_name="data")
            refused = ""
        except ValueError as e:
            refused = str(e)
        return {"out": out, "refused": refused}

    def swa():
        full = [grad_of(a) for a in inp["qkv"]]
        q, k, v = (compat.shard(a, mesh, "data", dim=1) for a in full)
        o = SP.seq_parallel_swa(q, k, v, window=SWA["W"], mesh=mesh,
                                axis_name="data")
        backward(o, inp["ct_swa"])
        return {"o": o.detach().numpy(),
                "grads": [a.grad.numpy() for a in full]}

    def bn(group):
        x, sc, bi = (grad_of(inp[k]) for k in ("x_bn", "bn_scale",
                                              "bn_bias"))
        y = DN.distributed_batch_norm(compat.shard(x, mesh, "data"),
                                      sc, bi, mesh=mesh, group_size=group)
        backward(y, inp["ct_bn"], dim=0)
        return {"y": y.detach().numpy(), "dx": x.grad.numpy(),
                "dscale": sc.grad.numpy(), "dbias": bi.grad.numpy()}

    def partitioned():
        x, w1, w2 = (grad_of(a) for a in inp["gp"])
        calls = []

        def branch(i, fn):
            def run(*args):  # the runs that compute (not the shape-only)
                y = fn(*args)
                if not isinstance(y, FakeTensor):
                    calls.append(i)
                return y
            return run

        outs = run_partitioned(
            [branch(0, lambda x, w1, w2: x @ w1),
             branch(1, lambda x, w1, w2: x @ w2),
             branch(2, lambda x, *_: torch.tanh(x).to(torch.bfloat16)),
             branch(3, lambda x, *_: x.sum(1))], mesh=mesh,
            inputs=(x, w1, w2))
        sum((o.float() * torch.from_numpy(c)).sum()
            for o, c in zip(outs, inp["ct_gp"])).backward()
        try:  # branches that close over tensors needing gradients
            run_partitioned([lambda: x @ w1, lambda: x @ w2], mesh=mesh)
            refused = ""
        except ValueError as e:
            refused = str(e)
        return {"outs": [o.detach().float().numpy() for o in outs],
                "dtypes": [str(o.dtype) for o in outs], "calls": calls,
                "grads": [a.grad.numpy() for a in (x, w1, w2)],
                "refused": refused}

    cfg_tiny = dataclasses.replace(R.RESNET_TINY, dtype="float32",
                                   bn_group_size=2, spatial_partition=True)

    def resnet_tiny():
        rp = R.params_from_numpy(inp["resnet"], device="cpu")
        imgs = compat.shard(torch.from_numpy(inp["images"]), mesh, "data")
        with torch.no_grad():
            return R.forward(rp, cfg_tiny, imgs, mesh=mesh).numpy()

    def resnet_tiny_grad():
        """This rank's loss (the mean over its 2 images) and its gradient
        of every leaf, in the reference's layout."""
        rp = R.params_from_numpy(inp["resnet"], device="cpu")
        leaves = tree_leaves(rp)
        for w in leaves:
            w.requires_grad_(True)
        batch = {k: compat.shard(torch.from_numpy(inp[k]), mesh, "data")
                 for k in ("images", "labels")}
        loss, _ = R.loss_fn(rp, cfg_tiny, batch, mesh=mesh)
        grads = torch.autograd.grad(loss, leaves)
        return {"loss": loss.item(),
                "grads": R.params_to_numpy(tree_unflatten(rp, grads))}

    fns = {
        "layout": layout, "collectives": collectives,
        "gradsum_2d": lambda: np_(GS.gradient_allreduce_2d(local_g, mesh)),
        "gradsum_1d": lambda: np_(GS.gradient_allreduce_1d(local_g, mesh)),
        "gradsum_2d_pod": lambda: np_(GS.gradient_allreduce_2d(
            local_g, mesh3, reduce_axis="pod")),
        "gradsum_2d_no_pod": lambda: np_(GS.gradient_allreduce_2d(
            local_g, mesh, reduce_axis="pod")),
        "wus_adam": wus_adam, "wus_adam_rules_pod": wus_adam_rules_pod,
        "wus_sgdm": wus_sgdm,
        "wus_lars_scaled": lambda: wus_lars(True),
        "wus_lars_unscaled": lambda: wus_lars(False),
        "seq_parallel_swa": swa,
        "bn_group4": lambda: bn(4), "bn_group2": lambda: bn(2),
        "bn_group1": lambda: bn(1),
        "run_partitioned": partitioned, "resnet_tiny": resnet_tiny,
        "resnet_tiny_grad": resnet_tiny_grad,
        "spatial_conv_one_shard_odd_h": one_shard_odd_h,
    }
    for k, s in CONVS:
        fns[f"spatial_conv_k{k}s{s}"] = (lambda k=k, s=s: spatial_conv(k, s))
    out = {}
    for name in CASES:  # every rank in one order: the collectives match
        try:
            out[name] = fns[name]()
        except Exception:  # recorded; the case's test fails with it
            out[name] = {"error": traceback.format_exc()}
    with open(out_path, "wb") as f:
        pickle.dump(out, f)
    import torch.distributed as dist

    dist.destroy_process_group()


def jax_blocks_main(inputs_path, out_path):
    """The reference's weight-update-sharded Adam on a (4, 2) mesh of 8
    host devices: its moments after two steps, the global arrays of the
    ``P("data")`` blocks."""
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    os.environ["JAX_PLATFORMS"] = "cpu"
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import jax

    from repro.core import weight_update_sharding as WUS
    from repro.dist.compat import AxisType, make_mesh
    from repro.optim import adam, constant

    with open(inputs_path, "rb") as f:
        inp = pickle.load(f)
    mesh = make_mesh((4, 2), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
    init, upd = WUS.sharded_update(adam(constant(LR)), constant(LR), mesh)
    st = init(inp["params"])
    p1, st = jax.jit(upd)(inp["rep_g"], st, inp["params"])
    _, st = jax.jit(upd)(inp["rep_g"], st, p1)
    with open(out_path, "wb") as f:
        pickle.dump({"m": np.asarray(st["m"]), "v": np.asarray(st["v"])}, f)


def launch_ranks(store, inputs_path, out_dir):
    """The 8 ranks, forked from one fork server that imports torch and the
    port once (8 fresh interpreters would import them 8 times over, on
    cores the suite's other workers share). Returns the worst exit code."""
    import multiprocessing

    sys.path.insert(0, os.path.join(ROOT, "src"))
    ctx = multiprocessing.get_context("forkserver")
    ctx.set_forkserver_preload(["__main__", "torch", "torch.distributed",
                                "repro_torch.core.weight_update_sharding",
                                "repro_torch.models.resnet"])
    procs = [ctx.Process(target=rank_main, args=(
        r, store, inputs_path, os.path.join(out_dir, f"rank{r}.pkl")))
        for r in range(WORLD)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=150)
    for p in procs:
        if p.is_alive():
            p.kill()
    return max(abs(p.exitcode if p.exitcode is not None else 1)
               for p in procs)


if __name__ == "__main__":
    if sys.argv[1] == "jax":
        jax_blocks_main(sys.argv[2], sys.argv[3])
        sys.exit(0)
    sys.exit(launch_ranks(*sys.argv[2:5]))


# --------------------------------------------------------------------------- #
# The tests (JAX on this process's one CPU device).
# --------------------------------------------------------------------------- #
if __name__ != "__mp_main__":  # not in the ranks, which import torch only
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.core import distributed_norm as JDN
    from repro.core import gradient_summation as JGS
    from repro.dist import split_tree
    from repro.kernels import ref as kref
    from repro.models import resnet as JR
    from repro.optim import adam, constant, lars, sgd_momentum
    from repro_torch.core import gradient_summation as GS
    from repro_torch.utils import tree_map

TOL = 1e-5
GRAD_TOL = 1e-5  # of the largest magnitude: sums in another order
RESNET_GRAD_TOL = 2e-5  # the same, after 7 convs and batch norms


def resnet_tree(seed=1):
    """RESNET_TINY weights in the reference's tree (names and HWIO shapes
    from ``jax.eval_shape``), drawn with numpy: He-normal convs, the head
    N(0, 1/cin), batch-norm scales 1 + N(0, 0.01) and biases N(0, 0.01)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda k: split_tree(
        JR.init_resnet(JR.RESNET_TINY, k))[0], jax.random.PRNGKey(0))

    def draw(path, leaf):
        shape = leaf.shape
        a = rng.standard_normal(shape).astype(np.float32)
        if len(shape) == 4:
            return a * np.float32((2.0 / np.prod(shape[:3])) ** 0.5)
        if len(shape) == 2:
            return a * np.float32(shape[0] ** -0.5)
        one = getattr(path[-1], "key", None) == "scale"
        return a * np.float32(0.1) + np.float32(one)

    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.fixture(scope="module")
def ranks():
    """Every rank's results by case, and the reference's Adam moments."""
    inp = make_inputs()
    inp["resnet"] = resnet_tree()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "inputs.pkl")
        with open(path, "wb") as f:
            pickle.dump(inp, f)
        env = {**os.environ, "GLOO_SOCKET_IFNAME": "lo",
               "OMP_NUM_THREADS": "1", "CUDA_VISIBLE_DEVICES": ""}
        me = os.path.abspath(__file__)
        procs = [subprocess.Popen(
            [sys.executable, me, *args], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT) for args in (
                ("ranks", os.path.join(tmp, "store"), path, tmp),
                ("jax", path, os.path.join(tmp, "jax.pkl")))]
        logs = []
        try:
            refs = references(inp)  # while the ranks run
            for p in procs:
                logs.append(p.communicate(timeout=180)[0].decode()[-3000:])
        finally:
            for p in procs:
                p.kill()
        bad = [(i, log) for i, (p, log) in enumerate(zip(procs, logs))
               if p.returncode != 0]
        assert not bad, f"ranks failed: {bad}"
        out = []
        for r in range(WORLD):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        with open(os.path.join(tmp, "jax.pkl"), "rb") as f:
            blocks = pickle.load(f)
    return inp, out, dict(blocks, **refs)


def references(inp):
    """The slower reference results: the two Adam steps, the unsharded
    attention and its gradients, and ResNet's forward and gradient over
    each statistics group's images (distributed batch norm over groups of
    2 data ranks, 4 images)."""
    summed = jax.tree_util.tree_map(lambda g: 4 * g, inp["rep_g"])
    (p1, p2), st = _jax_steps(adam(constant(LR)), summed, inp["params"], 2)
    qkv = [jnp.asarray(a) for a in inp["qkv"]]
    swa, swa_vjp = jax.vjp(lambda q, k, v: kref.attention(
        q, k, v, causal=True, window=SWA["W"]), *qkv)
    cfg = dataclasses.replace(JR.RESNET_TINY, dtype="float32")
    fwd = jax.jit(lambda p, x: JR.forward(p, cfg, x))
    params = jtree(inp["resnet"])

    def ranks_loss(p):
        """The sum of the 4 data ranks' losses (each the mean over its 2
        images): twice the sum of the 2 groups' mean losses."""
        return 2 * sum(JR.loss_fn(p, cfg, {
            "images": jnp.asarray(inp["images"][4 * g:4 * g + 4]),
            "labels": jnp.asarray(inp["labels"][4 * g:4 * g + 4])})[0]
            for g in range(2))

    loss, grads = jax.jit(jax.value_and_grad(ranks_loss))(params)
    return {
        "adam": (p1, p2, st),
        "swa": np.asarray(swa),
        "swa_grads": [np.asarray(g) for g in swa_vjp(jnp.asarray(
            inp["ct_swa"]))],
        "resnet": np.concatenate([np.asarray(fwd(params, jnp.asarray(
            inp["images"][4 * g:4 * g + 4]))) for g in range(2)]),
        "resnet_loss": float(loss),
        "resnet_grads": jax.tree_util.tree_map(np.asarray, grads),
    }


def results(ranks, case):
    inp, out, refs = ranks
    got = [o[case] for o in out]
    for r, g in enumerate(got):
        if isinstance(g, dict) and "error" in g:
            pytest.fail(f"rank {r}, case {case}:\n{g['error']}")
    return inp, got, refs


def coords(r):
    """(data, model) of rank r on the (4, 2) mesh; (pod, data, model) on
    the (2, 2, 2) one."""
    return (r // 2, r % 2), (r // 4, (r // 2) % 2, r % 2)


def close(got, want, tol=TOL):
    gl = jax.tree_util.tree_leaves(got)
    wl = jax.tree_util.tree_leaves(want)
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=tol,
                                   atol=tol)


def tsum(trees):
    return jax.tree_util.tree_map(lambda *xs: np.sum(xs, 0), *trees)


def jtree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def test_flatten_tree_buffer_is_the_references():
    """Leaf order (sorted keys), padding and the round trip."""
    import torch

    inp = make_inputs()
    for pad in (1, 4, 7):
        want, _ = JGS.flatten_tree(jtree(inp["params"]), pad_multiple=pad)
        got, meta = GS.flatten_tree(
            tree_map(torch.from_numpy, inp["params"]), pad_multiple=pad)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        back = GS.unflatten_tree(got, meta)
        assert sorted(back) == ["b", "w1", "w2"]
        for k in back:
            assert np.array_equal(back[k].numpy(), inp["params"][k])


def test_distributed_batch_norm_is_one_pass():
    """The reference's one-pass variance ``s2 / (cnt * g) - mu**2``
    (``distributed_norm.py:62-64``), not ``batch_norm``'s two passes: on
    values of 100 + k / 2 every sum is exact in fp32 in any order, so the
    port equals the reference's ``distributed_batch_norm`` (a 1 x 1 mesh
    of this process's device) to an ulp of rsqrt, while the two-pass form
    is ~1e-4 away. A stand-in mesh with groups of 1 needs no process
    group."""
    import torch

    from repro.core.distributed_norm import distributed_batch_norm as jdbn
    from repro.launch.mesh import single_device_mesh
    from repro_torch.core import distributed_norm as DN

    class StandIn:
        shape = {"data": 4, "model": 1}
        axis_names = ("data", "model")

    rng = np.random.default_rng(3)
    x = (100 + rng.integers(-8, 9, (2, 4, 4, 8)) / 2).astype(np.float32)
    sc = (1 + 0.1 * rng.standard_normal(8)).astype(np.float32)
    bi = (0.1 * rng.standard_normal(8)).astype(np.float32)
    want = np.asarray(jdbn(jnp.asarray(x), jnp.asarray(sc), jnp.asarray(bi),
                           mesh=single_device_mesh(), group_size=1))
    got = DN.distributed_batch_norm(
        *(torch.from_numpy(a) for a in (x, sc, bi)), mesh=StandIn(),
        group_size=1).numpy()
    two_pass = JDN.batch_norm(jnp.asarray(x), jnp.asarray(sc),
                              jnp.asarray(bi))[0]
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)
    assert np.abs(np.asarray(two_pass) - want).max() > 2e-5


@pytest.mark.parametrize("case", CASES)
def test_case(ranks, case):
    inp, got, refs = results(ranks, case)
    CHECKS[case.split("_k")[0] if case.startswith("spatial_conv_k")
           else case](inp, got, case, refs)


def check_layout(inp, got, case, refs):
    for r, g in enumerate(got):
        assert tuple(g) == (*coords(r)[0], *coords(r)[1]), (r, g)


def check_collectives(inp, got, case, refs):
    x = [np.arange(8, dtype=np.float32) + 100 * r for r in range(WORLD)]
    for r, g in enumerate(got):
        d, m = coords(r)[0]
        col = [x[dd * 2 + m] for dd in range(4)]
        np.testing.assert_array_equal(g["psum"], np.sum(col, 0))
        np.testing.assert_array_equal(g["scatter"],
                                      np.sum(col, 0)[2 * d:2 * d + 2])
        np.testing.assert_array_equal(
            g["gather"], np.concatenate([c.reshape(2, 4) for c in col], 1))
        np.testing.assert_array_equal(g["ring"], col[(d - 1) % 4])
        left = col[d - 1][-2:] if d > 0 else np.zeros(2, np.float32)
        right = col[d + 1][:3] if d < 3 else np.zeros(3, np.float32)
        np.testing.assert_array_equal(
            g["halo"][0], np.concatenate([left, x[r], right]))


def _column_sums(inp, axes):
    """The summed local gradients each rank should get: over data (and
    pod) for its model index."""
    out = []
    for r in range(WORLD):
        m = r % 2
        if axes == "data":
            members = [d * 2 + m for d in range(4)]
        else:  # pod and data of the (2, 2, 2) mesh: the same 4 ranks
            members = [p * 4 + d * 2 + m for p in range(2) for d in range(2)]
        out.append(tsum([inp["local_g"][i] for i in members]))
    return out


def check_gradsum(inp, got, case, refs):
    axes = "pod" if case == "gradsum_2d_pod" else "data"
    for g, want in zip(got, _column_sums(inp, axes)):
        close(g, want)


def _jax_steps(opt, grads, params, steps):
    st = opt.init(jtree(params))
    p = jtree(params)
    out = []
    for _ in range(steps):
        p, st = opt.update(jtree(grads), st, p, st["step"])
        out.append(p)
    return out, st


def check_wus_adam(inp, got, case, refs):
    """Two steps against the reference's Adam on the summed gradients
    (4 x the replicated local ones); each rank's moment shards against
    the reference's P("data") blocks and the unsharded moments."""
    p1, p2, st = refs["adam"]
    for r, g in enumerate(got):
        close(g["p1"], p1)
        close(g["p2"], p2)
        assert g["step"] == 2
        d = coords(r)[0][0]
        sz = g["m"].size
        for k in ("m", "v"):
            flat, _ = JGS.flatten_tree(st[k], pad_multiple=4)
            np.testing.assert_allclose(
                g[k], np.asarray(flat)[d * sz:(d + 1) * sz], rtol=TOL,
                atol=1e-9)
    for r, g in enumerate(got):
        d = coords(r)[0][0]
        sz = g["m"].size
        for k in ("m", "v"):
            np.testing.assert_allclose(
                g[k], refs[k][d * sz:(d + 1) * sz], rtol=TOL, atol=1e-9)


def check_wus_adam_rules_pod(inp, got, case, refs):
    """Weight decay added after the bias-corrected step, as the
    reference's Adam adds it."""
    for g, summed in zip(got, _column_sums(inp, "pod")):
        (_, p2), _ = _jax_steps(adam(constant(LR), weight_decay=WD), summed,
                                inp["params"], 2)
        close(g, p2)


def check_wus_sgdm(inp, got, case, refs):
    for g, summed in zip(got, _column_sums(inp, "data")):
        (_, p2), _ = _jax_steps(sgd_momentum(constant(0.05),
                                             weight_decay=1e-4),
                                summed, inp["params"], 2)
        close(g, p2)


def check_wus_lars(inp, got, case, refs):
    """Both steps against the reference's LARS on the summed gradients;
    leaf i (sorted keys: b, w1, w2) owned by data index i % 4, so ranks
    at index 1 and 2 run the 2-D leaves w1 and w2, one call a step."""
    scaled = case == "wus_lars_scaled"
    kernel = {1: [[(64, 32)]] * 2, 2: [[(32, 16)]] * 2}
    for r, g in enumerate(got):
        assert g["owned"] == kernel.get(coords(r)[0][0], []), (r, g["owned"])
    for g, summed in zip(got, _column_sums(inp, "data")):
        (_, p2), st = _jax_steps(lars(constant(LR), scaled_momentum=scaled),
                                 summed, inp["params"], 2)
        close(g["p"], p2)
        close(g["m"], st["m"])


def _block(a, r, n=4, dim=1):
    d = coords(r)[0][0]
    h = a.shape[dim] // n
    return np.take(a, range(d * h, (d + 1) * h), axis=dim)


def close_grad(got, want, tol=GRAD_TOL):
    """Within tol of want's largest magnitude, elementwise."""
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * np.abs(want).max())


def check_spatial_conv(inp, got, case, refs):
    """The output block, and the gradients of the sum of the ranks'
    losses: x's whole on every rank (``compat.shard``'s backward gathers
    the blocks), w's whole on every rank (``pvary``)."""
    k, s = (int(c) for c in case[len("spatial_conv_k"):].split("s"))
    want, vjp = jax.vjp(lambda x, w: jax.lax.conv_general_dilated(
        x, w, (s, s), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC")),
        jnp.asarray(inp["x_conv"]), jnp.asarray(inp["w_conv"][k]))
    dx, dw = vjp(jnp.asarray(inp["ct_conv"][s]))
    for r, g in enumerate(got):
        np.testing.assert_allclose(g["y"], _block(np.asarray(want), r),
                                   rtol=1e-4, atol=1e-4)
        close_grad(g["dx"], dx)
        close_grad(g["dw"], dw)


def check_spatial_conv_one_shard_odd_h(inp, got, case, refs):
    x = jnp.asarray(inp["x_conv"][:, :15, :15])
    want = np.asarray(jax.lax.conv_general_dilated(
        x, jnp.asarray(inp["w_conv"][3]), (2, 2), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC")))
    assert want.shape[1] == 8
    for g in got:
        np.testing.assert_allclose(g["out"], want, rtol=1e-4, atol=1e-4)
        assert "not divisible by 4 shards x stride 2" in g["refused"]


def check_seq_parallel_swa(inp, got, case, refs):
    """The output block, and q's, k's and v's whole gradients (the halo's
    backward sends k's and v's cotangents back to their owners)."""
    want = refs["swa"]
    for r, g in enumerate(got):
        np.testing.assert_allclose(g["o"], _block(want, r), rtol=TOL,
                                   atol=TOL)
        for a, b in zip(g["grads"], refs["swa_grads"]):
            close_grad(a, b)


def check_bn(inp, got, case, refs):
    """Each rank's rows against the plain batch norm over its group's
    rows; x's gradient whole on every rank; scale's and bias's are each
    data rank's share, whose sum over the data line (either model index)
    is the whole."""
    group = int(case[len("bn_group"):])
    rows = 2 * group  # each data rank holds 2 rows

    def total(x, sc, bi):
        ys = [JDN.batch_norm(x[lo:lo + rows], sc, bi)[0]
              for lo in range(0, 8, rows)]
        return jnp.concatenate(ys)

    want, vjp = jax.vjp(total, *(jnp.asarray(inp[k]) for k in (
        "x_bn", "bn_scale", "bn_bias")))
    dx, dsc, dbi = vjp(jnp.asarray(inp["ct_bn"]))
    for r, g in enumerate(got):
        d = coords(r)[0][0]
        np.testing.assert_allclose(g["y"], np.asarray(want)[2 * d:2 * d + 2],
                                   rtol=1e-4, atol=1e-5)
        close_grad(g["dx"], dx)
    for m in range(2):
        line = [got[2 * d + m] for d in range(4)]
        close_grad(np.sum([g["dscale"] for g in line], 0), dsc)
        close_grad(np.sum([g["dbias"] for g in line], 0), dbi)


def check_run_partitioned(inp, got, case, refs):
    """The outputs, each branch run by its owner only, and the inputs'
    whole gradients on every rank (owner or not) against the branches in
    order; branches that close over tensors needing gradients raise."""
    def branches(x, w1, w2):
        return [x @ w1, x @ w2, jnp.tanh(x).astype(jnp.bfloat16)
                .astype(jnp.float32), x.sum(axis=1)]

    want, vjp = jax.vjp(branches, *(jnp.asarray(a) for a in inp["gp"]))
    grads = vjp([jnp.asarray(c) for c in inp["ct_gp"]])
    for r, g in enumerate(got):
        for a, b in zip(g["outs"], want):
            np.testing.assert_allclose(a, np.asarray(b), rtol=TOL, atol=TOL)
        assert g["dtypes"] == ["torch.float32", "torch.float32",
                               "torch.bfloat16", "torch.float32"]
        m = coords(r)[0][1]
        assert g["calls"] == [i for i in range(4) if i % 2 == m]
        for a, b in zip(g["grads"], grads):
            close_grad(a, b, TOL)
        assert "other than through inputs" in g["refused"]


def check_resnet_tiny(inp, got, case, refs):
    """Distributed batch norm over groups of 2 data ranks (4 images):
    the reference's plain forward over each group's images."""
    want = refs["resnet"]
    for r, g in enumerate(got):
        d = coords(r)[0][0]
        np.testing.assert_allclose(g, want[2 * d:2 * d + 2], rtol=1e-4,
                                   atol=1e-4)


def check_resnet_tiny_grad(inp, got, case, refs):
    """Every leaf's gradient: the sum over the data line of the ranks'
    (their shares) against the reference's gradient of the sum of the
    ranks' losses (each group's plain forward), on both model indices;
    the two model ranks of a data index hold the same gradient, bit for
    bit, so the replicas do not drift."""
    want = jax.tree_util.tree_leaves(refs["resnet_grads"])
    names = [jax.tree_util.keystr(k) for k, _ in
             jax.tree_util.tree_leaves_with_path(refs["resnet_grads"])]
    np.testing.assert_allclose(sum(got[2 * d]["loss"] for d in range(4)),
                               refs["resnet_loss"], rtol=1e-5)
    for d in range(4):
        for a, b in zip(*(jax.tree_util.tree_leaves(got[2 * d + m]["grads"])
                          for m in range(2))):
            np.testing.assert_array_equal(a, b)
    for m in range(2):
        leaves = [jax.tree_util.tree_leaves(got[2 * d + m]["grads"])
                  for d in range(4)]
        assert len(leaves[0]) == len(want)
        for i, (name, b) in enumerate(zip(names, want)):
            a = np.sum([lv[i] for lv in leaves], 0)
            assert a.shape == b.shape, name
            err = np.abs(a - b).max() / np.abs(b).max()
            assert err <= RESNET_GRAD_TOL, (name, m, err)


CHECKS = {
    "layout": check_layout, "collectives": check_collectives,
    "gradsum_2d": check_gradsum, "gradsum_1d": check_gradsum,
    "gradsum_2d_pod": check_gradsum, "gradsum_2d_no_pod": check_gradsum,
    "wus_adam": check_wus_adam,
    "wus_adam_rules_pod": check_wus_adam_rules_pod,
    "wus_sgdm": check_wus_sgdm, "wus_lars_scaled": check_wus_lars,
    "wus_lars_unscaled": check_wus_lars,
    "spatial_conv": check_spatial_conv,
    "spatial_conv_one_shard_odd_h": check_spatial_conv_one_shard_odd_h,
    "seq_parallel_swa": check_seq_parallel_swa,
    "bn_group4": check_bn, "bn_group2": check_bn, "bn_group1": check_bn,
    "run_partitioned": check_run_partitioned,
    "resnet_tiny": check_resnet_tiny,
    "resnet_tiny_grad": check_resnet_tiny_grad,
}
