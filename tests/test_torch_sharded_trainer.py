"""The sharded trainer (``Trainer(cfg, tcfg, mesh=)``, ``dist/spmd.py``)
over 8 gloo ranks on the CPU, against the port's one-device ``Trainer``
and the reference's own mesh ``Trainer``, from one numpy parameter tree.

The model is reduced yi-9b in fp32 (``dtype`` overridden on both sides):
one layer, 4/4 heads of 64, d_ff 512, vocab 1024; batch 8 x 32, 3 steps,
Adam at a constant rate unless a case says otherwise. The cases:

- on a (4, 2) ``("data", "model")`` mesh, each mode (``replicated``,
  ``fsdp``, ``wus``) with ``seq_parallel`` on and off: 2/2 heads and 256
  of the 512 FFN units a rank, the sequence of 32 in blocks of 16 under
  ``seq_parallel``;
- on a (2, 2, 2) ``("pod", "data", "model")`` mesh in ``wus``: the batch
  over ``pod`` x ``data``, the 2-D gradient sum;
- SGD without momentum in ``fsdp`` (its update is linear in the gradient,
  so a gradient off by a factor shows in the weights, where Adam's
  normalised update hides it); ``microbatches=2`` in ``wus``;
- 4/1 heads in ``fsdp`` without ``seq_parallel``: the one KV head is
  replicated over ``model`` and each rank reads it for its 2 queries;
- reduced qwen2-vl-7b in ``wus`` with ``seq_parallel``: 16 media
  embeddings prepended to the 32 tokens, M-RoPE, the stream of 48 in
  blocks of 24, so rank 0's block holds the media and 8 text positions;
- reduced jamba-1.5-large (a Mamba + dense, a Mamba + MoE and an
  attention + dense layer) in ``fsdp`` on an (8, 1) mesh, SGD: the batch
  axes alone, the MoE load-balance loss from the global batch's means
  (under Adam a weight moved by rounding flips an MoE route at step 2).

Each case holds the loss, nll and ``grad_norm`` of every step and the
masked eval nll after them (``Trainer.evaluate`` over a batch whose last
two rows are padding) to ``LOSS_TOL`` relative, and every leaf after 3
steps to ``LEAF_TOL`` of the
leaf's largest magnitude, against the one-device trainer on the same
global batches (sound runs read at most 1.7e-6, the worst printed by
the ``-s`` run); the blocks that several ranks hold must agree to the
last bit. The (4, 2) ``wus`` run with
``seq_parallel`` is also held against the reference's ``Trainer`` on
``make_test_mesh(4, 2)`` over 8 host devices, in the JAX subprocess that
runs beside the ranks. The ``NotImplementedError`` s are pinned: MoE,
Mamba, RWKV-6 and enc-dec configs with ``model`` > 1, and a checkpoint or
a resume on more than one rank.

One module fixture starts the ranks (``python tests/test_torch_sharded_
trainer.py ranks STORE INPUTS OUTDIR``: one process forks them from a
fork server that imports torch once; a ``FileStore`` rendezvous; each
rank on one thread) and the JAX subprocess; each rank runs every case
and pickles its blocks, and each test reads its case. A rank's
traceback fails only its case.

The card's counterpart is ``tests/test_torch_sharded_cuda.py``.
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
B, S, STEPS, LR = 8, 32, 3, 1e-2
# Adam's eps: at 1e-8 its normalised update turns the ~1e-7 relative
# rounding of a near-zero gradient element (summed over ranks in another
# order) into a weight move of up to 3.8e-2 of the embedding's largest
# magnitude in sound runs whose losses agree to 1e-7; at 1e-3 the update
# is a smooth function of the gradient, and the leaves hold to 1e-5.
EPS = 1e-3
LOSS_TOL = 1e-5   # relative: loss, nll and grad_norm
LEAF_TOL = 1e-5   # of each leaf's largest magnitude
MESHES = {"4x2": ((4, 2), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model")),
          "8x1": ((8, 1), ("data", "model"))}


def case(mesh, mode, sp=True, *, model="yi", opt="adam", micro=1):
    return dict(mesh=mesh, mode=mode, sp=sp, model=model, opt=opt,
                micro=micro)


CASES = {
    **{f"{mode}_sp{int(sp)}": case("4x2", mode, sp)
       for mode in ("replicated", "fsdp", "wus") for sp in (True, False)},
    "wus_pod": case("2x2x2", "wus"),
    "fsdp_sgd": case("4x2", "fsdp", opt="sgd"),
    "wus_micro2": case("4x2", "wus", micro=2),
    "fsdp_kv1": case("4x2", "fsdp", False, model="yi_kv1"),
    "jamba_batch_axes": case("8x1", "fsdp", model="jamba", opt="sgd"),
    "vlm_wus_sp1": case("4x2", "wus", model="vlm"),
}
ARCHS = {"yi": "yi-9b", "yi_kv1": "yi-9b", "jamba": "jamba-1.5-large-398b",
         "vlm": "qwen2-vl-7b"}
REFUSED = {"moe": "mixtral-8x7b", "mamba": "jamba-1.5-large-398b",
           "rwkv6": "rwkv6-3b", "encdec": "whisper-medium"}


def base_config(model, get_config):
    """The reduced config of ``model`` in fp32, from either package."""
    cfg = dataclasses.replace(get_config(ARCHS[model]).reduced(),
                              dtype="float32",
                              grad_dtype="float32", moment_dtype="float32")
    if model == "yi_kv1":
        cfg = dataclasses.replace(cfg, n_kv_heads=1)
    return cfg


def batches(cfg, seed=0, n=STEPS):
    """``n`` global batches: tokens, and a vision frontend's media."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        b = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int64)}
        if cfg.n_media_tokens:
            b["media"] = rng.standard_normal(
                (B, cfg.n_media_tokens, cfg.d_model)).astype(np.float32)
        out.append(b)
    return out


def eval_set(cfg):
    """One eval batch whose last two rows are padding (mask 0)."""
    mask = np.array([1] * (B - 2) + [0, 0], np.float32)
    return lambda: [(batches(cfg, seed=7, n=1)[0], mask)]


# --------------------------------------------------------------------------- #
# The ranks (torch only).
# --------------------------------------------------------------------------- #
def port_run(c, trees, *, mesh=None, device="cpu"):
    """The port's trainer on case ``c``: (history, eval nll after the
    steps, trainer)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.optim import adam, constant, sgd_momentum
    from repro_torch.train import Trainer, TrainerConfig

    cfg = dataclasses.replace(base_config(c["model"], get_config),
                              param_sharding=c["mode"],
                              seq_parallel=c["sp"], microbatches=c["micro"])
    opt = (adam(constant(LR), b1=0.9, b2=0.95, eps=EPS) if c["opt"] == "adam"
           else sgd_momentum(constant(LR), momentum=0.0))
    params = lm.params_from_numpy(trees[c["model"]], cfg, device=device,
                                  dtype=torch.float32)
    tr = Trainer(cfg, TrainerConfig(total_steps=STEPS, log_every=0,
                                    metrics=("grad_norm",)), opt,
                 device=device, params=params, mesh=mesh)
    hist = tr.fit(batches(cfg), hooks=[])
    return ([{k: r[k] for k in ("loss", "nll", "grad_norm")} for r in hist],
            tr.evaluate(eval_set(cfg))["eval_nll"], tr)


def rank_main(rank, store, inputs_path, out_path):
    import warnings

    import torch
    import torch.distributed as dist

    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.configs import get_config
    from repro_torch.dist import spmd
    from repro_torch.launch.mesh import init_process_group, make_mesh
    from repro_torch.models import lm
    from repro_torch.train import Trainer, TrainerConfig
    from repro_torch.utils import tree_leaves

    warnings.filterwarnings("ignore", category=FutureWarning)
    torch.set_num_threads(1)
    with open(inputs_path, "rb") as f:
        trees = pickle.load(f)
    init_process_group(device="cpu", rank=rank, world_size=WORLD,
                       store_path=store)
    meshes = {k: make_mesh(shape, names, device="cpu")
              for k, (shape, names) in MESHES.items()}
    out = {}
    for name, c in CASES.items():  # every rank in one order
        try:
            mesh = meshes[c["mesh"]]
            hist, ev, tr = port_run(c, trees, mesh=mesh)
            full = lm.params_from_numpy(trees[c["model"]], tr.cfg,
                                        device="cpu")
            specs = spmd.leaf_list(full, tr.plan.pspecs)
            out[name] = {"hist": hist, "eval": ev, "blocks": [
                (spmd.block_slices(s, f.shape, mesh), w.detach().numpy().copy())
                for f, s, w in zip(tree_leaves(full), specs,
                                   tree_leaves(tr.state["params"]))]}
        except Exception:  # recorded; the case's test fails with it
            out[name] = {"error": traceback.format_exc()}
    refused = {}
    for kind, arch in REFUSED.items():
        cfg = get_config(arch).reduced()
        refused[kind] = _raises(lambda: Trainer(cfg, device="cpu",
                                                mesh=meshes["4x2"]))
    yi = dataclasses.replace(get_config("yi-9b").reduced(),
                             dtype="float32")
    refused["checkpoint"] = _raises(lambda: Trainer(
        yi, TrainerConfig(checkpoint_every=1), device="cpu",
        mesh=meshes["4x2"]))
    tr = Trainer(yi, device="cpu", mesh=meshes["4x2"])
    refused["resume"] = _raises(lambda: tr.resume(out_path + ".nothing"))
    out["refused"] = refused
    with open(out_path, "wb") as f:
        pickle.dump(out, f)
    dist.destroy_process_group()


def _raises(fn):
    try:
        fn()
    except Exception as e:  # the test checks the type and message
        return (type(e).__name__, str(e))
    return None


def jax_main(inputs_path, out_path):
    """The reference's ``Trainer`` on ``make_test_mesh(4, 2)`` over 8
    host devices in ``wus`` with ``seq_parallel``, from the same tree and
    batches: losses, grad norms and the final weights."""
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    os.environ["JAX_PLATFORMS"] = "cpu"
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import jax

    from repro.configs import get_config
    from repro.launch.mesh import make_test_mesh
    from repro.optim import adam, constant
    from repro.train import Trainer, TrainerConfig

    with open(inputs_path, "rb") as f:
        trees = pickle.load(f)
    cfg = dataclasses.replace(base_config("yi", get_config),
                              param_sharding="wus", seq_parallel=True)
    mesh = make_test_mesh(4, 2)
    opt = adam(constant(LR), b1=0.9, b2=0.95, eps=EPS)
    tr = Trainer(cfg, mesh, TrainerConfig(total_steps=STEPS, log_every=0,
                                          metrics=("grad_norm",)), opt)
    params = jax.tree_util.tree_map(np.asarray, trees["yi"])
    with mesh:
        tr.state = jax.device_put({"params": params,
                                   "opt": opt.init(params)},
                                  tr._ns(tr.state_specs))
        hist = []
        for b in batches(cfg):
            if tr._train_step is None:
                tr._compile_train(b)
            tr.state, m = tr._train_step(tr.state, b)
            hist.append({k: float(m[k]) for k in ("loss", "nll",
                                                  "grad_norm")})
    final = jax.tree_util.tree_map(np.asarray, tr.state["params"])
    with open(out_path, "wb") as f:
        pickle.dump({"hist": hist, "params": final}, f)


def launch_ranks(store, inputs_path, out_dir):
    """The 8 ranks, forked from one fork server that imports torch and
    the port once. Returns the worst exit code."""
    import multiprocessing

    sys.path.insert(0, os.path.join(ROOT, "src"))
    ctx = multiprocessing.get_context("forkserver")
    ctx.set_forkserver_preload(["__main__", "torch", "torch.distributed",
                                "repro_torch.train"])
    procs = [ctx.Process(target=rank_main, args=(
        r, store, inputs_path, os.path.join(out_dir, f"rank{r}.pkl")))
        for r in range(WORLD)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=400)
    for p in procs:
        if p.is_alive():
            p.kill()
    return max(abs(p.exitcode if p.exitcode is not None else 1)
               for p in procs)


if __name__ == "__main__":
    if sys.argv[1] == "jax":
        jax_main(sys.argv[2], sys.argv[3])
        sys.exit(0)
    sys.exit(launch_ranks(*sys.argv[2:5]))


# --------------------------------------------------------------------------- #
# The tests.
# --------------------------------------------------------------------------- #
if __name__ != "__mp_main__":  # not in the ranks, which import torch only
    jax = pytest.importorskip("jax")
    import torch

    from repro.configs import get_config as jax_get_config
    from repro.dist import split_tree
    from repro.train import steps as JT
    from repro_torch.models import lm
    from repro_torch.utils import tree_leaves


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread while this file runs (the suite runs several
    workers on the machine's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def ref_trees():
    """One numpy tree a model: the reference's init, norms perturbed."""
    out = {}
    for model in ARCHS:
        jcfg = base_config(model, jax_get_config)
        vals = split_tree(JT.ModelAPI(jcfg).init(jcfg,
                                                 jax.random.PRNGKey(1)))[0]
        out[model] = lm.perturb_norms(vals, 101)
    return out


@pytest.fixture(scope="module")
def runs():
    """Every rank's results by case, the reference's mesh run, and the
    one-device runs (computed while the ranks run)."""
    trees = ref_trees()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "inputs.pkl")
        with open(path, "wb") as f:
            pickle.dump(trees, f)
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
            one = {}
            for name, c in CASES.items():
                key = (c["model"], c["opt"], c["micro"])
                if key not in one:
                    hist, ev, tr = port_run(c, trees)
                    one[key] = (hist, [w.detach().numpy().copy() for w in
                                       tree_leaves(tr.state["params"])], ev)
            for p in procs:
                logs.append(p.communicate(timeout=480)[0].decode()[-3000:])
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
            ref = pickle.load(f)
    return out, one, ref


def assemble(got, shapes):
    """The full leaves from every rank's blocks; blocks that several
    ranks hold must be bitwise equal."""
    full = [np.full(s, np.nan, np.float32) for s in shapes]
    for g in got:
        for i, (sl, blk) in enumerate(g["blocks"]):
            have = full[i][sl]
            seen = ~np.isnan(have)
            assert np.array_equal(have[seen], blk[seen]), \
                f"leaf {i}: replicas of a block differ"
            full[i][sl] = blk
    for i, f in enumerate(full):
        assert not np.isnan(f).any(), f"leaf {i}: no rank holds a block"
    return full


def worst_leaf(got, want):
    return max(float(np.abs(g - w).max() / (np.abs(w).max() + 1e-30))
               for g, w in zip(got, want))


def hold_history(got, want):
    for step, (g, w) in enumerate(zip(got, want)):
        for k in ("loss", "nll", "grad_norm"):
            assert abs(g[k] - w[k]) <= LOSS_TOL * abs(w[k]), (step, k, g, w)
    assert len(got) == len(want) == STEPS


@pytest.mark.parametrize("name", list(CASES))
def test_mesh_trainer_matches_one_device(runs, name):
    out, one, _ = runs
    got = [o[name] for o in out]
    for r, g in enumerate(got):
        if "error" in g:
            pytest.fail(f"rank {r}, case {name}:\n{g['error']}")
    c = CASES[name]
    hist, leaves, ev = one[(c["model"], c["opt"], c["micro"])]
    for g in got:  # every rank reports the global metrics
        hold_history(g["hist"], hist)
        assert abs(g["eval"] - ev) <= LOSS_TOL * ev, (g["eval"], ev)
    full = assemble(got, [w.shape for w in leaves])
    worst = worst_leaf(full, leaves)
    print(f"{name}: worst leaf error {worst:.3g} of its largest magnitude")
    assert worst <= LEAF_TOL, (name, worst)


def test_reference_mesh_trainer_matches(runs):
    """The port's (4, 2) ``wus`` run with ``seq_parallel`` against the
    reference's mesh ``Trainer`` on 8 host devices."""
    out, one, ref = runs
    got = [o["wus_sp1"] for o in out]
    for g in got:
        assert "error" not in g, g.get("error")
        hold_history(g["hist"], ref["hist"])
    _, leaves, _ = one[("yi", "adam", 1)]
    full = assemble(got, [w.shape for w in leaves])
    cfg = base_config("yi", jax_get_config)
    want = tree_leaves(lm.params_from_numpy(ref["params"], cfg,
                                            device="cpu",
                                            dtype=torch.float32))
    worst = worst_leaf(full, [w.numpy() for w in want])
    print(f"reference mesh trainer: worst leaf error {worst:.3g}")
    assert worst <= LEAF_TOL, worst


@pytest.mark.parametrize("kind", [*REFUSED, "checkpoint", "resume"])
def test_refused_on_a_mesh(runs, kind):
    out, _, _ = runs
    for o in out:
        got = o["refused"][kind]
        assert got is not None, kind
        assert got[0] == "NotImplementedError", got
        assert "6.2" in got[1], got
