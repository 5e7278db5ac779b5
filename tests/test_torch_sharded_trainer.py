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
  (under Adam a weight moved by rounding flips an MoE route at step 2);
- layers split over ``model`` 2, SGD: reduced mixtral-8x7b in ``fsdp``
  on (4, 2) with its 4 experts (2 a rank) and with 3 (``model`` does not
  divide them: 256 of each expert's 512 hidden units a rank); reduced
  jamba in ``fsdp`` with ``seq_parallel`` on (4, 2) (256 of 512 Mamba
  channels, 2 of 4 experts a rank) and in ``wus`` on (2, 2, 2); reduced
  rwkv6-3b in ``wus`` on (4, 2) (4 of its 8 heads of 32 a rank); and
  rwkv6 at d 192 with heads of 64 in ``fsdp`` on (4, 2): 3 heads, which 2
  does not divide, so each rank gathers its 96-column blocks and runs
  every head. RWKV-6 under Adam reads 1.38e-5 on (8, 1) alone, without
  ``model`` (a near-zero gradient's rounding, normalised), above
  ``LEAF_TOL``; SGD's update is linear in the gradient and shows a split
  that is off;
- reduced whisper-medium (2 encoder layers over 64 frames, 2 decoder
  layers, 4/4 heads of 64) on (4, 2): in ``wus`` with and without
  ``seq_parallel`` (with it each stream split over ``model`` by its own
  length: 32 frames and 16 tokens a rank), in ``fsdp`` without it, and
  in ``wus`` over 33 frames, which ``model`` 2 does not divide (the
  encoder stream whole on every rank, the decoder's split), the last two
  under SGD;
- a batch of 6 rows on (4, 2), which the 4 batch ranks do not divide: it
  is replicated over them, every rank computing every row, in ``wus``
  (Adam) and ``fsdp`` (SGD).

Each case holds the loss, nll and ``grad_norm`` of every step and the
masked eval nll after them (``Trainer.evaluate`` over a batch whose last
two rows are padding) to ``LOSS_TOL`` relative, and every leaf after 3
steps to ``LEAF_TOL`` of the
leaf's largest magnitude, against the one-device trainer on the same
global batches (sound runs read at most 1.7e-6, the worst printed by
the ``-s`` run); the blocks that several ranks hold must agree to the
last bit. The (4, 2) ``wus`` run with
``seq_parallel`` is also held against the reference's ``Trainer`` on
``make_test_mesh(4, 2)`` over 8 host devices, in a JAX subprocess, and so
are ``jamba_fsdp_sp1``, ``whisper_wus`` and ``wus_rows6`` (the
reference replicates that batch too). Its program for whisper with
``seq_parallel`` hangs in XLA's CPU runtime on 8 host devices under load,
so that case is held to one device only. The ``NotImplementedError`` s are
pinned: a checkpoint or a resume on more than one rank; the MoE, Mamba,
RWKV-6 and enc-dec kinds that raised on a mesh until it split them are
held instead (``test_refused_on_a_mesh``): each reduced arch in fp32 in
its own mode (``replicated``: whole weights, each rank cutting its block
after a ``pvary``) trains 2 steps on (4, 2), loss, nll and grad norm to
``LOSS_TOL`` of the one-device trainer's.

One module fixture starts the ranks (``python tests/test_torch_sharded_
trainer.py ranks STORE INPUTS OUTDIR``: one process forks them from a
fork server that imports torch once; a ``FileStore`` rendezvous; each
rank on one thread) and the JAX subprocess; each rank runs every case
and pickles its blocks, and each test reads its case. A rank's
traceback fails only its case. Rank 0 also records the collectives of
one ``wus`` step on (4, 2) with the dry run's recorder, held against
``launch.dryrun.dryrun_step`` on a fake (4, 2) world.

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


def case(mesh, mode, sp=True, *, model="yi", opt="adam", micro=1, rows=B):
    return dict(mesh=mesh, mode=mode, sp=sp, model=model, opt=opt,
                micro=micro, rows=rows)


CASES = {
    **{f"{mode}_sp{int(sp)}": case("4x2", mode, sp)
       for mode in ("replicated", "fsdp", "wus") for sp in (True, False)},
    "wus_pod": case("2x2x2", "wus"),
    "fsdp_sgd": case("4x2", "fsdp", opt="sgd"),
    "wus_micro2": case("4x2", "wus", micro=2),
    "fsdp_kv1": case("4x2", "fsdp", False, model="yi_kv1"),
    "jamba_batch_axes": case("8x1", "fsdp", model="jamba", opt="sgd"),
    "vlm_wus_sp1": case("4x2", "wus", model="vlm"),
    "mixtral_experts": case("4x2", "fsdp", model="mixtral", opt="sgd"),
    "mixtral_hidden": case("4x2", "fsdp", model="mixtral_e3", opt="sgd"),
    "jamba_fsdp_sp1": case("4x2", "fsdp", model="jamba", opt="sgd"),
    "jamba_wus_pod": case("2x2x2", "wus", model="jamba", opt="sgd"),
    "rwkv_wus": case("4x2", "wus", model="rwkv", opt="sgd"),
    "rwkv_mid_head": case("4x2", "fsdp", False, model="rwkv_mid",
                          opt="sgd"),
    "whisper_wus_sp1": case("4x2", "wus", model="whisper"),
    "whisper_wus": case("4x2", "wus", False, model="whisper"),
    "whisper_fsdp": case("4x2", "fsdp", False, model="whisper", opt="sgd"),
    "whisper_t33_wus": case("4x2", "wus", model="whisper_t33", opt="sgd"),
    "wus_rows6": case("4x2", "wus", rows=6),
    "fsdp_rows6": case("4x2", "fsdp", rows=6, opt="sgd"),
}
# the step whose collectives rank 0 records for the dry run's check
RECORDED = case("4x2", "wus")
# the cases the reference's mesh Trainer runs too, beside ``wus_sp1``.
# Not ``whisper_wus_sp1``: on 8 host devices under load the reference's
# program for it hangs in XLA's CPU runtime (a collective permute over all
# 8 devices against an all-reduce of one model pair), where without
# ``seq_parallel`` it does not.
JAX_CASES = ("jamba_fsdp_sp1", "whisper_wus", "wus_rows6")
ARCHS = {"yi": "yi-9b", "yi_kv1": "yi-9b", "jamba": "jamba-1.5-large-398b",
         "vlm": "qwen2-vl-7b", "mixtral": "mixtral-8x7b",
         "mixtral_e3": "mixtral-8x7b", "rwkv": "rwkv6-3b",
         "rwkv_mid": "rwkv6-3b", "whisper": "whisper-medium",
         "whisper_t33": "whisper-medium"}
# The kinds that raised on a model axis before they were split over it;
# each is now held to the one-device trainer (``test_refused_on_a_mesh``).
REFUSED = {"moe": "mixtral-8x7b", "mamba": "jamba-1.5-large-398b",
           "rwkv6": "rwkv6-3b", "encdec": "whisper-medium"}


def base_config(model, get_config):
    """The reduced config of ``model`` in fp32, from either package."""
    cfg = dataclasses.replace(get_config(ARCHS[model]).reduced(),
                              dtype="float32",
                              grad_dtype="float32", moment_dtype="float32")
    if model == "yi_kv1":
        cfg = dataclasses.replace(cfg, n_kv_heads=1)
    if model == "mixtral_e3":  # 3 experts: model 2 splits their units
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, n_experts=3))
    if model == "rwkv_mid":  # 3 heads of 64: model 2 cuts one mid-head
        cfg = dataclasses.replace(cfg, d_model=192, rwkv6=dataclasses.replace(
            cfg.rwkv6, head_dim=64))
    if model == "whisper_t33":  # 33 frames: model 2 keeps the encoder whole
        cfg = dataclasses.replace(cfg, enc_source_len=33)
    return cfg


def batches(cfg, seed=0, n=STEPS, rows=B):
    """``n`` global batches of ``rows`` rows: tokens, and a vision
    frontend's media or an enc-dec's encoder frames."""
    rng = np.random.default_rng(seed)
    n_media = cfg.enc_source_len if cfg.is_encdec else cfg.n_media_tokens
    out = []
    for _ in range(n):
        b = {"tokens": rng.integers(0, cfg.vocab, (rows, S)).astype(np.int64)}
        if n_media:
            b["media"] = rng.standard_normal(
                (rows, n_media, cfg.d_model)).astype(np.float32)
        out.append(b)
    return out


def eval_set(cfg, rows=B):
    """One eval batch whose last two rows are padding (mask 0)."""
    mask = np.array([1] * (rows - 2) + [0, 0], np.float32)
    return lambda: [(batches(cfg, seed=7, n=1, rows=rows)[0], mask)]


def from_numpy(tree, cfg, **kw):
    """The family's weight bridge (``lm`` or ``encdec``)."""
    from repro_torch.models import encdec, lm

    return (encdec if cfg.is_encdec else lm).params_from_numpy(tree, cfg,
                                                               **kw)


# --------------------------------------------------------------------------- #
# The ranks (torch only).
# --------------------------------------------------------------------------- #
def port_run(c, trees, *, mesh=None, device="cpu"):
    """The port's trainer on case ``c``: (history, eval nll after the
    steps, trainer)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.optim import adam, constant, sgd_momentum
    from repro_torch.train import Trainer, TrainerConfig

    cfg = dataclasses.replace(base_config(c["model"], get_config),
                              param_sharding=c["mode"],
                              seq_parallel=c["sp"], microbatches=c["micro"])
    opt = (adam(constant(LR), b1=0.9, b2=0.95, eps=EPS) if c["opt"] == "adam"
           else sgd_momentum(constant(LR), momentum=0.0))
    params = from_numpy(trees[c["model"]], cfg, device=device,
                        dtype=torch.float32)
    tr = Trainer(cfg, TrainerConfig(total_steps=STEPS, log_every=0,
                                    metrics=("grad_norm",)), opt,
                 device=device, params=params, mesh=mesh)
    hist = tr.fit(batches(cfg, rows=c["rows"]), hooks=[])
    return ([{k: r[k] for k in ("loss", "nll", "grad_norm")} for r in hist],
            tr.evaluate(eval_set(cfg, c["rows"]))["eval_nll"], tr)


def rank_main(rank, store, inputs_path, out_path):
    import warnings

    import torch
    import torch.distributed as dist

    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.configs import get_config
    from repro_torch.dist import spmd
    from repro_torch.launch.mesh import init_process_group, make_mesh
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
            full = from_numpy(trees[c["model"]], tr.cfg, device="cpu")
            specs = spmd.leaf_list(full, tr.plan.pspecs)
            out[name] = {"hist": hist, "eval": ev, "blocks": [
                (spmd.block_slices(s, f.shape, mesh), w.detach().numpy().copy())
                for f, s, w in zip(tree_leaves(full), specs,
                                   tree_leaves(tr.state["params"]))]}
        except Exception:  # recorded; the case's test fails with it
            out[name] = {"error": traceback.format_exc()}
    refused = {}
    for kind, arch in REFUSED.items():
        try:
            refused[kind] = pinned_history(arch, meshes["4x2"])
        except Exception:  # recorded; the kind's test fails with it
            refused[kind] = {"error": traceback.format_exc()}
    yi = dataclasses.replace(get_config("yi-9b").reduced(),
                             dtype="float32")
    refused["checkpoint"] = _raises(lambda: Trainer(
        yi, TrainerConfig(checkpoint_every=1), device="cpu",
        mesh=meshes["4x2"]))
    tr = Trainer(yi, device="cpu", mesh=meshes["4x2"])
    refused["resume"] = _raises(lambda: tr.resume(out_path + ".nothing"))
    out["refused"] = refused
    try:
        out["collectives"] = recorded_step(meshes[RECORDED["mesh"]])
    except Exception:  # recorded; the test fails with it
        out["collectives"] = {"error": traceback.format_exc()}
    with open(out_path, "wb") as f:
        pickle.dump(out, f)
    dist.destroy_process_group()


def recorded_config(get_config):
    c = RECORDED
    return dataclasses.replace(base_config(c["model"], get_config),
                               param_sharding=c["mode"],
                               seq_parallel=c["sp"])


def recorded_step(mesh):
    """One train step of the ``RECORDED`` case from a fresh trainer (the
    default optimizer, no extra metrics) under the dry run's collective
    recorder: this rank's (bytes, counts) by kind."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.dist import spmd
    from repro_torch.launch.dryrun import CollectiveRecorder
    from repro_torch.train import Trainer, TrainerConfig

    cfg = recorded_config(get_config)
    tr = Trainer(cfg, TrainerConfig(total_steps=1, log_every=0),
                 device="cpu", mesh=mesh)
    rows = spmd.batch_rows({k: torch.as_tensor(v) for k, v in
                            batches(cfg, n=1)[0].items()}, mesh)
    rec = CollectiveRecorder()
    with rec:
        tr._train_step(tr.state, rows)
    return {"bytes": dict(rec.bytes), "counts": dict(rec.counts)}


def pinned_history(arch, mesh=None):
    """Two steps of reduced ``arch`` in fp32 in its config's own mode
    (``replicated``, ``seq_parallel``) and optimizer, from the trainer's
    seeded weights (``encdec.init_encdec``'s for whisper): loss, nll and
    grad_norm a step."""
    from repro_torch.configs import get_config
    from repro_torch.train import Trainer, TrainerConfig

    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32",
                              grad_dtype="float32", moment_dtype="float32")
    tr = Trainer(cfg, TrainerConfig(total_steps=2, log_every=0,
                                    metrics=("grad_norm",)),
                 device="cpu", mesh=mesh)
    return [{k: r[k] for k in ("loss", "nll", "grad_norm")}
            for r in tr.fit(batches(cfg, n=2), hooks=[])]


def _raises(fn):
    try:
        fn()
    except Exception as e:  # the test checks the type and message
        return (type(e).__name__, str(e))
    return None


def jax_main(inputs_path, out_path):
    """The reference's ``Trainer`` on ``make_test_mesh(4, 2)`` over 8
    host devices, from the same trees and batches: yi in ``wus`` with
    ``seq_parallel`` under Adam, and the cases of :data:`JAX_CASES`
    (jamba in ``fsdp`` with ``seq_parallel`` under SGD, reduced whisper
    in ``wus``, and yi on a batch of 6 rows, which the reference
    replicates over the 4 batch ranks): losses, grad norms and the final
    weights of each."""
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    os.environ["JAX_PLATFORMS"] = "cpu"
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import jax

    from repro.configs import get_config
    from repro.launch.mesh import make_test_mesh
    from repro.optim import adam, constant, sgd_momentum
    from repro.train import Trainer, TrainerConfig

    with open(inputs_path, "rb") as f:
        trees = pickle.load(f)
    mesh = make_test_mesh(4, 2)

    def run(c):
        cfg = dataclasses.replace(base_config(c["model"], get_config),
                                  param_sharding=c["mode"],
                                  seq_parallel=c["sp"])
        opt = (adam(constant(LR), b1=0.9, b2=0.95, eps=EPS)
               if c["opt"] == "adam"
               else sgd_momentum(constant(LR), momentum=0.0))
        tr = Trainer(cfg, mesh, TrainerConfig(total_steps=STEPS, log_every=0,
                                              metrics=("grad_norm",)), opt)
        params = jax.tree_util.tree_map(np.asarray, trees[c["model"]])
        with mesh:
            tr.state = jax.device_put({"params": params,
                                       "opt": opt.init(params)},
                                      tr._ns(tr.state_specs))
            hist = []
            for b in batches(cfg, rows=c["rows"]):
                if tr._train_step is None:
                    tr._compile_train(b)
                tr.state, m = tr._train_step(tr.state, b)
                hist.append({k: float(m[k]) for k in ("loss", "nll",
                                                      "grad_norm")})
        final = jax.tree_util.tree_map(np.asarray, tr.state["params"])
        return {"hist": hist, "params": final}

    out = run(CASES["wus_sp1"])
    for name in JAX_CASES:
        out[name] = run(CASES[name])
    with open(out_path, "wb") as f:
        pickle.dump(out, f)


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
                key = one_key(c)
                if key not in one:
                    hist, ev, tr = port_run(c, trees)
                    one[key] = (hist, [w.detach().numpy().copy() for w in
                                       tree_leaves(tr.state["params"])], ev)
            for kind, arch in REFUSED.items():
                one[kind] = pinned_history(arch)
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


def one_key(c):
    """The one-device run a case is held to."""
    return (c["model"], c["opt"], c["micro"], c["rows"])


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
    hist, leaves, ev = one[one_key(CASES[name])]
    for g in got:  # every rank reports the global metrics
        hold_history(g["hist"], hist)
        assert abs(g["eval"] - ev) <= LOSS_TOL * ev, (g["eval"], ev)
    full = assemble(got, [w.shape for w in leaves])
    worst = worst_leaf(full, leaves)
    print(f"{name}: worst leaf error {worst:.3g} of its largest magnitude")
    assert worst <= LEAF_TOL, (name, worst)


def hold_reference(runs, name, ref):
    """Every rank's history of case ``name`` to the reference's mesh run
    ``ref``, and the assembled leaves to its final weights."""
    out, one, _ = runs
    got = [o[name] for o in out]
    for g in got:
        assert "error" not in g, g.get("error")
        hold_history(g["hist"], ref["hist"])
    c = CASES[name]
    _, leaves, _ = one[one_key(c)]
    full = assemble(got, [w.shape for w in leaves])
    cfg = base_config(c["model"], jax_get_config)
    want = tree_leaves(from_numpy(ref["params"], cfg, device="cpu",
                                  dtype=torch.float32))
    worst = worst_leaf(full, [w.numpy() for w in want])
    print(f"reference mesh trainer, {name}: worst leaf error {worst:.3g}")
    assert worst <= LEAF_TOL, worst


def test_reference_mesh_trainer_matches(runs):
    """The port's (4, 2) ``wus`` run with ``seq_parallel`` against the
    reference's mesh ``Trainer`` on 8 host devices."""
    hold_reference(runs, "wus_sp1", runs[2])


def test_reference_mesh_trainer_matches_jamba(runs):
    """The port's (4, 2) ``fsdp`` jamba run with ``seq_parallel``
    (``jamba_fsdp_sp1``: Mamba channels, experts and attention heads
    split over ``model``) against the reference's mesh ``Trainer``."""
    hold_reference(runs, "jamba_fsdp_sp1", runs[2]["jamba_fsdp_sp1"])


def test_reference_mesh_trainer_matches_whisper(runs):
    """Reduced whisper in ``wus`` on (4, 2): 2 of 4 heads and 256 of 512
    FFN units a rank in the encoder's and decoder's layers, against the
    reference's mesh ``Trainer``."""
    hold_reference(runs, "whisper_wus", runs[2]["whisper_wus"])


def test_reference_mesh_trainer_replicates_an_undivided_batch(runs):
    """A batch of 6 rows on (4, 2): the 4 batch ranks do not divide it,
    so every rank computes every row, as the reference's mesh ``Trainer``
    replicates it (``batch_pspecs``' divisibility fallback)."""
    hold_reference(runs, "wus_rows6", runs[2]["wus_rows6"])


@pytest.mark.parametrize("kind", [*REFUSED, "checkpoint", "resume"])
def test_refused_on_a_mesh(runs, kind):
    """Checkpoints and resumes on more than one rank still raise, naming
    item 6.2; the MoE, Mamba, RWKV-6 and enc-dec kinds that raised on a
    mesh now train on (4, 2) in their configs' own mode, each step's
    loss, nll and grad_norm held to the one-device trainer's at
    ``LOSS_TOL``."""
    out, one, _ = runs
    for o in out:
        got = o["refused"][kind]
        if kind in REFUSED:
            assert "error" not in got, got
            want = one[kind]
            assert len(got) == len(want) == 2
            for g, w in zip(got, want):
                for k in ("loss", "nll", "grad_norm"):
                    assert abs(g[k] - w[k]) <= LOSS_TOL * abs(w[k]), (k, g, w)
            continue
        assert got is not None, kind
        assert got[0] == "NotImplementedError", got
        assert "6.2" in got[1], got


def test_collectives_equal_the_dry_run(runs):
    """Rank 0's collectives in one real ``wus`` step with
    ``seq_parallel`` on (4, 2): their counts and result bytes by kind
    equal ``launch.dryrun.dryrun_step``'s on a fake (4, 2) world for the
    same config, batch and mode."""
    from repro_torch.configs import InputShape, get_config
    from repro_torch.launch.dryrun import dryrun_step

    out, _, _ = runs
    got = out[0]["collectives"]
    assert "error" not in got, got.get("error")
    shapes, names = MESHES[RECORDED["mesh"]]
    want = dryrun_step(recorded_config(get_config),
                       InputShape("recorded", S, B, "train"),
                       dict(zip(names, shapes)), RECORDED["mode"])
    print(f"recorded step: {got}")
    assert got["counts"] == want["collective_counts"]
    assert got["bytes"] == want["collective_bytes_per_device"]
    assert set(got["counts"]) == {"all-gather", "reduce-scatter",
                                  "all-reduce"}
