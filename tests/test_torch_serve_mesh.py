"""The serving engine on a mesh (``Engine(..., rules=, mesh=)``,
``dist/serving.py``) over gloo ranks on the CPU, against the port's
one-device engine and the reference's ``Engine`` under ``tp2d`` on one
device (as ``tests/test_serve.py`` runs it), from one numpy tree a model.

The model is reduced gemma-7b in fp32 with 2 layers: 4 heads of 64
(4/4, or 4/2 where a case sets ``kv``), d_ff 512, vocab 1024. The cases
run on 4 ranks:

- ``tp2d`` on (2, 2) over the paged fp32 pool, a server stream with
  mixed arrivals, the prefix cache and n-gram drafts; again with 4/2
  heads (the KV heads divide ``model`` 2);
- ``tp2d`` on (1, 4) over an int8 pool with 4/2 heads (``model`` 4 does
  not divide the KV heads: each rank keeps the one its query reads);
- ``tp2d`` on (4, 1) and on (2, 2) with 4/1 heads on the slab layout
  (the latter's slab split over its slots, ``kv_seq``);
- ``fsdp`` on (2, 2), ``wus`` on (2, 2) with drafts, ``replicated`` on
  (2, 2) on the slab: each data rank computes its slots;
- reduced mixtral-8x7b (``fsdp``, paged) and reduced jamba-1.5-large
  (``tp2d``, slab) on (4, 1), the batch axes alone.

Each case holds every rank's greedy tokens bitwise to the one-device
engine's and (gemma) to the reference's; ``check_ranks`` raises inside
the engine if a rank's tokens differ from rank 0's. The chunk program's
logits over a scripted batch (a prefill chunk, then decode rows) are
held on every rank to the one-device program's at rtol 1e-5, atol 1e-5,
and to each other bitwise. A 1 x 1 gloo mesh (its own process) gives
``tp2d`` and ``fsdp`` tokens and logits bitwise the one-device
engine's. MoE, Mamba and RWKV-6 over ``model`` 2 and an enc-dec config
on a mesh raise ``NotImplementedError`` naming item 6.2.

One module fixture starts the ranks (``python tests/test_torch_serve_
mesh.py ranks STORE INPUTS OUTDIR``: forked from a fork server that
imports torch once; a ``FileStore`` rendezvous; each rank on one
thread) and the 1 x 1 process, and computes the one-device and
reference runs meanwhile; each test reads its case.
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
WORLD = 4
RTOL = ATOL = 1e-5
FP32 = dict(dtype="float32", kv_cache_dtype="float32", n_layers=2)
PAGED = dict(max_batch=4, max_len=40, page_size=4, prefill_chunk=4)
SLAB = dict(max_batch=4, max_len=40, kv_layout="slab", prefill_len=24)
DRAFTS = dict(prefix_cache=True, spec_decode="ngram", draft_len=3)
MESHES = {"2x2": (2, 2), "1x4": (1, 4), "4x1": (4, 1)}


def case(mesh, mode, knobs, *, model="gemma", kv=4):
    return dict(mesh=mesh, mode=mode, knobs=knobs, model=model, kv=kv)


CASES = {
    "tp2d_2x2_paged_drafts": case("2x2", "tp2d", dict(PAGED, **DRAFTS)),
    "tp2d_2x2_gqa_divides": case("2x2", "tp2d", PAGED, kv=2),
    "tp2d_1x4_int8_gqa": case("1x4", "tp2d", dict(PAGED, kv_dtype="int8"),
                              kv=2),
    "tp2d_4x1_slab": case("4x1", "tp2d", SLAB),
    "tp2d_2x2_slab_kv_seq": case("2x2", "tp2d", SLAB, kv=1),
    "fsdp_2x2_paged": case("2x2", "fsdp", PAGED),
    "wus_2x2_drafts": case("2x2", "wus", dict(PAGED, **DRAFTS), kv=2),
    "replicated_2x2_slab": case("2x2", "replicated", SLAB),
    "mixtral_4x1_fsdp": case("4x1", "fsdp", PAGED, model="mixtral"),
    "jamba_4x1_tp2d_slab": case("4x1", "tp2d", SLAB, model="jamba"),
}
ONE = {"tp2d_1x1": case("1x1", "tp2d", dict(PAGED, **DRAFTS)),
       "fsdp_1x1": case("1x1", "fsdp", PAGED)}
ARCHS = {"gemma": "gemma-7b", "mixtral": "mixtral-8x7b",
         "jamba": "jamba-1.5-large-398b"}
REFUSED = {"moe": "mixtral-8x7b", "mamba": "jamba-1.5-large-398b",
           "rwkv6": "rwkv6-3b", "encdec": "whisper-medium"}


def base_config(c, get_config):
    """The case's reduced config in fp32, from either package."""
    cfg = dataclasses.replace(get_config(ARCHS[c["model"]]).reduced(),
                              **dict(FP32, n_layers=3 if c["model"] == "jamba"
                                     else 2))  # jamba: its 3 positions
    if c["model"] == "gemma":
        cfg = dataclasses.replace(cfg, n_kv_heads=c["kv"])
    return cfg


def paged_gemma(c):
    return c["model"] == "gemma" and c["knobs"].get("kv_layout") != "slab"


def tree_key(c):
    return (c["model"], c["kv"])


def workload(make, cfg):
    """A server stream: mixed arrivals, two 8-token templates."""
    reqs = make(cfg, n=6, tokens=6, prompt_len=20, scenario="server",
                seed=3, shared_prefix_len=8, n_templates=2)
    for i, r in enumerate(reqs):
        r.id = i
    return reqs


# --------------------------------------------------------------------------- #
# The port's runs (torch only: the ranks import no JAX).
# --------------------------------------------------------------------------- #
def port_tokens(c, trees, **kw):
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.serve.engine import Engine, ServeConfig, \
        synthetic_requests
    from repro_torch.serve.scenarios import run_server

    cfg = base_config(c, get_config)
    params = lm.params_from_numpy(trees[tree_key(c)], cfg, device="cpu")
    report = run_server(Engine(cfg, params, ServeConfig(**c["knobs"]), **kw),
                        workload(synthetic_requests, cfg))
    return [list(r.tokens) for r in sorted(report.requests,
                                           key=lambda r: r.id)]


def chunk_logits(trees, mesh=None, mode="tp2d", kv=4):
    """The chunk program's logits (every row) over a scripted batch: 4
    rows, chunks of 4, pages of 4; step 1 prefills 4/3/2/1 tokens, steps
    2-3 decode one token a row."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.dist.serving import ServePlan
    from repro_torch.dist.sharding import Rules
    from repro_torch.models import layers as L
    from repro_torch.models import lm

    c = case(None, mode, None, kv=kv)
    cfg = base_config(c, get_config)
    params = lm.params_from_numpy(trees[tree_key(c)], cfg, device="cpu")
    B, C, P = 4, 4, 4
    place = None
    if mesh is None:
        cache = L.init_paged_kv_cache(cfg, 16, P, n_layers=cfg.n_layers,
                                      device="cpu")
    else:
        plan = ServePlan(cfg, Rules(mesh, mode), params, max_batch=B,
                         layout="paged")
        params, cache = plan.params, plan.init_paged_cache(16, P)
    ptab = torch.arange(16, dtype=torch.int32).reshape(B, 4)
    rng = np.random.default_rng(5)
    pos = torch.zeros(B, dtype=torch.int32)
    out = []
    with torch.inference_mode():
        for step in range(3):
            nv = (torch.tensor([4, 3, 2, 1], dtype=torch.int32) if step == 0
                  else torch.ones(B, dtype=torch.int32))
            toks = torch.from_numpy(rng.integers(0, cfg.vocab, (B, C)))
            if mesh is not None:
                place = plan.placement(rows=True)
            logits, cache = lm.decode_chunk(params, cfg, toks, cache, ptab,
                                            pos, nv, place=place)
            if place is not None:
                logits = place.all_rows(logits)
            out.append(logits.numpy().copy())
            pos = pos + nv
    return out


def _raises(fn):
    try:
        fn()
    except Exception as e:  # the test checks the type and message
        return (type(e).__name__, str(e))
    return None


def rank_cases(trees, meshes, cases):
    from repro_torch.dist.sharding import Rules

    out = {}
    for name, c in cases.items():  # every rank in one order
        try:
            mesh = meshes[c["mesh"]]
            out[name] = {
                "tokens": port_tokens(c, trees, rules=Rules(mesh, c["mode"]),
                                      check_ranks=True)}
            if paged_gemma(c):
                out[name]["logits"] = chunk_logits(trees, mesh, c["mode"],
                                                   c["kv"])
        except Exception:  # recorded; the case's test fails with it
            out[name] = {"error": traceback.format_exc()}
    return out


def rank_main(rank, store, inputs_path, out_path):
    import warnings

    import torch
    import torch.distributed as dist

    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import init_process_group, make_mesh
    from repro_torch.models import lm
    from repro_torch.serve.engine import Engine

    warnings.filterwarnings("ignore", category=FutureWarning)
    torch.set_num_threads(1)
    with open(inputs_path, "rb") as f:
        trees = pickle.load(f)
    init_process_group(device="cpu", rank=rank, world_size=WORLD,
                       store_path=store)
    meshes = {k: make_mesh(s, ("data", "model"), device="cpu")
              for k, s in MESHES.items()}
    out = rank_cases(trees, meshes, CASES)
    refused = {}
    for kind, arch in REFUSED.items():
        cfg = get_config(arch).reduced()
        refused[kind] = _raises(lambda: Engine(
            cfg, lm.init_lm(cfg, device="cpu") if not cfg.is_encdec
            else {}, mesh=meshes["2x2"]))
    out["refused"] = refused
    with open(out_path, "wb") as f:
        pickle.dump(out, f)
    dist.destroy_process_group()


def one_main(inputs_path, out_path):
    """The 1 x 1 gloo mesh of one process."""
    import warnings

    import torch
    import torch.distributed as dist

    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.launch.mesh import single_device_mesh

    warnings.filterwarnings("ignore", category=FutureWarning)
    torch.set_num_threads(1)
    with open(inputs_path, "rb") as f:
        trees = pickle.load(f)
    out = rank_cases(trees, {"1x1": single_device_mesh("cpu")}, ONE)
    with open(out_path, "wb") as f:
        pickle.dump(out, f)
    dist.destroy_process_group()


def launch_ranks(store, inputs_path, out_dir):
    """The ranks, forked from one fork server that imports torch and the
    port once. Returns the worst exit code."""
    import multiprocessing

    sys.path.insert(0, os.path.join(ROOT, "src"))
    ctx = multiprocessing.get_context("forkserver")
    ctx.set_forkserver_preload(["__main__", "torch", "torch.distributed",
                                "repro_torch.serve.engine"])
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
    if sys.argv[1] == "one":
        one_main(sys.argv[2], sys.argv[3])
        sys.exit(0)
    sys.exit(launch_ranks(*sys.argv[2:5]))


# --------------------------------------------------------------------------- #
# The tests.
# --------------------------------------------------------------------------- #
if __name__ != "__mp_main__":  # not in the ranks, which import torch only
    jax = pytest.importorskip("jax")
    import torch

    from repro.configs import get_config as jax_get_config
    from repro.dist import Rules as JaxRules
    from repro.dist import split_tree
    from repro.launch.mesh import single_device_mesh as jax_single_mesh
    from repro.serve import Engine as JaxEngine
    from repro.serve import ServeConfig as JaxServeConfig
    from repro.serve.engine import synthetic_requests as jax_requests
    from repro.serve.scenarios import run_server as jax_run_server
    from repro.train import steps as JT


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def ref_trees():
    """One numpy tree a (model, KV heads): the reference's init, norms
    perturbed."""
    from repro_torch.models import lm

    out = {}
    for c in list(CASES.values()) + list(ONE.values()):
        if tree_key(c) in out:
            continue
        jcfg = base_config(c, jax_get_config)
        vals = split_tree(JT.ModelAPI(jcfg).init(jcfg,
                                                 jax.random.PRNGKey(1)))[0]
        out[tree_key(c)] = lm.perturb_norms(
            jax.tree_util.tree_map(np.asarray, vals), 101)
    return out


def ref_tokens(c, trees):
    """The reference's ``Engine`` under ``tp2d`` on one device."""
    jcfg = base_config(c, jax_get_config)
    knobs = dict(c["knobs"])
    knobs.setdefault("kv_layout", "paged")
    mesh = jax_single_mesh()
    with mesh:
        eng = JaxEngine(jcfg, trees[tree_key(c)], JaxRules(mesh, "tp2d"),
                        JaxServeConfig(**knobs))
        report = jax_run_server(eng, workload(jax_requests, jcfg))
    return [list(r.tokens) for r in sorted(report.requests,
                                           key=lambda r: r.id)]


@pytest.fixture(scope="module")
def runs():
    """Every rank's results by case, the 1 x 1 process's, and the
    one-device and reference runs (computed while the ranks run)."""
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
                ("one", path, os.path.join(tmp, "one.pkl")))]
        logs = []
        try:
            one, ref = {}, {}
            for name, c in {**CASES, **ONE}.items():
                one[name] = port_tokens(c, trees, device="cpu")
                if c["model"] == "gemma":
                    ref[name] = ref_tokens(c, trees)
            logits = {kv: chunk_logits(trees, kv=kv) for kv in (4, 2)}
            for p in procs:
                logs.append(p.communicate(timeout=400)[0].decode()[-3000:])
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
        with open(os.path.join(tmp, "one.pkl"), "rb") as f:
            single = pickle.load(f)
    return out, single, one, ref, logits


def _case(got, name):
    for r, g in enumerate(got):
        if "error" in g:
            pytest.fail(f"rank {r}, case {name}:\n{g['error']}")
    return got


@pytest.mark.parametrize("name", list(CASES))
def test_mesh_tokens_match_one_device_and_reference(runs, name):
    out, _, one, ref, _ = runs
    got = _case([o[name] for o in out], name)
    for g in got:
        assert g["tokens"] == one[name]
    if name in ref:
        assert one[name] == ref[name]


@pytest.mark.parametrize("name", [n for n, c in CASES.items()
                                  if paged_gemma(c)])
def test_mesh_chunk_logits(runs, name):
    """Every rank's logits hold to the one-device program's, and the
    ranks' to each other bitwise."""
    out, _, _, _, logits = runs
    got = _case([o[name] for o in out], name)
    want = logits[CASES[name]["kv"]]
    for g in got:
        for a, b in zip(g["logits"], got[0]["logits"]):
            assert np.array_equal(a, b), "ranks' logits differ"
        for a, w in zip(g["logits"], want):
            np.testing.assert_allclose(a, w, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", list(ONE))
def test_one_by_one_mesh_is_bitwise_one_device(runs, name):
    _, single, one, ref, logits = runs
    got = _case([single[name]], name)[0]
    assert got["tokens"] == one[name] == ref[name]
    for a, w in zip(got["logits"], logits[4]):
        assert np.array_equal(a, w)


@pytest.mark.parametrize("kind", list(REFUSED))
def test_refused_on_a_mesh(runs, kind):
    out, _, _, _, _ = runs
    for o in out:
        got = o["refused"][kind]
        assert got is not None and got[0] == "NotImplementedError", got
        assert "item 6.2" in got[1], got
