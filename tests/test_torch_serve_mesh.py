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
  (``tp2d``, slab) on (4, 1), the batch axes alone;
- layers split over ``model``: reduced mixtral in ``tp2d`` on (2, 2)
  (2 of its 4 experts a rank), with 3 experts in ``fsdp`` on (1, 4) (128
  of each expert's 512 hidden units a rank), reduced jamba in ``tp2d`` on
  (2, 2) from the slab (Mamba channels and experts split), reduced
  rwkv6-3b in ``fsdp`` on (2, 2) from the slab (4 of 8 heads a rank, the
  slab's state whole);
- ``tp2d`` and ``fsdp`` on (2, 2) with one slot (``max_batch`` 1, as
  ``long_500k`` decodes): the batch axes do not divide the one row, so
  it is replicated over them and every rank computes it;
- reduced whisper-medium (2 encoder and 2 decoder layers, 4/4 heads of
  64, 64 frames a request) on (2, 2) in ``tp2d`` (paged with the prefix
  cache and n-gram drafts, and from the slab) and in ``fsdp`` (paged and
  slab): each request encoded at admission on every rank, the cross slab
  of the rank's KV heads (and, in ``fsdp``, its slots).

Each case holds every rank's greedy tokens bitwise to the one-device
engine's and (gemma) to the reference's; ``check_ranks`` raises inside
the engine if a rank's tokens differ from rank 0's. The chunk program's
logits over a scripted batch (a prefill chunk, then decode rows) are
held on every rank to the one-device program's at rtol 1e-5, atol 1e-5,
and to each other bitwise; in the split-layer cases every program's
logits (chunk, prefill and decode steps of the workload) are held so,
and each rank's slab leaves have the block shapes of ``cache_pspecs``.
A 1 x 1 gloo mesh (its own process) gives ``tp2d`` and ``fsdp`` tokens
and logits bitwise the one-device engine's. The MoE, Mamba, RWKV-6 and
enc-dec kinds that raised on a mesh serve on (2, 2) in their reduced
configs' own mode (``replicated``), with the one-device tokens.

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
    "tp2d_2x2_b1": case("2x2", "tp2d", dict(PAGED, max_batch=1)),
    "fsdp_2x2_b1": case("2x2", "fsdp", dict(PAGED, max_batch=1)),
    "mixtral_2x2_tp2d": case("2x2", "tp2d", PAGED, model="mixtral"),
    "mixtral_e3_1x4_fsdp": case("1x4", "fsdp", PAGED, model="mixtral_e3"),
    "jamba_2x2_tp2d_slab": case("2x2", "tp2d", SLAB, model="jamba"),
    "rwkv_2x2_fsdp_slab": case("2x2", "fsdp", SLAB, model="rwkv"),
    "whisper_2x2_tp2d_drafts": case("2x2", "tp2d", dict(PAGED, **DRAFTS),
                                    model="whisper"),
    "whisper_2x2_fsdp": case("2x2", "fsdp", PAGED, model="whisper"),
    "whisper_2x2_tp2d_slab": case("2x2", "tp2d", SLAB, model="whisper"),
    "whisper_2x2_fsdp_slab": case("2x2", "fsdp", SLAB, model="whisper"),
}
# The cases of layers split over ``model`` (MoE experts or hidden units,
# Mamba channels, RWKV-6 heads, an enc-dec's encoder, self- and
# cross-attention): every program's logits are recorded.
LAYERS = ("mixtral_2x2_tp2d", "mixtral_e3_1x4_fsdp", "jamba_2x2_tp2d_slab",
          "rwkv_2x2_fsdp_slab", "whisper_2x2_tp2d_drafts", "whisper_2x2_fsdp",
          "whisper_2x2_tp2d_slab", "whisper_2x2_fsdp_slab")
ONE = {"tp2d_1x1": case("1x1", "tp2d", dict(PAGED, **DRAFTS)),
       "fsdp_1x1": case("1x1", "fsdp", PAGED)}
ARCHS = {"gemma": "gemma-7b", "mixtral": "mixtral-8x7b",
         "mixtral_e3": "mixtral-8x7b", "jamba": "jamba-1.5-large-398b",
         "rwkv": "rwkv6-3b", "whisper": "whisper-medium"}
# The kinds that raised on a mesh before they were split over it; each
# now serves its reduced fp32 config in the config's own mode on (2, 2),
# held to the one-device engine (``test_refused_on_a_mesh``).
REFUSED = {"moe": "mixtral-8x7b", "mamba": "jamba-1.5-large-398b",
           "rwkv6": "rwkv6-3b", "encdec": "whisper-medium"}


def base_config(c, get_config):
    """The case's reduced config in fp32, from either package."""
    cfg = dataclasses.replace(get_config(ARCHS[c["model"]]).reduced(),
                              **dict(FP32, n_layers=3 if c["model"] == "jamba"
                                     else 2))  # jamba: its 3 positions
    if c["model"] == "gemma":
        cfg = dataclasses.replace(cfg, n_kv_heads=c["kv"])
    if c["model"] == "mixtral_e3":  # 3 experts: model 4 splits their units
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, n_experts=3))
    return cfg


def paged_gemma(c):
    """A case whose chunk logits are held (the scripted batch has 4 rows,
    so the one-slot cases take no part)."""
    return (c["model"] == "gemma" and c["knobs"].get("kv_layout") != "slab"
            and c["knobs"]["max_batch"] == 4)


def tree_key(c):
    return (c["model"], c["kv"])


def from_numpy(tree, cfg, **kw):
    """The family's weight bridge (``lm`` or ``encdec``)."""
    from repro_torch.models import encdec, lm

    return (encdec if cfg.is_encdec else lm).params_from_numpy(tree, cfg,
                                                               **kw)


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
def port_tokens(c, trees, record=None, **kw):
    """The case's greedy tokens a request; with ``record`` (a list), the
    logits of every program the engine runs (every row) appended to it,
    and the engine returned beside the tokens."""
    from repro_torch.configs import get_config
    from repro_torch.serve.engine import Engine, ServeConfig, \
        synthetic_requests
    from repro_torch.serve.scenarios import run_server

    cfg = base_config(c, get_config)
    params = from_numpy(trees[tree_key(c)], cfg, device="cpu")
    eng = Engine(cfg, params, ServeConfig(**c["knobs"]), **kw)
    if record is not None:
        recording(eng, record)
    report = run_server(eng, workload(synthetic_requests, cfg))
    tokens = [list(r.tokens) for r in sorted(report.requests,
                                             key=lambda r: r.id)]
    return tokens if record is None else (tokens, eng)


def recording(eng, record):
    """Wrap the engine's programs (the chunk program, or the slab's
    prefill and decode) so that each appends its logits of every row."""
    def keep(logits, place):
        if place is not None and place.rows is not None:
            logits = place.all_rows(logits)
        record.append(logits.float().numpy().copy())

    if hasattr(eng, "_decode"):
        pre, dec = eng._prefill, eng._decode

        def prefill(params, batch, last, place):
            out = pre(params, batch, last, place)
            keep(out[0], None)  # a prefill computes its request whole
            return out

        def decode(params, tok, slab, pos, place):
            out = dec(params, tok, slab, pos, place)
            keep(out[0], place)
            return out

        eng._prefill, eng._decode = prefill, decode
    else:
        chunk = eng.api.decode_chunk

        def decode_chunk(*a, place=None, **k):
            out = chunk(*a, place=place, **k)
            keep(out[0], place)
            return out

        eng.api.decode_chunk = decode_chunk


def cache_block_shapes(c, eng):
    """(the shapes of the rank's slab leaves, those ``cache_pspecs``
    gives the case's mesh) layer by layer."""
    import types

    from repro_torch.configs import get_config
    from repro_torch.dist.sharding import Rules
    from repro_torch.train.steps import ModelAPI, cache_pspecs

    cfg = base_config(c, get_config)
    knobs = c["knobs"]
    sizes = dict(zip(("data", "model"), MESHES[c["mesh"]]))
    rules = Rules(types.SimpleNamespace(shape=sizes,
                                        axis_names=("data", "model")),
                  c["mode"])
    full = ModelAPI(cfg).init_cache(knobs["max_batch"], knobs["max_len"],
                                    device="meta")
    specs = cache_pspecs(cfg, full, rules)
    slab = eng._slab
    if cfg.is_encdec:  # the self-attention caches, then the cross ones
        full, specs, slab = (x["self"] + x["cross"]
                             for x in (full, specs, slab))
    want = []
    for layer, sp in zip(full, specs):
        want.append({n: tuple(
            d // int(np.prod([sizes[a] for a in (e or ())]))
            for d, e in zip(t.shape, sp[n])) for n, t in layer.items()})
    got = [{n: tuple(t.shape) for n, t in layer.items()} for layer in slab]
    return got, want


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


def pinned_tokens(arch, mesh=None):
    """The greedy tokens of reduced ``arch`` in fp32, its config's own
    mode and layout, from the family's seeded weights (``init_lm``,
    ``init_encdec``): 3 requests of 3 tokens."""
    from repro_torch.configs import get_config
    from repro_torch.serve.engine import Engine, ServeConfig, \
        synthetic_requests
    from repro_torch.serve.scenarios import run_offline
    from repro_torch.train.steps import ModelAPI

    cfg = get_config(arch).reduced()
    cfg = dataclasses.replace(cfg, **dict(
        FP32, n_layers=max(2, len(cfg.block_pattern))))  # jamba: 3
    eng = Engine(cfg, ModelAPI(cfg).init(cfg, device="cpu"),
                 ServeConfig(max_batch=4, max_len=40), check_ranks=True,
                 mesh=mesh, device="cpu")
    report = run_offline(eng, synthetic_requests(cfg, n=3, tokens=3,
                                                 prompt_len=12, seed=4))
    return ("tokens", [list(r.tokens) for r in sorted(report.requests,
                                                       key=lambda r: r.id)])


def rank_cases(trees, meshes, cases):
    from repro_torch.dist.sharding import Rules

    out = {}
    for name, c in cases.items():  # every rank in one order
        try:
            mesh = meshes[c["mesh"]]
            rules = Rules(mesh, c["mode"])
            if name in LAYERS:
                rec = []
                tokens, eng = port_tokens(c, trees, rec, rules=rules,
                                          check_ranks=True)
                out[name] = {"tokens": tokens, "logits": rec}
                if c["knobs"].get("kv_layout") == "slab":
                    out[name]["cache"] = cache_block_shapes(c, eng)
                continue
            out[name] = {
                "tokens": port_tokens(c, trees, rules=rules,
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
    from repro_torch.launch.mesh import init_process_group, make_mesh

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
        try:
            refused[kind] = pinned_tokens(arch, mesh=meshes["2x2"])
        except Exception:  # recorded; the kind's test fails with it
            refused[kind] = ("error", traceback.format_exc())
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
                if name in LAYERS:
                    rec = []
                    one[name] = port_tokens(c, trees, rec, device="cpu")[0]
                    one[name, "logits"] = rec
                else:
                    one[name] = port_tokens(c, trees, device="cpu")
                if c["model"] == "gemma":
                    ref[name] = ref_tokens(c, trees)
            for kind, arch in REFUSED.items():
                one[kind] = pinned_tokens(arch)
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


@pytest.mark.parametrize("name", LAYERS)
def test_mesh_layer_logits_and_cache_blocks(runs, name):
    """The layers split over ``model``: every program's logits (every
    row) on every rank hold to the one-device engine's at rtol 1e-5,
    atol 1e-5, and the ranks' to each other bitwise; each rank's slab
    leaves have the block shapes of ``cache_pspecs``."""
    out, _, one, _, _ = runs
    got = _case([o[name] for o in out], name)
    want = one[name, "logits"]
    for g in got:
        assert len(g["logits"]) == len(want)
        for a, b in zip(g["logits"], got[0]["logits"]):
            assert np.array_equal(a, b), "ranks' logits differ"
        for a, w in zip(g["logits"], want):
            np.testing.assert_allclose(a, w, rtol=RTOL, atol=ATOL)
        if "cache" in g:
            have, blocks = g["cache"]
            assert have == blocks


@pytest.mark.parametrize("kind", list(REFUSED))
def test_refused_on_a_mesh(runs, kind):
    """The MoE, Mamba, RWKV-6 and enc-dec kinds that raised on a mesh
    now serve on (2, 2), in their configs' own (replicated) mode, with
    the one-device engine's tokens."""
    out, _, one, _, _ = runs
    for o in out:
        got = o["refused"][kind]
        assert got == one[kind], got
        assert got[0] == "tokens" and len(got[1]) == 3, got
