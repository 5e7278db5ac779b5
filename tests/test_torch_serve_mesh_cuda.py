"""The serving engine on a mesh, on the card only (marked ``cuda``,
skipped without one).

One card: ``Engine(..., rules=Rules(mesh, "tp2d"))`` on a 1 x 1
("data", "model") NCCL mesh against the one-device engine, reduced
gemma-7b widened to 8/2 heads of 64 (d 512), fp32, two layers, through
the paged kernel on a server stream with the prefix cache and n-gram
drafts: every collective over one rank is a copy and ``tp2d`` at data 1,
model 1 runs the one-device ops, so the greedy tokens must be bitwise
equal, with the same paged launches.

With four cards (skipped with fewer), four NCCL ranks (spawned, one a
card) serve the same model in ``tp2d`` on (2, 2) and (1, 4) meshes and
in ``fsdp`` on (2, 2): real collectives over NVLink, 4 or 2 query heads
a rank and the KV heads they read, the ``fsdp`` dim split over ``data``.
Each rank's greedy tokens must equal the one-card engine's (fp32: the
sums in another order move logits by ~1e-6, far below the gaps between
the top tokens here), and ``check_ranks`` raises if any rank's differ
from rank 0's. Then gemma-7b at full width (28 layers, bf16) serves
stream (a) in ``tp2d`` on (2, 2) and (1, 4) beside one card: every
rank's tokens (and one 8 x 8 chunk's logits) equal rank 0's, the paged
kernel runs in every layer of every chunk step on every rank, and each
rank's tokens/s and peak memory, the share of tokens equal to one
card's (bf16 sums in another order may flip a near tie, and a greedy
stream differs from there on) and the chunk's largest logit difference
from one card's are printed (``-s``).

Layers split over ``model`` on four cards (``test_split_layers_on_four_
cards``): jamba-1.5-large at full width cut to 3 layers (mamba + dense,
mamba + moe, attn + dense; ``chip_smoke.py``'s ``jamba_cut``) serves
stream (a) from the slab in ``tp2d`` on (2, 2) and (1, 4) (8192 or 4096
of the 16384 Mamba channels, 8 or 4 of the 16 experts a rank), and
rwkv6-3b cut to 4 layers in ``fsdp`` on (1, 4) (40 heads of 64, which 4
divides: 10 a rank). Every rank's tokens equal rank 0's. Each request's
prefill logits (its prompt alone, whatever the streams do after a near
tie) are held against the same cut's prefill in fp32 on one card from
the same bf16 weights widened, the function both bf16 runs round: the
mesh's largest distance from it, over that logit row's largest |logit|,
within twice one card's bf16 distance (``FLOOR_FACTOR``). Tokens/s, the
share of tokens equal to one card's, peak memory and the mamba_scan
launches (2 a prefill) are printed.

``python tests/test_torch_serve_mesh_cuda.py`` runs the four ranks'
small cases over gloo on the CPU (a rehearsal of the four-card test).
This file imports no JAX, so it runs on a card where JAX is missing."""
import dataclasses
import os
import pickle
import sys
import tempfile
import time
import traceback

import pytest
import torch

WORLD4 = 4
SMALL = dict(max_batch=4, max_len=40, page_size=4, prefill_chunk=4,
             prefix_cache=True, spec_decode="ngram", draft_len=3)
FOUR_CASES = {"tp2d_2x2": ((2, 2), "tp2d"), "tp2d_1x4": ((1, 4), "tp2d"),
              "fsdp_2x2": ((2, 2), "fsdp")}
FULL_MESHES = {"tp2d_2x2": (2, 2), "tp2d_1x4": (1, 4)}
PROMPT_LENS = (5, 128, 17, 96, 33, 64, 120, 9)  # stream (a)
NEW_TOKENS = 32


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def small_config():
    from repro_torch.configs import get_config

    return dataclasses.replace(
        get_config("gemma-7b").reduced(), d_model=512, n_heads=8,
        n_kv_heads=2, head_dim=64, d_ff=1024, n_layers=2, dtype="float32",
        kv_cache_dtype="float32")


def tokens_of(report):
    return [list(r.tokens) for r in sorted(report.requests,
                                           key=lambda r: r.id)]


def small_tokens(device, **kw):
    """Greedy tokens of the small model (seed 3's weights) on a server
    stream, and the paged launches of the run."""
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.models import lm
    from repro_torch.serve.engine import Engine, ServeConfig, \
        synthetic_requests
    from repro_torch.serve.scenarios import run_server

    cfg = small_config()
    params = lm.init_lm(cfg, 3, device=device)
    engine = Engine(cfg, params, ServeConfig(**SMALL), device=device, **kw)
    pa.reset_launches()
    report = run_server(engine, synthetic_requests(
        cfg, n=6, tokens=6, prompt_len=20, scenario="server", seed=3,
        shared_prefix_len=8, n_templates=2))
    return tokens_of(report), pa.paged_attention_cuda.launches


def chunk_logits(engine, device):
    """The engine's chunk program on one 8 x 8 prefill chunk (seeded
    tokens, a fresh 16-page pool): every row's fp32 logits on the host."""
    from repro_torch.models import lm

    B, C = 8, 8
    place = None if engine.plan is None else engine.plan.placement(rows=True)
    cache = (lm.init_paged_cache(engine.cfg, 16, 16, device=device)
             if engine.plan is None else engine.plan.init_paged_cache(16, 16))
    toks = torch.randint(0, engine.cfg.vocab, (B, C),
                         generator=torch.Generator().manual_seed(7))
    with torch.inference_mode():
        logits = lm.decode_chunk(
            engine.params, engine.cfg, toks.to(device), cache,
            torch.arange(B, dtype=torch.int32, device=device)[:, None],
            torch.zeros(B, dtype=torch.int32, device=device),
            torch.full((B,), C, dtype=torch.int32, device=device),
            place=place)[0]
        if place is not None:
            logits = place.all_rows(logits)
    return logits.float().cpu()


def full_stream(device, **kw):
    """Full-width gemma-7b (seed 0's bf16 weights) on stream (a):
    (tokens, tokens/s, paged launches, chunk steps, peak GiB, one chunk
    step's logits)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.models import lm
    from repro_torch.serve.engine import Engine, ServeConfig, \
        synthetic_requests
    from repro_torch.serve.scenarios import run_offline

    cfg = get_config("gemma-7b")
    params = lm.init_lm(cfg, 0, device=device)
    engine = Engine(cfg, params, ServeConfig(
        max_batch=8, max_len=max(PROMPT_LENS) + NEW_TOKENS, page_size=16,
        prefill_chunk=8), device=device, **kw)
    del params  # the engine keeps the rank's blocks
    torch.cuda.empty_cache()
    run_offline(engine, synthetic_requests(cfg, n=2, tokens=2, prompt_len=8,
                                           seed=1))
    torch.cuda.reset_peak_memory_stats(device)
    pa.reset_launches()
    report = run_offline(engine, synthetic_requests(
        cfg, n=8, tokens=NEW_TOKENS, prompt_len=max(PROMPT_LENS), seed=0,
        prompt_lens=PROMPT_LENS))
    torch.cuda.synchronize(device)
    out = (tokens_of(report), report.tokens_per_s,
           pa.paged_attention_cuda.launches, len(report.steps),
           torch.cuda.max_memory_allocated(device) / 2**30,
           chunk_logits(engine, device))
    del engine
    torch.cuda.empty_cache()
    return out


@pytest.mark.cuda
def test_tp2d_on_one_card_is_the_one_device_engine(cuda_device):
    import torch.distributed as dist

    from repro_torch.dist.sharding import Rules
    from repro_torch.launch.mesh import single_device_mesh

    want, n = small_tokens(cuda_device)
    mesh = single_device_mesh("cuda")
    try:
        got, m = small_tokens(cuda_device, rules=Rules(mesh, "tp2d"),
                              check_ranks=True)
    finally:
        dist.destroy_process_group()
    assert got == want and m == n > 0


LAYER_CASES = {"jamba_tp2d_2x2": ("jamba", (2, 2), "tp2d"),
               "jamba_tp2d_1x4": ("jamba", (1, 4), "tp2d"),
               "rwkv_fsdp_1x4": ("rwkv", (1, 4), "fsdp")}
# A mesh's bf16 prefill logits against the fp32 prefill: within this
# many times one card's bf16 distance from it. (The first four-card
# probe held them to one card's bf16 logits within 5e-2 of its largest
# |logit| instead and read 0.0516 on one of jamba's 8 requests in
# (2, 2), 0.013-0.028 on the others: two bf16 roundings of one function
# hold nothing to a fixed share without the floor they round from.)
FLOOR_FACTOR = 2.0


def layer_config(model):
    """jamba-1.5-large cut to its 3 kinds of layer (pattern positions 0,
    1 and 4), or rwkv6-3b cut to 4 layers; every width published."""
    from repro_torch.configs import get_config

    if model == "jamba":
        cfg = get_config("jamba-1.5-large-398b")
        pat = cfg.block_pattern
        return dataclasses.replace(cfg, n_layers=3,
                                   block_pattern=(pat[0], pat[1], pat[4]))
    return dataclasses.replace(get_config("rwkv6-3b"), n_layers=4)


def layer_stream(model, device, **kw):
    """The cut (seed 0's bf16 weights) on stream (a) from the slab:
    (tokens, tokens/s, mamba_scan launches, peak GiB, each request's
    prefill logits (fp32, host), wall s)."""
    from repro_torch.kernels import mamba as mk
    from repro_torch.models import lm
    from repro_torch.serve.engine import Engine, ServeConfig, \
        synthetic_requests
    from repro_torch.serve.scenarios import run_offline

    t0 = time.perf_counter()
    cfg = layer_config(model)
    params = lm.init_lm(cfg, 0, device=device)
    engine = Engine(cfg, params, ServeConfig(
        max_batch=8, max_len=max(PROMPT_LENS) + NEW_TOKENS,
        kv_layout="slab"), device=device, **kw)
    del params  # the engine keeps the rank's blocks
    torch.cuda.empty_cache()
    run_offline(engine, synthetic_requests(cfg, n=2, tokens=2, prompt_len=8,
                                           seed=1))
    prefill, logits = engine._prefill, []

    def keep(*a):
        out = prefill(*a)
        logits.append(out[0].float().cpu())
        return out

    engine._prefill = keep
    torch.cuda.reset_peak_memory_stats(device)
    mk.reset_launches()
    report = run_offline(engine, synthetic_requests(
        cfg, n=8, tokens=NEW_TOKENS, prompt_len=max(PROMPT_LENS), seed=0,
        prompt_lens=PROMPT_LENS))
    torch.cuda.synchronize(device)
    out = (tokens_of(report), report.tokens_per_s,
           mk.mamba_scan_cuda.launches,
           torch.cuda.max_memory_allocated(device) / 2**30, logits,
           time.perf_counter() - t0)
    del engine
    torch.cuda.empty_cache()
    return out


def fp32_prefills(model, device):
    """Each request of stream (a) prefilled alone in fp32 on one card
    from seed 0's bf16 weights widened (leaf by leaf, so the bf16 tree
    is freed as it goes): the logits (host) both bf16 runs round."""
    from repro_torch.models import lm
    from repro_torch.serve.engine import synthetic_requests

    cfg = layer_config(model)
    params = lm.init_lm(cfg, 0, device=device)

    def widen(tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                widen(v)
            elif isinstance(v, list):
                for x in v:
                    widen(x)
            else:
                tree[k] = v.float()

    widen(params)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    out = []
    with torch.inference_mode():
        for r in synthetic_requests(cfg, n=8, tokens=NEW_TOKENS,
                                    prompt_len=max(PROMPT_LENS), seed=0,
                                    prompt_lens=PROMPT_LENS):
            toks = torch.tensor([list(r.prompt)], device=device)
            out.append(lm.prefill(params, cfg32, toks)[0].float().cpu())
    del params
    torch.cuda.empty_cache()
    return out


def distance(got, want):
    """Each request's max |got - want| over its row's max |want|."""
    return [(a - b).abs().max().item() / b.abs().max().item()
            for a, b in zip(got, want)]


def four_rank_main(rank, store, out_dir, device_type="cuda", full=True,
                   layers=False):
    """One rank of the four: the small cases, then (``full``) gemma-7b at
    full width in tp2d on each of ``FULL_MESHES``; or (``layers``) only
    ``LAYER_CASES``; pickled."""
    import torch.distributed as dist

    from repro_torch.dist.sharding import Rules
    from repro_torch.launch.mesh import init_process_group, make_mesh

    torch.set_num_threads(1)
    init_process_group(device=device_type, rank=rank, world_size=WORLD4,
                       store_path=store)
    dev = (torch.device("cuda", torch.cuda.current_device())
           if device_type == "cuda" else torch.device("cpu"))
    meshes = {s: make_mesh(s, ("data", "model"), device=device_type)
              for s in sorted({s for s, _ in FOUR_CASES.values()})}
    out = {}
    try:
        for name, (model, shape, mode) in (LAYER_CASES.items() if layers
                                           else ()):
            try:
                out[name] = layer_stream(model, dev,
                                         rules=Rules(meshes[shape], mode),
                                         check_ranks=True)
            except Exception:  # recorded; the test fails with it
                out[name] = {"error": traceback.format_exc()}
        for name, (shape, mode) in (() if layers else FOUR_CASES.items()):
            try:
                out[name] = small_tokens(dev, rules=Rules(meshes[shape], mode),
                                         check_ranks=True)
            except Exception:  # recorded; the test fails with it
                out[name] = {"error": traceback.format_exc()}
        for name, shape in (FULL_MESHES.items() if full else ()):
            try:
                t0 = time.perf_counter()
                out["full_" + name] = full_stream(
                    dev, rules=Rules(meshes[shape], "tp2d"),
                    check_ranks=True) + (time.perf_counter() - t0,)
            except Exception:
                out["full_" + name] = {"error": traceback.format_exc()}
    finally:
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
        dist.destroy_process_group()


def launch_four(out_dir, device_type="cuda", full=True, timeout=600,
                layers=False):
    """The four ranks as spawned processes; returns their results."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    store = os.path.join(out_dir, "store")
    procs = [ctx.Process(target=four_rank_main,
                         args=(r, store, out_dir, device_type, full, layers))
             for r in range(WORLD4)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=timeout)
    for p in procs:
        if p.is_alive():
            p.kill()
    codes = [p.exitcode for p in procs]
    assert codes == [0] * WORLD4, f"rank exit codes {codes}"
    out = []
    for r in range(WORLD4):
        with open(os.path.join(out_dir, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def hold_small(out, want, kernel=True):
    """Every rank's tokens of every small case equal ``want``; on the
    card (``kernel``) the paged kernel ran."""
    for name in FOUR_CASES:
        for r, o in enumerate(out):
            got = o[name]
            assert not isinstance(got, dict), f"rank {r}, {name}:\n" \
                                              f"{got['error']}"
            assert got[0] == want, (name, r)
            assert got[1] > 0 or not kernel, (name, r)


@pytest.mark.cuda
def test_serving_on_four_cards(cuda_device):
    if torch.cuda.device_count() < WORLD4:
        pytest.skip(f"needs {WORLD4} cards; this machine has "
                    f"{torch.cuda.device_count()}")
    with tempfile.TemporaryDirectory() as tmp:
        out = launch_four(tmp)
    want, _ = small_tokens(cuda_device)
    hold_small(out, want)
    one = full_stream(cuda_device)
    print(f"gemma-7b full width, stream (a), one card: {one[1]:.1f} "
          f"tokens/s, {one[2]} paged launches in {one[3]} chunk steps, "
          f"peak {one[4]:.2f} GiB")
    for name in FULL_MESHES:
        got = [o["full_" + name] for o in out]
        for r, g in enumerate(got):
            assert not isinstance(g, dict), f"rank {r}, {name}:\n" \
                                            f"{g['error']}"
            toks, tps, launches, steps, peak, logits, wall = g
            assert toks == got[0][0], (name, r)
            assert torch.equal(logits, got[0][5]), (name, r)
            assert launches == 28 * steps > 0, (name, r, launches, steps)
            assert all(0 <= t < 256000 for row in toks for t in row)
            print(f"  {name}, rank {r}: {tps:.1f} tokens/s, {launches} "
                  f"paged launches in {steps} chunk steps, peak "
                  f"{peak:.2f} GiB, wall {wall:.1f} s")
        pairs = [(a, b) for ra, rb in zip(got[0][0], one[0])
                 for a, b in zip(ra, rb)]
        first = [next((i for i, (a, b) in enumerate(zip(ra, rb)) if a != b),
                      None) for ra, rb in zip(got[0][0], one[0])]
        err = (got[0][5] - one[5]).abs().max().item()
        scale = one[5].abs().max().item()
        same = (got[0][5].argmax(-1) == one[5].argmax(-1)).float().mean()
        print(f"  {name}: tokens equal to one card's at "
              f"{100 * sum(a == b for a, b in pairs) / len(pairs):.1f}% of "
              f"positions, each request's first difference at {first}; "
              f"one 8 x 8 chunk's logits: max |mesh - one card| {err:.4g} "
              f"of max |logit| {scale:.4g}, argmax equal in "
              f"{100 * same:.0f}% of rows")


@pytest.mark.cuda
def test_split_layers_on_four_cards(cuda_device):
    if torch.cuda.device_count() < WORLD4:
        pytest.skip(f"needs {WORLD4} cards; this machine has "
                    f"{torch.cuda.device_count()}")
    with tempfile.TemporaryDirectory() as tmp:
        out = launch_four(tmp, full=False, layers=True)
    ones, refs, bad = {}, {}, []
    for name, (model, shape, mode) in LAYER_CASES.items():
        if model not in ones:
            ones[model] = layer_stream(model, cuda_device)
            refs[model] = fp32_prefills(model, cuda_device)
            one = ones[model]
            print(f"{model} cut, stream (a), one card: {one[1]:.1f} "
                  f"tokens/s, mamba_scan launches {one[2]}, peak "
                  f"{one[3]:.2f} GiB, wall {one[5]:.1f} s")
        one, ref = ones[model], refs[model]
        got = [o[name] for o in out]
        for r, g in enumerate(got):
            assert not isinstance(g, dict), f"rank {r}, {name}:\n" \
                                            f"{g['error']}"
            toks, tps, launches, peak, logits, wall = g
            assert toks == got[0][0], (name, r)
            assert launches == one[2], (name, r, launches, one[2])
            print(f"  {name}, rank {r}: {tps:.1f} tokens/s, mamba_scan "
                  f"launches {launches}, peak {peak:.2f} GiB, wall "
                  f"{wall:.1f} s")
        pairs = [(a, b) for ra, rb in zip(got[0][0], one[0])
                 for a, b in zip(ra, rb)]
        mesh, floor = distance(got[0][4], ref), distance(one[4], ref)
        print(f"  {name}: tokens equal to one card's at "
              f"{100 * sum(a == b for a, b in pairs) / len(pairs):.1f}% of "
              f"positions; prefill logits' distance from fp32 (max |diff| "
              f"over max |logit|): mesh {max(mesh):.3g} "
              f"{[round(e, 4) for e in mesh]}, one card {max(floor):.3g} "
              f"{[round(e, 4) for e in floor]}; mesh from one card "
              f"{max(distance(got[0][4], one[4])):.3g}")
        if not (len(mesh) == len(PROMPT_LENS)
                and max(mesh) <= FLOOR_FACTOR * max(floor)):
            bad.append(name)
    assert not bad, bad


if __name__ == "__main__":  # the four ranks' small cases over gloo
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))), "src"))
    with tempfile.TemporaryDirectory() as tmp:
        res = launch_four(tmp, device_type="cpu", full=False)
    hold_small(res, small_tokens(torch.device("cpu"))[0], kernel=False)
    print("four gloo ranks: every case's tokens equal one device's")
