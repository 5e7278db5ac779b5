"""Serving launcher of the port.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-7b \
        [--full] [--tokens 16] [--batch 4] [--max-batch N] \
        [--prompt-len 16] [--page-size 16] [--prefill-chunk 8] \
        [--n-pages N] [--kv-dtype bfloat16|float32|int8|int4] \
        [--prefix-cache] [--spec-decode off|ngram] [--draft-len 4] \
        [--shared-prefix-len 0] [--n-templates 1] \
        [--scenario offline|server|single_stream|multi_stream] \
        [--arrival-rate 0.5] [--arrival-pattern poisson|bursty|diurnal] \
        [--query-size 2] [--query-interval 8] \
        [--slo-classes interactive,batch] [--temperature 0.8] [--seed 0] \
        [--serve-mode tp2d|fsdp|wus|replicated] [--mesh single|pod|multipod] \
        [--n-replicas N] [--routing prefix|least_loaded] \
        [--chaos kill|stall] [--chaos-step 8] [--stall-steps 12] \
        [--heartbeat-timeout 4] [--device cuda|cpu]

Builds ``--batch`` synthetic requests with the scenario's arrivals
(``serve.scenarios.make_trace``; prompts and arrivals byte-identical to
``repro.launch.serve``'s for the same seed), drives them through the
engine in the chosen MLPerf-Inference scenario, and prints the
throughput / latency summary, the prefix-cache, speculative and SLO
lines where they apply, and each request's tokens: greedy, or sampled
at ``--temperature`` with keys from ``--seed``. The attention-only
stacks (gemma-7b, yi-9b, qwen1.5-32b, command-r-35b, mixtral-8x7b,
grok-1-314b) serve from the paged pool by default (``--kv-layout slab``
for the slot slab, prompts padded to ``--prompt-len``), in the pool
dtype of their config unless ``--kv-dtype`` (qwen1.5-32b: int8), which
the summary line names (``kv=paged/int8``) when it is not the compute
dtype; jamba-1.5-large-398b, whose Mamba layers carry prompt state,
serves from the slab only, each prompt prefilled at its exact length.
whisper-medium (encoder-decoder) serves paged by default, each request
with its own encoder frames (one array per template with
``--shared-prefix-len``), encoded once at admission.
The model is ``reduced()`` unless ``--full`` (the published widths and
depth, which one card cannot hold for the larger models); weights are
random from ``--seed``. Runs on the card by default
and refuses to run without one unless ``--device cpu`` is given.

``--serve-mode`` serves on a mesh in that sharding mode (``tp2d``, the
weight-stationary serving mode, or ``fsdp``, ``wus``, ``replicated``;
:mod:`repro_torch.dist.serving`): on the 1 x 1 mesh of this process
with ``--mesh single``, or on the 16 x 16 (``pod``) or 2 x 16 x 16
(``multipod``) mesh, one process a rank over the default process group
(one already up, or one started from the launcher's ``RANK``,
``WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT``, as ``torchrun`` sets
them); a world size that is not the mesh's raises, and rank 0 prints.
``--mesh`` without ``--serve-mode`` takes the config's
``param_sharding``. The summary line then names ``mode=``.

``--n-replicas N`` serves the workload through a fleet of N engines
behind the prefix-affinity router (:mod:`repro_torch.fleet`), with one
seeded fault (``--chaos kill`` or ``stall`` at fleet step
``--chaos-step``; a stall lasts ``--stall-steps``, and a replica silent
for more than ``--heartbeat-timeout`` steps is declared dead), and
prints the fleet's summary and each request's tokens, which equal one
engine's.
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.configs import get_config, list_archs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", required=True, choices=list_archs())
    ap.add_argument("--full", action="store_true",
                    help="published dimensions (default: reduced())")
    ap.add_argument("--tokens", type=int, default=16,
                    help="tokens to generate per request")
    ap.add_argument("--batch", type=int, default=4,
                    help="number of requests in the workload")
    ap.add_argument("--max-batch", type=int, default=None,
                    help="concurrent KV-cache slots (default: --batch)")
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--scenario", default="offline",
                    choices=["offline", "server", "single_stream",
                             "multi_stream"])
    ap.add_argument("--arrival-rate", type=float, default=0.5,
                    help="server: mean requests per engine step")
    ap.add_argument("--arrival-pattern", default="poisson",
                    choices=["poisson", "bursty", "diurnal"])
    ap.add_argument("--query-size", type=int, default=2,
                    help="multi_stream: requests per query burst")
    ap.add_argument("--query-interval", type=int, default=8,
                    help="multi_stream: steps between query bursts")
    ap.add_argument("--slo-classes", default="",
                    help="comma-separated SLO classes to cycle requests "
                         "through (interactive|standard|batch)")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="0: greedy; > 0: sample with keys from --seed")
    ap.add_argument("--kv-layout", default="auto",
                    choices=["auto", "paged", "slab"],
                    help="KV layout: paged pool or slot slab (auto: paged "
                         "for attention-only stacks, slab otherwise)")
    ap.add_argument("--page-size", type=int, default=16,
                    help="tokens per KV page")
    ap.add_argument("--prefill-chunk", type=int, default=8,
                    help="prompt tokens fed per chunk step")
    ap.add_argument("--n-pages", type=int, default=None,
                    help="pool size in pages (default: slot parity)")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="share KV pages across requests (radix index)")
    ap.add_argument("--kv-dtype", default="",
                    choices=["", "bfloat16", "float32", "int8", "int4"],
                    help="KV pool dtype; int8/int4 quantize with per-row "
                         "scales (default: the model config's)")
    ap.add_argument("--spec-decode", default="off", choices=["off", "ngram"],
                    help="speculative decoding with n-gram drafts")
    ap.add_argument("--draft-len", type=int, default=4,
                    help="draft tokens proposed per row and step")
    ap.add_argument("--shared-prefix-len", type=int, default=0,
                    help="open every prompt with a template of this many "
                         "tokens (0 = off)")
    ap.add_argument("--n-templates", type=int, default=1,
                    help="distinct template prefixes to cycle")
    ap.add_argument("--serve-mode", default=None,
                    choices=["tp2d", "fsdp", "wus", "replicated"],
                    help="serve on a mesh in this sharding mode (default "
                         "with --mesh: the config's param_sharding)")
    ap.add_argument("--mesh", choices=["single", "pod", "multipod"],
                    default="single",
                    help="the 1 x 1 mesh of this process, or the 16 x 16 / "
                         "2 x 16 x 16 mesh (one process a rank)")
    ap.add_argument("--n-replicas", type=int, default=0,
                    help="fleet: engine replicas behind the prefix-affinity "
                         "router (0 = one engine)")
    ap.add_argument("--routing", default="prefix",
                    choices=["prefix", "least_loaded"],
                    help="fleet: consistent hash on the prefix-template key, "
                         "or least-loaded")
    ap.add_argument("--chaos", default="", choices=["", "kill", "stall"],
                    help="fleet: one seeded fault mid-run")
    ap.add_argument("--chaos-step", type=int, default=8,
                    help="fleet: the fleet step the fault fires at")
    ap.add_argument("--stall-steps", type=int, default=12,
                    help="fleet: fleet steps a stalled replica freezes")
    ap.add_argument("--heartbeat-timeout", type=int, default=4,
                    help="fleet: missed beats before a replica is dead")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu' (plain PyTorch path)")
    args = ap.parse_args(argv)
    if args.n_replicas < 0:
        ap.error("--n-replicas must be >= 0")

    import torch.distributed as dist

    from repro_torch.launch.mesh import single_device_mesh
    from repro_torch.launch.train import mesh_for

    mesh = mesh_for(args.mesh, args.device)
    if mesh is None and args.serve_mode:
        mesh = single_device_mesh(args.device)
    try:
        return _serve(args, mesh)
    finally:
        if mesh is not None and dist.is_initialized():
            dist.destroy_process_group()


def _serve(args, mesh) -> int:
    from repro_torch import resolve_device
    from repro_torch.dist.sharding import Rules
    from repro_torch.serve.engine import Engine, ServeConfig, synthetic_requests
    from repro_torch.serve.scenarios import make_trace, scenario_driver
    from repro_torch.train.steps import ModelAPI

    cfg = get_config(args.arch)
    if not args.full:
        cfg = cfg.reduced()
    # a vision frontend's media take positions ahead of each prompt
    n_media = cfg.n_media_tokens if cfg.frontend == "vision_patches" else 0
    scfg = ServeConfig(
        max_batch=args.batch if args.max_batch is None else args.max_batch,
        max_len=n_media + args.prompt_len + args.tokens,
        prefill_len=args.prompt_len,
        temperature=args.temperature,
        seed=args.seed,
        kv_layout=args.kv_layout,
        page_size=args.page_size,
        prefill_chunk=args.prefill_chunk,
        n_pages=args.n_pages,
        prefix_cache=args.prefix_cache,
        kv_dtype=args.kv_dtype,
        spec_decode=args.spec_decode,
        draft_len=args.draft_len,
    )
    device = resolve_device(args.device)
    params = ModelAPI(cfg).init(cfg, args.seed, device=device)
    rules = mode = None
    if mesh is not None:
        mode = args.serve_mode or cfg.param_sharding
        rules = Rules(mesh, mode)
    lead = mesh is None or mesh.device_mesh.get_rank() == 0
    slo_classes = tuple(c.strip() for c in args.slo_classes.split(",")
                        if c.strip())
    reqs = make_trace(
        cfg, scenario=args.scenario, n=args.batch, tokens=args.tokens,
        prompt_len=args.prompt_len, seed=args.seed, rate=args.arrival_rate,
        pattern=args.arrival_pattern, query_size=args.query_size,
        query_interval=args.query_interval, slo_classes=slo_classes,
        shared_prefix_len=args.shared_prefix_len,
        n_templates=args.n_templates)
    engines = [Engine(cfg, params, scfg, rules=rules, device=device)
               for _ in range(max(1, args.n_replicas))]
    for engine in engines:
        # warm-up: builds the kernel library outside the reported metrics
        scenario_driver("offline")(engine, synthetic_requests(
            cfg, n=min(2, scfg.max_batch), tokens=2,
            prompt_len=args.prompt_len, seed=args.seed + 1))
    engine = engines[0]
    kv_dtype = engine.cfg.kv_cache_dtype
    kv = engine.layout + (f"/{kv_dtype}" if args.kv_dtype
                          or kv_dtype != cfg.dtype else "")
    if args.n_replicas:
        return _fleet(args, engines, reqs, kv, lead, bool(slo_classes))
    report = scenario_driver(args.scenario)(engine, reqs)
    if not lead:
        return 0
    on = "" if mode is None else f"mode={mode}, "
    print(f"{args.arch} [{args.scenario}, {on}device={device}, "
          f"slots={scfg.max_batch}, kv={kv}]: {report.format()}")
    if report.prefix_hit_rate is not None:
        print(f"  prefix cache: hit_rate {report.prefix_hit_rate:.3f}, "
              f"{report.pages_shared} pages shared, "
              f"{report.prefill_tokens_skipped} prefill tokens skipped, "
              f"{report.cow_copies} cow copies")
    if report.spec_accept_rate is not None:
        print(f"  speculative: accept_rate {report.spec_accept_rate:.3f}, "
              f"{report.draft_tokens} draft tokens proposed")
    if slo_classes:
        print(f"  slo: goodput {report.slo_goodput:.3f}, "
              f"{report.slo_violations} violation(s)")
        for name, m in sorted(report.per_class().items()):
            print(f"    {name}: n={m['requests']} p99 {m['p99_ms']:.1f}ms "
                  f"ttft_p99 {m['ttft_p99_ms']:.1f}ms violations "
                  f"{m['violations']} goodput {m['goodput']:.3f}")
    for req in sorted(report.requests, key=lambda r: r.id):
        print(f"  req {req.id}: prompt {req.prompt_len} -> "
              f"{len(req.tokens)} tokens {req.tokens}")
    return 0


def _fleet(args, engines, reqs, kv: str, lead: bool, slo: bool) -> int:
    """The workload through a fleet of ``engines`` (arrivals on the fleet
    step clock), with the chaos of the flags; prints its summary."""
    from repro_torch.fleet import ChaosPlan, Fleet, FleetConfig

    chaos = ChaosPlan.from_spec(args.chaos, chaos_step=args.chaos_step,
                                stall_steps=args.stall_steps, seed=args.seed)
    fleet = Fleet(engines, FleetConfig(
        routing=args.routing, heartbeat_timeout=args.heartbeat_timeout),
        chaos)
    report = fleet.run(reqs)
    if not lead:
        return 0
    print(f"{args.arch} [fleet x{args.n_replicas}, routing={args.routing}"
          f"{', chaos=' + args.chaos if args.chaos else ''}, "
          f"slots={engines[0].scfg.max_batch}/replica, kv={kv}]: "
          f"{report.format()}")
    for name, m in sorted(report.per_class().items() if slo else ()):
        print(f"    {name}: n={m['requests']} p99 {m['p99_ms']:.1f}ms "
              f"violations {m['violations']} goodput {m['goodput']:.3f}")
    for req in sorted(report.merged.requests, key=lambda r: r.id):
        print(f"  req {req.id}: prompt {req.prompt_len} -> "
              f"{len(req.tokens)} tokens {req.tokens}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
