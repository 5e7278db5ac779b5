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
        [--device cuda|cpu]

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
``--serve-mode`` and the fleet flags are not ported and raise
``NotImplementedError``.
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
                    help="not ported (sharded serving, ROADMAP.md item "
                         "'distribution, fleet and bench')")
    ap.add_argument("--n-replicas", type=int, default=0,
                    help="not ported (the fleet, ROADMAP.md item "
                         "'distribution, fleet and bench')")
    ap.add_argument("--routing", default=None, help="not ported (fleet)")
    ap.add_argument("--chaos", default=None, help="not ported (fleet)")
    ap.add_argument("--chaos-step", type=int, default=None,
                    help="not ported (fleet)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu' (plain PyTorch path)")
    args = ap.parse_args(argv)
    for flag, value in (("--serve-mode", args.serve_mode),
                        ("--n-replicas", args.n_replicas or None),
                        ("--routing", args.routing), ("--chaos", args.chaos),
                        ("--chaos-step", args.chaos_step)):
        if value is not None:
            raise NotImplementedError(
                f"{flag} is not ported yet (sharded serving and the fleet "
                f"are the ROADMAP.md item 'distribution, fleet and "
                f"bench')")

    from repro_torch import resolve_device
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
    slo_classes = tuple(c.strip() for c in args.slo_classes.split(",")
                        if c.strip())
    reqs = make_trace(
        cfg, scenario=args.scenario, n=args.batch, tokens=args.tokens,
        prompt_len=args.prompt_len, seed=args.seed, rate=args.arrival_rate,
        pattern=args.arrival_pattern, query_size=args.query_size,
        query_interval=args.query_interval, slo_classes=slo_classes,
        shared_prefix_len=args.shared_prefix_len,
        n_templates=args.n_templates)
    engine = Engine(cfg, params, scfg, device=device)
    # warm-up: builds the kernel library outside the reported metrics
    scenario_driver("offline")(engine, synthetic_requests(
        cfg, n=min(2, scfg.max_batch), tokens=2, prompt_len=args.prompt_len,
        seed=args.seed + 1))
    report = scenario_driver(args.scenario)(engine, reqs)
    kv_dtype = engine.cfg.kv_cache_dtype
    kv = engine.layout + (f"/{kv_dtype}" if args.kv_dtype
                          or kv_dtype != cfg.dtype else "")
    print(f"{args.arch} [{args.scenario}, device={device}, "
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


if __name__ == "__main__":
    sys.exit(main())
