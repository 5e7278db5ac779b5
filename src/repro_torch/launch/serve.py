"""Serving launcher of the port.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-7b \
        [--full] [--tokens 16] [--batch 4] [--max-batch N] \
        [--prompt-len 16] [--page-size 16] [--prefill-chunk 8] \
        [--n-pages N] [--seed 0] [--device cuda|cpu]

Builds ``--batch`` synthetic requests (prompts byte-identical to
``repro.launch.serve``'s for the same seed), serves them offline through
the paged engine and prints the throughput / latency summary and each
request's greedy tokens. The model is ``reduced()`` unless ``--full``;
weights are random from ``--seed``. Runs on the card by default and
refuses to run without one unless ``--device cpu`` is given.
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
    ap.add_argument("--page-size", type=int, default=16,
                    help="tokens per KV page")
    ap.add_argument("--prefill-chunk", type=int, default=8,
                    help="prompt tokens fed per chunk step")
    ap.add_argument("--n-pages", type=int, default=None,
                    help="pool size in pages (default: slot parity)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu' (plain PyTorch path)")
    args = ap.parse_args(argv)

    from repro_torch import resolve_device
    from repro_torch.models import lm
    from repro_torch.serve.engine import Engine, ServeConfig, synthetic_requests
    from repro_torch.serve.scenarios import run_offline

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if not args.full:
        cfg = cfg.reduced()
    params = lm.init_lm(cfg, args.seed, device=device)
    scfg = ServeConfig(
        max_batch=args.batch if args.max_batch is None else args.max_batch,
        max_len=args.prompt_len + args.tokens,
        page_size=args.page_size,
        prefill_chunk=args.prefill_chunk,
        n_pages=args.n_pages,
    )
    reqs = synthetic_requests(cfg, n=args.batch, tokens=args.tokens,
                              prompt_len=args.prompt_len, seed=args.seed)
    engine = Engine(cfg, params, scfg, device=device)
    # warm-up: builds the kernel library outside the reported metrics
    run_offline(engine, synthetic_requests(
        cfg, n=min(2, scfg.max_batch), tokens=2, prompt_len=args.prompt_len,
        seed=args.seed + 1))
    report = run_offline(engine, reqs)
    print(f"{args.arch} [offline, device={device}, slots={scfg.max_batch}, "
          f"kv=paged]: {report.format()}")
    for req in sorted(report.requests, key=lambda r: r.id):
        print(f"  req {req.id}: prompt {req.prompt_len} -> "
              f"{len(req.tokens)} tokens {req.tokens}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
