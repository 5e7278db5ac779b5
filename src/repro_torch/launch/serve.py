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

The CLI is a shim over the run layer: its flags build a
``RunSpec(mode="serve")`` and ``repro_torch.run.dispatch.run_spec`` runs
it, as ``python -m repro_torch run --mode serve`` does.
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.configs import list_archs


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

    from repro_torch.run import (
        FleetSection,
        KVCacheSpec,
        RunSpec,
        ServeSection,
        SpecError,
    )
    from repro_torch.run.dispatch import run_spec

    try:
        spec = RunSpec(
            arch=args.arch,
            mode="serve",
            mesh=args.mesh,
            scenario=args.scenario,
            reduced=not args.full,
            seed=args.seed,
            serve=ServeSection(
                tokens=args.tokens,
                batch=args.batch,
                max_batch=args.max_batch,
                prompt_len=args.prompt_len,
                temperature=args.temperature,
                serve_mode=args.serve_mode or "",
                kv=KVCacheSpec(
                    layout=args.kv_layout,
                    page_size=args.page_size,
                    prefill_chunk=args.prefill_chunk,
                    n_pages=args.n_pages,
                    prefix_cache=args.prefix_cache,
                    dtype=args.kv_dtype,
                    spec_decode=args.spec_decode,
                    draft_len=args.draft_len,
                ),
                shared_prefix_len=args.shared_prefix_len,
                n_templates=args.n_templates,
                arrival_rate=args.arrival_rate,
                arrival_pattern=args.arrival_pattern,
                query_size=args.query_size,
                query_interval=args.query_interval,
                slo_classes=tuple(c.strip() for c in
                                  args.slo_classes.split(",") if c.strip()),
            ),
            fleet=FleetSection(
                n_replicas=args.n_replicas,
                routing=args.routing,
                chaos=args.chaos,
                chaos_step=args.chaos_step,
                stall_steps=args.stall_steps,
                heartbeat_timeout=args.heartbeat_timeout,
            ),
        )
    except SpecError as e:
        ap.error(str(e))
    return run_spec(spec, device=args.device)["exit_code"]


if __name__ == "__main__":
    sys.exit(main())
