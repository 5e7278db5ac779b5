"""``python -m repro_torch run`` — the one CLI in front of every mode.

    python -m repro_torch run --spec runs/serve_prefix.toml --device cpu
    python -m repro_torch run --arch gemma-7b --mode train --full \
        --set model.n_layers=8 --set trainer.seq=2048
    python -m repro_torch run --spec runs/serve_fleet.toml --mode dryrun

Resolution order (later wins): spec file -> dedicated flags
(--arch/--mode/--mesh/--scenario/--seed/--reduced|--full) -> --set
assignments; the spec resolved is the one ``python -m repro run``
resolves from the same arguments. ``--device`` (default ``cuda``, which
refuses to run without a card; ``cpu`` runs the plain PyTorch path) is
where the run happens. ``--profile FILE`` writes the kernel launch
counts and the wall time of the run's measured part to FILE as JSON,
``--trace`` adds a profiler trace of it (each kernel's launches and
device time).
Exit code 2 for an unknown command, a spec error or a mode the port
does not run yet (``--mode bench``, the compiling dry run).
"""
from __future__ import annotations

import argparse
import dataclasses
import sys

from repro_torch.run.overrides import SpecError, apply_assignments
from repro_torch.run.spec import MESHES, MODES, SCENARIOS, RunSpec
from repro_torch.run.specfile import load_spec_file

_USAGE = ("usage: python -m repro_torch run [--spec F] [--arch A] "
          "[--mode M] ...")


def build_spec(args) -> RunSpec:
    spec = load_spec_file(args.spec) if args.spec else RunSpec()
    flags = {
        name: getattr(args, name)
        for name in ("arch", "mode", "mesh", "scenario", "seed", "reduced")
        if getattr(args, name) is not None
    }
    if flags:
        spec = dataclasses.replace(spec, **flags)
    if getattr(args, "metrics_out", None):
        spec = dataclasses.replace(
            spec, trainer=dataclasses.replace(
                spec.trainer, metrics_out=args.metrics_out))
    return apply_assignments(spec, args.set or [])


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] != "run":
        print(f"{_USAGE}\nunknown command "
              f"{argv[0] if argv else '(none)'!r}; commands: run",
              file=sys.stderr)
        return 2

    ap = argparse.ArgumentParser(prog="repro_torch run",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--spec", default=None,
                    help="JSON/TOML run-spec file (runs/*.json)")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--mode", default=None, choices=MODES)
    ap.add_argument("--mesh", default=None, choices=MESHES)
    ap.add_argument("--scenario", default=None,
                    choices=list(SCENARIOS[1:]))
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--reduced", dest="reduced", action="store_true",
                    default=None, help="smoke-scale config (the default)")
    ap.add_argument("--full", dest="reduced", action="store_false",
                    help="published dimensions")
    ap.add_argument("--metrics-out", default=None, metavar="FILE",
                    help="stream every fit record to FILE as JSONL "
                         "(shorthand for --set trainer.metrics_out=FILE)")
    ap.add_argument("--set", action="append", metavar="KEY=VALUE",
                    help="dotted-key override, e.g. trainer.total_steps=50")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu' (plain PyTorch path)")
    ap.add_argument("--profile", default=None, metavar="FILE",
                    help="write the kernel launch counts and the wall time "
                         "of the run's measured part to FILE (JSON)")
    ap.add_argument("--trace", action="store_true",
                    help="with --profile: trace the measured part with "
                         "torch.profiler and add its kernels to FILE")
    args = ap.parse_args(argv[1:])
    if args.trace and not args.profile:
        ap.error("--trace needs --profile FILE")

    try:
        spec = build_spec(args)
    except SpecError as e:
        print(f"spec error: {e}", file=sys.stderr)
        return 2

    from repro_torch.run.dispatch import run_spec

    # run_spec stores the structured result in dispatch.LAST_RESULT for
    # in-process callers (tests, notebooks) driving the CLI.
    try:
        result = run_spec(spec, device=args.device, profile=args.profile,
                          trace=args.trace)
    except NotImplementedError as e:
        print(f"not implemented: {e}", file=sys.stderr)
        return 2
    return int(result.get("exit_code", 0))


if __name__ == "__main__":
    sys.exit(main())
