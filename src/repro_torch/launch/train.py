"""Training launcher of the port:
``python -m repro_torch.launch.train --arch gemma-7b ...``.

Runs the reduced config by default (``--full`` for the published
widths) on the card; an enc-dec arch (whisper-medium) trains on
``--seq`` target tokens beside its config's encoder frames; ``--device cpu`` runs the plain PyTorch path. The
flags and console output are those of ``python -m repro.launch.train``:
a ``step N: loss=... nll=...`` line every ``max(1, steps // 10)``
steps, eval lines with ``--eval-every``, then ``done {last record}``.
``--checkpoint-every N`` saves ``--checkpoint-dir``/step_<N> every N
steps and at the end; ``--resume DIR`` restores a checkpoint and runs
on to the global ``--steps``, skipping the batches the checkpointed
steps consumed, so an interrupted and resumed run equals an
uninterrupted one step for step.

``--mesh pod`` (16 x 16, 256 ranks) and ``--mesh multipod`` (2 x 16 x
16, 512) train through the sharded trainer in the config's
``param_sharding`` mode, one process a rank, over the default process
group: one already up, or one started from the launcher's environment
(``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``, as
``torchrun`` sets them). A world size that is not the mesh's raises
before any work; rank 0 prints. ``--mesh single`` is one device, no
mesh.

The CLI is a shim over the run layer: its flags build a
``RunSpec(mode="train")`` and ``repro_torch.run.dispatch.run_spec`` runs
it, as ``python -m repro_torch run --mode train`` does.
"""
from __future__ import annotations

import argparse
import sys


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--reduced", action="store_true", default=True,
                    help="use the smoke-scale variant (default)")
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--mesh", choices=["single", "pod", "multipod"],
                    default="single",
                    help="one device, or the 16 x 16 / 2 x 16 x 16 mesh "
                         "(one process a rank)")
    ap.add_argument("--eval-every", type=int, default=0)
    ap.add_argument("--checkpoint-every", type=int, default=0)
    ap.add_argument("--checkpoint-dir", default="/tmp/repro_ckpt")
    ap.add_argument("--resume", default=None, metavar="CKPT_DIR",
                    help="resume from a checkpoint dir (a run dir with "
                         "step_<N> subdirs, or one step_<N> dir); --steps "
                         "still means global steps")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain path)")
    args = ap.parse_args(argv)

    from repro_torch.run import RunSpec, TrainerSection
    from repro_torch.run.dispatch import run_spec

    spec = RunSpec(
        arch=args.arch,
        mode="train",
        mesh=args.mesh,
        reduced=args.reduced,
        trainer=TrainerSection(
            total_steps=args.steps,
            batch=args.batch,
            seq=args.seq,
            eval_every=args.eval_every,
            checkpoint_every=args.checkpoint_every,
            checkpoint_dir=args.checkpoint_dir,
            log_every=max(1, args.steps // 10),
            resume=args.resume or "",
        ),
    )
    return run_spec(spec, device=args.device)["exit_code"]


if __name__ == "__main__":
    sys.exit(main())
