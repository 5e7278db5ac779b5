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
"""
from __future__ import annotations

import argparse
import itertools
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
    ap.add_argument("--mesh", choices=["single"], default="single",
                    help="one device; pod meshes are not ported")
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

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import (
        synthetic_eval_set,
        synthetic_lm_batches,
    )
    from repro_torch.train import Trainer, TrainerConfig

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    tcfg = TrainerConfig(total_steps=args.steps, eval_every=args.eval_every,
                         checkpoint_every=args.checkpoint_every,
                         checkpoint_dir=args.checkpoint_dir,
                         log_every=max(1, args.steps // 10))
    trainer = Trainer(cfg, tcfg, device=args.device)
    start = trainer.resume(args.resume) if args.resume else 0
    # one stream for the whole run: a resumed run skips what its
    # checkpointed steps consumed
    batches = itertools.islice(
        synthetic_lm_batches(cfg, batch=args.batch, seq=args.seq,
                             steps=args.steps), start, None)
    eval_fn = None
    if args.eval_every:
        eval_fn = synthetic_eval_set(cfg, batch=args.batch, seq=args.seq)
    history = trainer.fit(batches, eval_fn)
    print("done", history[-1] if history else "")
    return 0


if __name__ == "__main__":
    sys.exit(main())
