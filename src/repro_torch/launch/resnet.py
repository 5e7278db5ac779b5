"""MLPerf ResNet + LARS launcher of the port:
``python -m repro_torch.launch.resnet [--full] [--unscaled] [--steps N]
[--batch B] [--device cpu]``.

The counterpart of ``examples/mlperf_resnet_lars.py`` (the paper's Table 1
pipeline at small scale): ResNet v1.5, LARS in the scaled rule (Fig. 5)
or, with ``--unscaled``, the unscaled one (Fig. 6), under
``polynomial_warmup(0.25, 10, steps)``; synthetic images and labels drawn
from ``numpy.random.default_rng(0)`` as the example draws them (labels
``int(mean(image) * 25) % classes``); an eval set of 19 images that is not
a multiple of the eval batch of 8, zero-padded and masked (C4); and the
nested train-and-eval loop, which sweeps the eval set every 15 steps
and after the last, keeping the metric on the device until the sweep
ends. Prints ``LARS variant: ...``, one
``step i: loss=... acc=...`` line a step, the example's ``step i:
train_acc=... eval_top1=...`` line after each sweep, then ``done {last
record}``. ``RESNET_TINY`` at 16 x 16 by default; ``--full`` runs
``RESNET50`` at 224 x 224, 1000 classes, bf16 compute and fp32 masters.
Runs on the card, where every LARS leaf goes through the CUDA kernels;
``--device cpu`` runs the plain path.
"""
from __future__ import annotations

import argparse
import sys
import time
from typing import Dict, List

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.distributed_eval import masked_top1, pad_eval_dataset
from repro_torch.kernels import lars as lars_kernels
from repro_torch.models import resnet as R
from repro_torch.optim import Optimizer, lars, polynomial_warmup
from repro_torch.utils import tree_leaves

BASE_LR, WARMUP_STEPS = 0.25, 10
EVAL_IMAGES, EVAL_BATCH, EVAL_EVERY = 19, 8, 15


def synthetic_images(n: int, size: int, num_classes: int, rng):
    """``n`` NHWC fp32 images of ``size`` x ``size`` and int64 labels
    ``int(mean * 25) % num_classes``, as the example makes them."""
    imgs = rng.standard_normal((n, size, size, 3)).astype(np.float32)
    labels = (imgs.mean((1, 2, 3)) * 25).astype(np.int32) % num_classes
    return imgs, labels.astype(np.int64)


def make_train_step(cfg: R.ResNetConfig, optimizer: Optimizer):
    """``step(params, opt_state, batch) -> (params, opt_state, metrics)``:
    ``R.loss_fn``, its gradient by autograd and the optimizer's update, in
    place. The metrics (``loss``, ``acc``) stay on the device."""

    def step(params, opt_state, batch):
        leaves = tree_leaves(params)
        with torch.enable_grad():
            for w in leaves:
                w.requires_grad_(True)
            loss, aux = R.loss_fn(params, cfg, batch)
            grads = torch.autograd.grad(loss, leaves)
        params, opt_state = optimizer.update(grads, opt_state, params)
        return params, opt_state, {"loss": loss.detach(),
                                   "acc": aux["acc"].detach()}

    return step


def make_eval_step(cfg: R.ResNetConfig):
    """``eval_step(params, images, labels, mask) -> (correct, count)``,
    device tensors (C4: only the final sums leave the device)."""

    @torch.no_grad()
    def eval_step(params, images, labels, mask):
        return masked_top1(R.forward(params, cfg, images), labels, mask)

    return eval_step


def padded_eval_set(cfg: R.ResNetConfig, size: int, rng, device):
    """The eval set (19 images) zero-padded to a multiple of 8, as
    (images, labels, mask) batches on ``device``."""
    imgs, labels = synthetic_images(EVAL_IMAGES, size, cfg.num_classes, rng)
    padded, mask = pad_eval_dataset({"images": imgs, "labels": labels},
                                    global_batch=EVAL_BATCH)
    return [tuple(torch.from_numpy(a[i:i + EVAL_BATCH]).to(device)
                  for a in (padded["images"], padded["labels"], mask))
            for i in range(0, len(mask), EVAL_BATCH)]


def evaluate(cfg: R.ResNetConfig, params, eval_set):
    """One sweep of the padded eval set: (top-1 over the real examples,
    their count), read once at the end."""
    eval_step = make_eval_step(cfg)
    correct = count = 0
    for images, labels, mask in eval_set:
        c, n = eval_step(params, images, labels, mask)
        correct, count = correct + c, count + n
    count = float(count)
    return float(correct) / max(count, 1.0), int(count)


def train(cfg: R.ResNetConfig, params, optimizer: Optimizer, batch, *,
          steps: int, eval_set=None, device, log=print) -> List[Dict]:
    """Train ``params`` in place for ``steps`` steps on ``batch`` (a dict
    of device tensors), sweeping ``eval_set``, if given, every
    ``EVAL_EVERY`` steps and after the last. Returns one record per step: ``step``, ``loss``,
    ``acc``, ``step_ms`` (host clock, to the loss on the host: the step's
    work is done), the LARS kernels' launches in the step (0 on the CPU)
    and, after a sweep, ``eval_top1`` and ``eval_count``."""
    resolve_device(device)
    opt_state = optimizer.init(params)
    step_fn = make_train_step(cfg, optimizer)

    def norms():  # the norms kernel's launches, over one leaf or many
        return (lars_kernels.lars_norms_cuda.launches
                + lars_kernels.lars_norms_multi_cuda.launches)

    def updates():  # the update kernel's launches, over one leaf or many
        return (lars_kernels.lars_apply_cuda.launches
                + lars_kernels.lars_apply_multi_cuda.launches)

    history = []
    for i in range(steps):
        t0 = time.perf_counter()
        n0, a0 = norms(), updates()
        params, opt_state, m = step_fn(params, opt_state, batch)
        loss, acc = torch.stack([m["loss"], m["acc"]]).tolist()  # one read
        rec = dict(step=i + 1, loss=loss, acc=acc,
                   step_ms=(time.perf_counter() - t0) * 1e3,
                   norm_launches=norms() - n0,
                   update_launches=updates() - a0)
        log(f"step {i + 1}: loss={loss:.4f} acc={acc:.3f}")
        if eval_set is not None and (
                (i + 1) % EVAL_EVERY == 0 or i + 1 == steps):
            top1, count = evaluate(cfg, params, eval_set)
            rec.update(eval_top1=top1, eval_count=count)
            log(f"step {i + 1}: train_acc={acc:.3f} eval_top1={top1:.3f} "
                f"(over {count} real examples, padded to "
                f"{EVAL_BATCH * len(eval_set)})")
        history.append(rec)
    return history


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true",
                    help="RESNET50 at 224 x 224 (default RESNET_TINY at 16)")
    ap.add_argument("--unscaled", action="store_true",
                    help="use the Fig. 6 (You et al.) momentum rule")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain path)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg, size = (R.RESNET50, 224) if args.full else (R.RESNET_TINY, 16)
    params = R.init_resnet(cfg, seed=0, device=dev)
    rng = np.random.default_rng(0)
    imgs, labels = synthetic_images(args.batch, size, cfg.num_classes, rng)
    batch = {"images": torch.from_numpy(imgs).to(dev),
             "labels": torch.from_numpy(labels).to(dev)}
    eval_set = padded_eval_set(cfg, size, rng, dev)
    opt = lars(polynomial_warmup(BASE_LR, WARMUP_STEPS, args.steps),
               scaled_momentum=not args.unscaled)
    variant = "unscaled (Fig. 6)" if args.unscaled else "scaled (Fig. 5)"
    print(f"LARS variant: {variant}")
    history = train(cfg, params, opt, batch, steps=args.steps,
                    eval_set=eval_set, device=dev)
    print("done", history[-1] if history else "")
    return 0


if __name__ == "__main__":
    sys.exit(main())
