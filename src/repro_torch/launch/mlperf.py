"""Trainer of the other MLPerf-0.6 models of the port:
``python -m repro_torch.launch.mlperf --model {transformer,ssd,maskrcnn}
[--full] [--steps N] [--batch B] [--seq S] [--device cpu]``.

The counterpart of ``benchmarks/fig9_step_times.py``'s train step and
batches: weights from seed 0 (fp32 masters), a synthetic batch drawn
from ``numpy.random.default_rng(0)`` in the order fig9 and
``tests/test_models_mlperf.py`` draw it, and a step that is the loss's
gradient (autograd; the Transformer's attention through the flash
kernels on the card) followed by ``adam(constant(1e-3))``, the update
written into the weights and moments in place. The same batch every
step, as fig9 times it. Prints one ``step i: loss=... step_ms=...`` line
a step, then ``done {last record}``. The tiny configs by default;
``--full`` trains the published ones (``TRANSFORMER_BIG``,
``SSDConfig()`` at 300 x 300, ``MaskRCNNConfig()`` at 128 x 128), bf16
compute over fp32 masters. Runs on the card; ``--device cpu`` runs the
plain path.
"""
from __future__ import annotations

import argparse
import sys
import time
from typing import Callable, Dict, List

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import maskrcnn as MR
from repro_torch.models import ssd as SSD
from repro_torch.models import transformer_mlperf as TM
from repro_torch.optim import Optimizer, adam, constant
from repro_torch.utils import tree_leaves

# model -> (published config, tiny config, init, loss)
_MODELS = {
    "transformer": (TM.TRANSFORMER_BIG, TM.TRANSFORMER_TINY,
                    TM.init_transformer, TM.loss_fn),
    "ssd": (SSD.SSDConfig(), SSD.SSD_TINY, SSD.init_ssd, SSD.loss_fn),
    "maskrcnn": (MR.MaskRCNNConfig(), MR.MASKRCNN_TINY, MR.init_maskrcnn,
                 MR.loss_fn),
}
MODELS = tuple(_MODELS)
LR = 1e-3
# fig9's batches (the Transformer at both of its lengths: 256 and the
# paper's 97) and the Mask R-CNN test's
DEFAULT_BATCH = {"transformer": 2, "ssd": 4, "maskrcnn": 2}
DEFAULT_SEQ = 97


def configs(model: str, full: bool = False):
    """The published config of ``model`` or its tiny one."""
    return _MODELS[model][0 if full else 1]


def init_params(model: str, cfg, seed: int = 0, *, device="cuda"):
    """fp32 weights of ``model`` at ``cfg`` from ``seed``."""
    return _MODELS[model][2](cfg, seed, device=device)


def loss_of(model: str, cfg) -> Callable:
    """``loss(params, batch) -> (loss, aux)`` of ``model`` at ``cfg``."""
    fn = _MODELS[model][3]
    return lambda params, batch: fn(params, cfg, batch)


def synthetic_batch(model: str, cfg, B: int, rng, *, seq: int = DEFAULT_SEQ
                    ) -> Dict[str, np.ndarray]:
    """A numpy batch drawn from ``rng`` in fig9's order (the Transformer:
    ``src``, then ``tgt``, ids in [1, vocab); SSD: images, a class id in
    [0, classes) for every anchor, box targets) or the Mask R-CNN test's
    (images, RPN labels over the finest level's locations, then a class,
    a box and a mask for every proposal)."""
    if model == "transformer":
        src = rng.integers(1, cfg.vocab, (B, seq))
        return {"src": src, "tgt": rng.integers(1, cfg.vocab, (B, seq))}
    n = cfg.image_size
    images = rng.standard_normal((B, n, n, 3)).astype(np.float32)
    if model == "ssd":
        A = SSD.num_anchors(cfg)
        cls = rng.integers(0, cfg.num_classes, (B, A))
        return {"images": images, "cls_targets": cls,
                "box_targets": rng.standard_normal((B, A, 4)
                                                   ).astype(np.float32)}
    A, P, ms = MR.rpn_size(cfg) ** 2, cfg.num_proposals, cfg.mask_size
    rpn = rng.integers(0, 2, (B, A))
    cls = rng.integers(0, cfg.num_classes, (B, P))
    box = rng.standard_normal((B, P, 4)).astype(np.float32)
    return {"images": images, "rpn_labels": rpn, "cls_targets": cls,
            "box_targets": box,
            "mask_targets": rng.integers(0, 2, (B, P, ms, ms))}


def to_device(batch, device) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}


def make_train_step(loss_fn: Callable, optimizer: Optimizer):
    """``step(params, opt_state, batch) -> (params, opt_state, loss)``:
    ``loss_fn``'s value and gradient (autograd; zero for a leaf the loss
    does not read) and the optimizer's update, in place (fig9's
    ``value_and_grad`` + ``opt.update``). The loss stays on the device."""

    def step(params, opt_state, batch):
        leaves = tree_leaves(params)
        with torch.enable_grad():
            for w in leaves:
                w.requires_grad_(True)
            loss, _ = loss_fn(params, batch)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        # leaves the loss never reads (SSD's unused backbone stage and the
        # backbones' heads) get the zero gradient jax.grad gives them
        grads = [torch.zeros_like(w) if g is None else g
                 for w, g in zip(leaves, grads)]
        params, opt_state = optimizer.update(grads, opt_state, params)
        return params, opt_state, loss.detach()

    return step


def train(loss_fn: Callable, params, batch, *, steps: int, device,
          log=print) -> List[Dict]:
    """``steps`` steps of ``adam(constant(1e-3))`` on ``batch`` (device
    tensors), ``params`` updated in place. One record a step: ``step``,
    ``loss``, ``step_ms`` (host clock to the loss on the host, so the
    step's work is done) and the flash kernels' forward and backward
    launches in the step (0 on the CPU)."""
    resolve_device(device)
    opt = adam(constant(LR))
    opt_state = opt.init(params)
    step_fn = make_train_step(loss_fn, opt)
    history = []
    for i in range(steps):
        f0 = fa.flash_attention_fwd_cuda.launches
        b0 = fa.flash_attention_bwd_cuda.launches
        t0 = time.perf_counter()
        params, opt_state, loss = step_fn(params, opt_state, batch)
        loss = loss.item()
        rec = dict(step=i + 1, loss=loss,
                   step_ms=(time.perf_counter() - t0) * 1e3,
                   flash_fwd=fa.flash_attention_fwd_cuda.launches - f0,
                   flash_bwd=fa.flash_attention_bwd_cuda.launches - b0)
        log(f"step {i + 1}: loss={loss:.4f} step_ms={rec['step_ms']:.1f}")
        history.append(rec)
    return history


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", choices=MODELS, default="transformer")
    ap.add_argument("--full", action="store_true",
                    help="the published config (default: the tiny one)")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--batch", type=int, default=None,
                    help=f"default {DEFAULT_BATCH}")
    ap.add_argument("--seq", type=int, default=DEFAULT_SEQ,
                    help="Transformer source and target length")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain path)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = configs(args.model, args.full)
    B = args.batch or DEFAULT_BATCH[args.model]
    params = init_params(args.model, cfg, 0, device=dev)
    batch = to_device(synthetic_batch(args.model, cfg, B,
                                      np.random.default_rng(0),
                                      seq=args.seq), dev)
    history = train(loss_of(args.model, cfg), params, batch,
                    steps=args.steps, device=dev)
    print("done", history[-1] if history else "")
    return 0


if __name__ == "__main__":
    sys.exit(main())
