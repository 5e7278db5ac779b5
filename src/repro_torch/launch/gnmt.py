"""GNMT training launcher of the port:
``python -m repro_torch.launch.gnmt [--full] [--device cpu] --steps N
--batch B --window W --max-len L``.

The counterpart of ``examples/gnmt_bucketized.py``, with the same steps:
variable-length synthetic sentences (4 to ``--max-len`` tokens), window
bucketization (printing its padding waste against naive batching), the
round-robin split across 4 input hosts (printing their shard sizes), a
prefetched stream of bucketized batches, and Adam under a constant 2e-3
on the copy task (src = tgt) with the hoisted input projection (C9),
printing ``batch i: len=L loss=...`` every 4 batches and then ``done
{last record}``. ``GNMT_TINY`` by default, ``--full`` for the published
widths (``GNMTConfig()``). Runs on the card, where every LSTM cell goes
through the CUDA kernels; ``--device cpu`` runs the plain path.
"""
from __future__ import annotations

import argparse
import sys
import time
from typing import Dict, Iterable, List

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.kernels import lstm_cell as lstm_kernels
from repro_torch.models import gnmt as G
from repro_torch.optim import Optimizer, adam, constant
from repro_torch.utils import tree_leaves

N_HOSTS = 4
LR = 2e-3
LOG_EVERY = 4


def synthetic_sentences(vocab: int, n: int, max_len: int,
                        seed: int = 0) -> List[np.ndarray]:
    """``n`` int32 sentences of 4 to ``max_len`` tokens in [1, vocab),
    drawn as the example draws them (``max_len`` 39 gives its stream)."""
    rng = np.random.default_rng(seed)
    return [np.asarray(rng.integers(1, vocab, rng.integers(4, max_len + 1)),
                       np.int32) for _ in range(n)]


def make_train_step(cfg: G.GNMTConfig, optimizer: Optimizer):
    """``step(params, opt_state, batch) -> (params, opt_state, loss)``:
    the loss of ``G.loss_fn``, its gradient by autograd (the cells'
    through the backward kernel on the card) and the optimizer's update,
    in place."""

    def step(params, opt_state, batch):
        leaves = tree_leaves(params)
        with torch.enable_grad():
            for w in leaves:
                w.requires_grad_(True)
            loss, _ = G.loss_fn(params, cfg, batch)
            grads = torch.autograd.grad(loss, leaves)
        params, opt_state = optimizer.update(grads, opt_state, params)
        return params, opt_state, loss.detach()

    return step


def train(cfg: G.GNMTConfig, params, stream: Iterable, *, steps: int,
          device) -> List[Dict]:
    """Train ``params`` in place with Adam under a constant 2e-3 on the
    copy task for up to ``steps`` (tokens, mask) batches of ``stream``,
    printing the loss every ``LOG_EVERY`` batches. Returns one record
    per step:
    ``batch``, ``len`` (padded length), ``tokens`` (the real target
    tokens the loss trains on), ``loss``, ``step_ms`` (host clock, to the
    loss on the host: the step's work is done) and the LSTM kernels'
    launches in the step (0 on the CPU)."""
    dev = resolve_device(device)
    opt = adam(constant(LR))
    opt_state = opt.init(params)
    step = make_train_step(cfg, opt)
    fwd, bwd = lstm_kernels.lstm_cell_fwd_cuda, lstm_kernels.lstm_cell_bwd_cuda
    history = []
    for i, (toks, mask) in zip(range(steps), stream):
        t0 = time.perf_counter()
        f0, b0 = fwd.launches, bwd.launches
        src = torch.from_numpy(toks).to(dev)
        batch = {"src": src, "tgt": src,
                 "tgt_mask": torch.from_numpy(mask).to(dev)}
        params, opt_state, loss = step(params, opt_state, batch)
        loss = float(loss)
        history.append(dict(batch=i, len=int(toks.shape[1]),
                            tokens=int(mask[:, 1:].sum()), loss=loss,
                            step_ms=(time.perf_counter() - t0) * 1e3,
                            fwd_launches=fwd.launches - f0,
                            bwd_launches=bwd.launches - b0))
        if i % LOG_EVERY == 0:
            print(f"batch {i}: len={toks.shape[1]} loss={loss:.3f}")
    return history


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true",
                    help="published widths (GNMTConfig()); default GNMT_TINY")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain path)")
    ap.add_argument("--steps", type=int, default=13)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--window", type=int, default=6)
    ap.add_argument("--max-len", type=int, default=39)
    args = ap.parse_args(argv)

    from repro_torch.data.bucketization import (
        bucketized_batches,
        padding_waste,
        window_bucketize,
    )
    from repro_torch.data.pipeline import RoundRobinHostPipeline, prefetch

    dev = resolve_device(args.device)
    cfg = G.GNMTConfig() if args.full else G.GNMT_TINY
    params = G.init_gnmt(cfg, seed=0, device=dev)
    B = args.batch
    n = B * max(16, args.steps)
    examples = synthetic_sentences(cfg.vocab, n, args.max_len)
    lengths = [len(e) for e in examples]
    buckets = window_bucketize(lengths, batch_size=B, window=args.window)
    naive = [list(range(i, min(i + B, n))) for i in range(0, n, B)]
    print(f"padding waste: bucketized={padding_waste(lengths, buckets):.1%} "
          f"naive={padding_waste(lengths, naive):.1%}")
    hosts = RoundRobinHostPipeline(examples, n_hosts=N_HOSTS)
    print("host shard sizes:",
          [len(list(hosts.host_stream(h))) for h in range(N_HOSTS)])
    stream = prefetch(bucketized_batches(examples, B, window=args.window),
                      size=2)
    try:
        history = train(cfg, params, stream, steps=args.steps, device=dev)
    finally:
        stream.close()
    print("done", history[-1] if history else "")
    return 0


if __name__ == "__main__":
    sys.exit(main())
