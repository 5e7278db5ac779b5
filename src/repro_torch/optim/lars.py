"""LARS (``repro.optim.lars``), both update rules of the paper:

scaled_momentum=True  (Fig. 5, MLPerf-0.6 reference):
    lam = eta * ||w|| / (||g|| + beta*||w||)
    v   = m*v + (g + beta*w)
    w   = w - lam*lr*v

scaled_momentum=False (Fig. 6, You et al.):
    lam = eta * ||w|| / (||g|| + beta*||w||)
    v   = m*v + lam*lr*(g + beta*w)
    w   = w - v

Leaves of 2 or more dimensions go through
``kernels.ops.lars_update_leaves`` once a step (on the card one norms
launch and one update launch over every leaf of at least 1024
elements); 1-D leaves (biases, norm scales) take heavy-ball momentum with no
adaptation and no weight decay, as the MLPerf reference does
(``lars.py:43-48``). Momenta are fp32 for every leaf.

Unlike the reference, which returns new arrays, ``update`` writes the new
weights and momenta into the given tensors (under ``torch.no_grad()``)
and returns the same trees. ``state["step"]`` is a tensor on the
parameters' device and lr is computed there, so the step reads nothing
back to the host.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.optim.base import Optimizer
from repro_torch.utils import tree_leaves, tree_map


def zero_momenta(params):
    """fp32 zeros beside every leaf, and a step counter on their device."""
    leaf = tree_leaves(params)[0]
    return {"m": tree_map(lambda w: torch.zeros_like(w, dtype=torch.float32),
                          params),
            "step": torch.zeros((), dtype=torch.int32, device=leaf.device)}


def lars(lr_schedule, momentum: float = 0.9, weight_decay: float = 1e-4,
         eta: float = 0.001, eps: float = 1e-9,
         scaled_momentum: bool = True) -> Optimizer:

    @torch.no_grad()
    def update(grads, state, params, step=None):
        step = state["step"] if step is None else step
        lr = lr_schedule(step)
        kernel = []  # (w, its fp32 view, g, m) of the leaves of 2+ dims
        for w, g, m in zip(tree_leaves(params), tree_leaves(grads),
                           tree_leaves(state["m"])):
            g32 = g.float()
            if w.dim() <= 1:  # bias/norm: heavy-ball momentum, no adaptation
                m.mul_(momentum).add_(g32)
                w.copy_(w.float() - lr.to(w.device) * m)
                continue
            kernel.append((w, w if w.dtype == torch.float32 else w.float(),
                           g32.contiguous(), m))
        if kernel:
            ws, w32s, gs, ms = map(list, zip(*kernel))
            new = ops.lars_update_leaves(
                w32s, gs, ms, lr=lr.to(ws[0].device),
                weight_decay=weight_decay, momentum=momentum, eta=eta,
                eps=eps, scaled_momentum=scaled_momentum)
            for w, m, (new_w, new_m) in zip(ws, ms, new):
                if new_m is not m:  # the plain path returns new tensors
                    m.copy_(new_m)
                if new_w is not w:
                    w.copy_(new_w)
        return params, {"m": state["m"], "step": step + 1}

    return Optimizer(
        "lars", zero_momenta, update,
        {"momentum": momentum, "weight_decay": weight_decay, "eta": eta,
         "scaled_momentum": scaled_momentum})
