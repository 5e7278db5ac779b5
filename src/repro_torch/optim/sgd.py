"""SGD with momentum, optional weight decay and Nesterov
(``repro.optim.sgd``), over the port's parameter trees. As the port's
Adam and LARS, ``update`` writes the new weights and fp32 momenta into the
given tensors and returns the same trees."""
from __future__ import annotations

import torch

from repro_torch.optim.base import Optimizer
from repro_torch.optim.lars import zero_momenta
from repro_torch.utils import tree_leaves


def sgd_momentum(lr_schedule, momentum: float = 0.9, weight_decay: float = 0.0,
                 nesterov: bool = False) -> Optimizer:

    @torch.no_grad()
    def update(grads, state, params, step=None):
        step = state["step"] if step is None else step
        lr = lr_schedule(step)
        for w, g, m in zip(tree_leaves(params), tree_leaves(grads),
                           tree_leaves(state["m"])):
            lr_d = lr.to(w.device)
            g32 = g.float() + weight_decay * w.float()
            m.mul_(momentum).add_(g32)
            upd = g32 + momentum * m if nesterov else m
            w.copy_(w.float() - lr_d * upd)
        return params, {"m": state["m"], "step": step + 1}

    return Optimizer("sgd_momentum", zero_momenta, update,
                     {"momentum": momentum, "weight_decay": weight_decay})
