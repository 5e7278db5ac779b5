"""Adam (``repro.optim.adam``), the MLPerf Transformer optimizer, with
the reference's arithmetic written out (not ``torch.optim.Adam``):
bias corrections ``1 - b**t`` at ``t = step + 1``, the update
``(m / bc1) / (sqrt(v / bc2) + eps)`` with eps outside the square root,
moments computed in fp32 and stored in ``moment_dtype``.

Unlike the reference, which returns new arrays, ``update`` writes the
new weights and moments into the given tensors in place (under
``torch.no_grad()``) and returns the same trees: a full-width model
cannot hold a second copy of its weights and moments.
"""
from __future__ import annotations

import torch

from repro_torch.optim.base import Optimizer
from repro_torch.utils import tree_leaves, tree_map


def adam(lr_schedule, b1: float = 0.9, b2: float = 0.98, eps: float = 1e-9,
         weight_decay: float = 0.0, moment_dtype: str = "float32") -> Optimizer:
    mdt = getattr(torch, moment_dtype)

    def init(params):
        def z(w):
            return torch.zeros_like(w, dtype=mdt)

        leaf = tree_leaves(params)[0]
        return {"m": tree_map(z, params), "v": tree_map(z, params),
                "step": torch.zeros((), dtype=torch.int32,
                                    device=leaf.device)}

    @torch.no_grad()
    def update(grads, state, params, step=None):
        step = state["step"] if step is None else step
        lr = lr_schedule(step)
        t = torch.as_tensor(step).to(torch.float32) + 1.0
        bc1 = 1 - b1 ** t
        bc2 = 1 - b2 ** t
        for w, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                              tree_leaves(state["m"]),
                              tree_leaves(state["v"])):
            lr_d, bc1_d, bc2_d = (x.to(w.device) for x in (lr, bc1, bc2))
            g32 = g.float()
            if mdt == torch.float32:  # moments updated where they lie
                m.mul_(b1).add_(g32, alpha=1 - b1)
                v.mul_(b2).addcmul_(g32, g32, value=1 - b2)
                m_new, v_new = m, v
            else:
                m_new = b1 * m.float() + (1 - b1) * g32
                v_new = b2 * v.float() + (1 - b2) * g32 * g32
            upd = (m_new / bc1_d).div_(
                torch.sqrt(v_new / bc2_d).add_(eps))
            if weight_decay:
                upd.add_(w.float(), alpha=weight_decay)
            upd.mul_(lr_d)
            if w.dtype == torch.float32:
                w.sub_(upd)
            else:
                w.copy_(w.float() - upd)
            if m_new is not m:
                m.copy_(m_new)
                v.copy_(v_new)
        return params, {"m": state["m"], "v": state["v"], "step": step + 1}

    return Optimizer("adam", init, update,
                     {"b1": b1, "b2": b2, "eps": eps,
                      "weight_decay": weight_decay})
