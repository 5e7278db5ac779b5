"""Adam (``repro.optim.adam``), the MLPerf Transformer optimizer, with
the reference's arithmetic written out (not ``torch.optim.Adam``):
bias corrections ``1 - b**t`` at ``t = step + 1``, the update
``(m / bc1) / (sqrt(v / bc2) + eps)`` with eps outside the square root,
moments computed in fp32 and stored in ``moment_dtype``.

Unlike the reference, which returns new arrays, ``update`` writes the
new weights and moments into the given tensors in place (under
``torch.no_grad()``), a slice of ``SLICE`` elements at a time, and
returns the same trees: a full-width model cannot hold a second copy of
its weights and moments, nor the fp32 temporaries of a whole large leaf.
Every operation is elementwise, so slicing changes no value.
"""
from __future__ import annotations

import torch

from repro_torch.optim.base import Optimizer
from repro_torch.utils import tree_leaves, tree_map


# Elements of a leaf updated at once: the fp32 temporaries of the update
# (about six of them) stay 64 MiB each, where a whole 805 M-element MoE leaf
# would need ~19 GB of them beside the weights and moments.
SLICE = 1 << 24


def _slices(*ts):
    """Matching flat slices of at most ``SLICE`` elements of tensors of one
    shape, as views, so updates in place write through; tensors that are
    not all contiguous form one slice."""
    if not all(t.is_contiguous() for t in ts):
        yield ts
        return
    flat = [t.view(-1) for t in ts]
    for i in range(0, flat[0].numel(), SLICE):
        yield tuple(f[i:i + SLICE] for f in flat)


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

    def _update_slice(w, g, m, v, lr_d, bc1_d, bc2_d):
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
            for ws, gs, ms, vs in _slices(w, g, m, v):
                _update_slice(ws, gs, ms, vs, lr_d, bc1_d, bc2_d)
        return params, {"m": state["m"], "v": state["v"], "step": step + 1}

    return Optimizer("adam", init, update,
                     {"b1": b1, "b2": b2, "eps": eps,
                      "weight_decay": weight_decay})
