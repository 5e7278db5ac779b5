"""Weight-update sharding (paper section 2 "Weight update sharding",
Fig. 4; C1; ``repro.core.weight_update_sharding``).

With a small batch a core, the replicated optimizer update becomes a
serial bottleneck (the paper: ~6% of the step for ResNet-50/LARS on 2048
cores, ~45% for Transformer/Adam). The fix shards the optimizer state and
the update across the data-parallel ranks: each rank reduce-scatters the
gradients, updates its 1/N of the flat weights, and all-gathers them.

- :func:`sharded_update` for the elementwise optimizers (Adam, SGD with
  momentum): flat 1/N moment shards, the rank's slice of the flat
  weights, the all-gather after the update.
- :func:`lars_sharded_update` for LARS, whose trust ratio needs whole
  tensors: whole leaves go round-robin over the ranks, each rank updates
  the leaves it owns (those of 2+ dimensions in one launch of each LARS
  kernel, ``kernels/ops.py:lars_update_leaves``), and a sum over disjoint
  supports rebuilds the tree on every rank.

Both run once per rank on the rank's own tensors; gradients enter as the
rank's local contribution, never summed beforehand. The axes come from
the same ``Rules`` table as the rest of the sharding policy
(:func:`wus_axes_from_rules`).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.gradient_summation import (
    flatten_tree,
    reduce_scatter_2d,
    unflatten_tree,
)
from repro_torch.dist import compat
from repro_torch.kernels import ops
from repro_torch.optim.base import Optimizer
from repro_torch.utils import tree_leaves, tree_map


def wus_axes_from_rules(rules) -> Tuple[str, Optional[str]]:
    """(scatter_axis, reduce_axis) from a ``dist.sharding.Rules``: the
    batch row lists the data-parallel axes outermost first (('pod',
    'data') on multipod meshes); the innermost is reduce-scattered, the
    outer one all-reduced (C2)."""
    batch = rules.table.get("batch", ())
    scatter = batch[-1] if batch else "data"
    reduce_ = batch[0] if len(batch) > 1 else None
    return scatter, reduce_


def sharded_update_from_rules(optimizer: Optimizer, lr_schedule, rules):
    """:func:`sharded_update` with its axes derived from ``rules``."""
    scatter, reduce_ = wus_axes_from_rules(rules)
    return sharded_update(optimizer, lr_schedule, rules.mesh,
                          scatter_axis=scatter, reduce_axis=reduce_)


# --------------------------------------------------------------------------- #
# Elementwise optimizers: the flat sharded update.
# --------------------------------------------------------------------------- #
def _flat_adam_update(w, g, m, v, *, lr, b1, b2, eps, weight_decay, bc1,
                      bc2):
    """Adam on one rank's fp32 shards, in place on w, m and v, in the
    port's Adam arithmetic (``optim/adam.py``): the reference's formula
    (``weight_update_sharding.py:77-83``), weight decay added after the
    bias-corrected step."""
    m.mul_(b1).add_(g, alpha=1 - b1)
    v.mul_(b2).addcmul_(g, g, value=1 - b2)
    upd = (m / bc1).div_(torch.sqrt(v / bc2).add_(eps))
    if weight_decay:
        upd.add_(w, alpha=weight_decay)
    w.sub_(upd.mul_(lr))


def _flat_sgdm_update(w, g, m, *, lr, momentum, weight_decay):
    """SGD with momentum on one rank's fp32 shards, in place on w and m
    (``weight_update_sharding.py:86-89``, the port's ``optim/sgd.py``)."""
    g = g + weight_decay * w
    m.mul_(momentum).add_(g)
    w.copy_(w - lr * m)


def sharded_update(optimizer: Optimizer, lr_schedule, mesh, *,
                   scatter_axis: str = "data",
                   reduce_axis: Optional[str] = None):
    """A WUS update for ``adam`` or ``sgd_momentum``: (init, update) with
    ``update(grads, state, params) -> (params, state)``.

    The state holds this rank's flat 1/N moment shards (the reference's
    ``P(scatter_axis)`` blocks: rank r of the axis holds elements [r*sz,
    (r+1)*sz) of the padded flat buffer), which is the memory saving of
    Fig. 4, and the step. Weights leave as new trees, whole on every rank
    (all-gathered). A ``reduce_axis`` the mesh lacks is dropped."""
    if reduce_axis is not None and reduce_axis not in mesh.axis_names:
        reduce_axis = None
    n = mesh.shape[scatter_axis]
    name, hyper = optimizer.name, optimizer.hyper
    if name not in ("adam", "sgd_momentum"):
        raise ValueError(f"flat WUS supports elementwise optimizers, got "
                         f"{name}; use lars_sharded_update for LARS")

    def init(params):
        leaves = tree_leaves(params)
        shard = -(-sum(w.numel() for w in leaves) // n)  # padded / n
        dev = leaves[0].device

        def zeros():
            return torch.zeros(shard, dtype=torch.float32, device=dev)

        state = {"step": torch.zeros((), dtype=torch.int32, device=dev),
                 "m": zeros()}
        if name == "adam":
            state["v"] = zeros()
        return state

    @torch.no_grad()
    def update(grads, state, params):
        step = state["step"]
        w_flat, w_meta = flatten_tree(params, pad_multiple=n)
        g_flat, _ = flatten_tree(grads, pad_multiple=n)
        lr = lr_schedule(step).to(w_flat.device)
        g_sh = reduce_scatter_2d(g_flat, mesh, scatter_axis, reduce_axis)
        sz = w_flat.numel() // n
        idx = compat.axis_index(mesh, scatter_axis)
        w_sh = w_flat[idx * sz:(idx + 1) * sz]
        m = state["m"].clone()
        if name == "adam":
            t = step.to(torch.float32) + 1.0
            v = state["v"].clone()
            _flat_adam_update(
                w_sh, g_sh, m, v, lr=lr, b1=hyper["b1"], b2=hyper["b2"],
                eps=hyper["eps"], weight_decay=hyper["weight_decay"],
                bc1=1 - hyper["b1"] ** t, bc2=1 - hyper["b2"] ** t)
            new_state = {"step": step + 1, "m": m, "v": v}
        else:
            _flat_sgdm_update(w_sh, g_sh, m, lr=lr,
                              momentum=hyper["momentum"],
                              weight_decay=hyper["weight_decay"])
            new_state = {"step": step + 1, "m": m}
        w_full = compat.all_gather(w_sh, mesh, scatter_axis)
        return unflatten_tree(w_full, w_meta), new_state

    return init, update


# --------------------------------------------------------------------------- #
# Tensor-granular WUS for LARS (per-tensor norms need whole tensors).
# --------------------------------------------------------------------------- #
def lars_sharded_update(lr_schedule, mesh, *, momentum=0.9,
                        weight_decay=1e-4, eta=0.001, eps=1e-9,
                        scaled_momentum=True, scatter_axis: str = "data"):
    """LARS with whole leaves round-robin over ``scatter_axis``: leaf i (in
    ``tree_leaves`` order) is owned by the rank at index ``i % n``.

    Every leaf's gradient is psummed (one flat buffer). The rank updates
    the leaves it owns: those of 2+ dimensions through
    ``ops.lars_update_leaves``, one norms launch and one update launch
    over all of them on the card; 1-D leaves by the reference's plain
    momentum rule (fp32 m, no weight decay, no trust;
    ``weight_update_sharding.py:232-236``). The other leaves become zeros,
    and one psum of the flat (w, m) buffer rebuilds the whole tree on every
    rank (x + 0 is exact). As the port's ``optim.lars``, ``update`` writes
    the new weights and momenta into the given tensors and returns the
    same trees; the momenta are whole fp32 leaves."""
    n = mesh.shape[scatter_axis]

    def init(params):
        leaf = tree_leaves(params)[0]
        return {"m": tree_map(lambda w: torch.zeros_like(
                    w, dtype=torch.float32), params),
                "step": torch.zeros((), dtype=torch.int32,
                                    device=leaf.device)}

    @torch.no_grad()
    def update(grads, state, params):
        step = state["step"]
        lw, lm = tree_leaves(params), tree_leaves(state["m"])
        g_flat, g_meta = flatten_tree(grads)
        lg = tree_leaves(unflatten_tree(
            compat.psum(g_flat, mesh, scatter_axis), g_meta))
        lr = lr_schedule(step).to(lw[0].device)
        idx = compat.axis_index(mesh, scatter_axis)
        owned = [i % n == idx for i in range(len(lw))]
        kernel = []  # (w, its fp32 view, g, m) of the owned leaves of 2+ dims
        for w, g, m, mine in zip(lw, lg, lm, owned):
            if not mine:
                continue
            g32 = g.float()
            if w.dim() <= 1:
                m.mul_(momentum).add_(g32)
                w.copy_(w.float() - lr * m)
                continue
            # a fresh copy: the summed leaves are views into one buffer, at
            # offsets the kernel's 16-byte loads may not take
            kernel.append((w, w if w.dtype == torch.float32 else w.float(),
                           g32.clone(), m))
        if kernel:
            ws, w32s, gs, ms = map(list, zip(*kernel))
            new = ops.lars_update_leaves(
                w32s, gs, ms, lr=lr, weight_decay=weight_decay,
                momentum=momentum, eta=eta, eps=eps,
                scaled_momentum=scaled_momentum)
            for w, m, (new_w, new_m) in zip(ws, ms, new):
                if new_m is not m:  # the plain path returns new tensors
                    m.copy_(new_m)
                if new_w is not w:
                    w.copy_(new_w)
        # Sum over disjoint supports: every leaf from its owner.
        mine = [(w, m) if o else (torch.zeros_like(w), torch.zeros_like(m))
                for w, m, o in zip(lw, lm, owned)]
        flat, meta = flatten_tree(mine)
        rebuilt = tree_leaves(unflatten_tree(
            compat.psum(flat, mesh, scatter_axis), meta))
        for dst, src in zip(tree_leaves(list(zip(lw, lm))), rebuilt):
            dst.copy_(src)
        return params, {"m": state["m"], "step": step + 1}

    return init, update
