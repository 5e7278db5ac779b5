"""Graph partitioning (``repro.core.graph_partitioning``, paper section
3, Mask R-CNN stage 2, C10): "we apply graph partitioning by placing
independent ops on up to four different cores."

On a mesh, branch i runs only on the ranks at index ``i % n`` of the
'model' axis; every output goes through fp32, a psum over disjoint
supports (zeros elsewhere) rebuilds it on every rank, and it is cast back
to the branch's dtype (``graph_partitioning.py:29-54``). The ranks that
do not own a branch learn its shape and dtype from a run under
``FakeTensorMode``, which computes nothing (the reference's
``jax.eval_shape``). Without a mesh the branches run in order on the one
device, each output making the same round trip through fp32.

Gradients on a mesh. The outputs are replicated, and so are the inputs
the branches read (the reference's thunks close over them, and its
``shard_map`` transposes them with a psum over the axis). A branch
therefore takes the tensors that may need gradients as arguments
(``inputs``), and one autograd node carries the whole call: its backward
runs each rank's own branches back to ``inputs`` and sums their
gradients over the axis in one all-reduce, which every rank makes, owner
or not, so every rank gets the whole gradient. A branch that reads a
tensor needing a gradient other than through ``inputs`` raises, as that
gradient would be lost.
"""
from __future__ import annotations

from typing import Callable, List, Sequence

import torch

from repro_torch.dist import compat


def _shape_of(branch, args):
    from torch._subclasses.fake_tensor import FakeTensorMode

    with torch.no_grad(), FakeTensorMode(allow_non_fake_inputs=True):
        y = branch(*args)
    return tuple(y.shape), y.dtype, y.device


def _reads_outside(ys, args) -> bool:
    """Whether the graphs of ``ys`` reach a leaf that needs a gradient
    other than ``args``."""
    allowed = {id(a) for a in args}
    seen, stack = set(), [y.grad_fn for y in ys]
    while stack:
        fn = stack.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        if hasattr(fn, "variable"):  # AccumulateGrad of a leaf
            if id(fn.variable) not in allowed:
                return True
            continue
        stack.extend(f for f, _ in fn.next_functions)
    return False


def _run(branches, mesh, axis, args):
    """(this rank's [(i, output)], every output whole, in its dtype)."""
    n = compat.axis_size(mesh, axis)
    idx = compat.axis_index(mesh, axis)
    owned, vals, metas = [], [], []
    for i, branch in enumerate(branches):
        if i % n == idx:
            y = branch(*args)
            owned.append((i, y))
            metas.append((tuple(y.shape), y.dtype))
            vals.append(y.detach().float())
        else:
            shape, dtype, device = _shape_of(branch, args)
            metas.append((shape, dtype))
            vals.append(torch.zeros(shape, dtype=torch.float32,
                                    device=device))
    # exactly one index computed each branch: the psum rebuilds it
    flat = compat._all_reduce(torch.cat([v.reshape(-1) for v in vals]),
                              mesh.group(axis))
    outs, at = [], 0
    for shape, dtype in metas:
        size = 1
        for s in shape:
            size *= s
        outs.append(flat[at:at + size].reshape(shape).to(dtype))
        at += size
    return owned, outs


class _Partitioned(torch.autograd.Function):
    @staticmethod
    def forward(ctx, plan, *inputs):
        branches, mesh, axis = plan
        args = [x.detach().requires_grad_(x.requires_grad) for x in inputs]
        with torch.enable_grad():
            owned, outs = _run(branches, mesh, axis, args)
        if _reads_outside([y for _, y in owned], args):
            raise ValueError("run_partitioned: a branch reads a tensor that "
                             "needs a gradient other than through inputs")
        ctx.args, ctx.owned, ctx.group = args, owned, mesh.group(axis)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *gouts):
        need = [a for a in ctx.args if a.requires_grad]
        ys = [(y, gouts[i]) for i, y in ctx.owned if y.requires_grad]
        got = [None] * len(need)
        if ys and need:
            got = torch.autograd.grad([y for y, _ in ys],
                                      need, [g.to(y.dtype) for y, g in ys],
                                      allow_unused=True)
        flat = compat._all_reduce(torch.cat([
            (g if g is not None else torch.zeros_like(a)).float().reshape(-1)
            for g, a in zip(got, need)]), ctx.group)
        summed, at = {}, 0
        for a in need:
            summed[id(a)] = (flat[at:at + a.numel()].reshape(a.shape)
                             .to(a.dtype))
            at += a.numel()
        return (None, *(summed.get(id(a)) for a in ctx.args))


def run_partitioned(branches: Sequence[Callable[..., torch.Tensor]], *,
                    mesh=None, axis_name: str = "model",
                    inputs: Sequence[torch.Tensor] = ()
                    ) -> List[torch.Tensor]:
    """The outputs of the independent ``branches``, each called as
    ``branch(*inputs)``, in order, each cast to fp32 and back to its dtype.
    With ``mesh``, each branch runs on its owner's ranks only and the
    outputs are whole on every rank (the reference's in_specs ``()``,
    out_specs ``P()``); ``inputs`` are the replicated tensors the branches
    read that may need gradients, and each gets its whole gradient on
    every rank."""
    if mesh is None:
        outs = []
        for branch in branches:
            y = branch(*inputs)
            outs.append(y.float().to(y.dtype))
        return outs
    if torch.is_grad_enabled():
        return list(_Partitioned.apply((branches, mesh, axis_name),
                                       *inputs))
    return _run(branches, mesh, axis_name, list(inputs))[1]
