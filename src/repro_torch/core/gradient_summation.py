"""2-D gradient summation (paper section 2 "Optimize gradient summation",
C2; ``repro.core.gradient_summation``).

The paper sums gradients over the TPU-v3 2-D torus in two phases:
reduce-scatter along one torus dimension, all-reduce along the other,
then all-gather the result back, and it gathers the non-contiguous
gradient tensors into one buffer on the way.

On a ``torch.distributed`` mesh: ``psum_scatter`` over ``data``, ``psum``
over ``pod``, ``all_gather`` over ``data`` (:mod:`repro_torch.dist.compat`);
the slow cross-pod links carry 1/|data| of the bytes. The gradient tree
is first flattened into ONE contiguous fp32 buffer
(:func:`flatten_tree`), padded to a multiple of the scatter axis.

Every function runs on each rank with that rank's tensors: gradients
enter as the rank's local contribution (the reference's ``P()`` in_specs)
and leave summed on every rank (``P()`` out_specs).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from repro_torch.dist import compat
from repro_torch.utils import tree_leaves, tree_map, tree_unflatten


def flatten_tree(tree, pad_multiple: int = 1, dtype=torch.float32):
    """Every leaf, in ``tree_leaves`` order (dict keys sorted, as
    ``jax.tree_util``), cast to ``dtype`` and concatenated into one 1-D
    buffer, zero-padded to a multiple of ``pad_multiple``. Returns (flat,
    meta)."""
    leaves = tree_leaves(tree)
    flat = torch.cat([leaf.to(dtype).reshape(-1) for leaf in leaves])
    pad = (-flat.numel()) % pad_multiple
    if pad:
        flat = F.pad(flat, (0, pad))
    meta = (tree_map(lambda _: None, tree),
            [(tuple(leaf.shape), leaf.dtype) for leaf in leaves], pad)
    return flat, meta


def unflatten_tree(flat, meta):
    """The tree :func:`flatten_tree` flattened, each leaf in its dtype."""
    skeleton, shapes, pad = meta
    if pad:
        flat = flat[: flat.numel() - pad]
    out, off = [], 0
    for shape, dtype in shapes:
        n = 1
        for s in shape:
            n *= s
        out.append(flat[off:off + n].reshape(shape).to(dtype))
        off += n
    return tree_unflatten(skeleton, out)


def allreduce_1d(x, mesh, axis: str):
    """Baseline: single-phase psum over one (possibly large) axis."""
    return compat.psum(x, mesh, axis)


def reduce_scatter_2d(x, mesh, scatter_axis: str,
                      reduce_axis: Optional[str]):
    """reduce-scatter(scatter_axis) -> psum(reduce_axis): this rank's block
    of the sum (WUS consumes it; the all-gather follows the update)."""
    shard = compat.psum_scatter(x, mesh, scatter_axis)
    if reduce_axis is not None:
        shard = compat.psum(shard, mesh, reduce_axis)
    return shard


def allreduce_2d(x, mesh, scatter_axis: str, reduce_axis: Optional[str]):
    """reduce-scatter(scatter_axis) -> psum(reduce_axis) -> all-gather.
    x: a 1-D buffer divisible by the scatter axis size."""
    shard = reduce_scatter_2d(x, mesh, scatter_axis, reduce_axis)
    return compat.all_gather(shard, mesh, scatter_axis)


def gradient_allreduce_2d(grads, mesh, *, scatter_axis: str = "data",
                          reduce_axis: Optional[str] = None,
                          dtype=torch.float32):
    """Sum this rank's gradient tree over (scatter_axis, reduce_axis) by
    the 2-D schedule, in ``dtype`` (fp32, C7); the summed tree, in the
    leaves' dtypes, on every rank. A ``reduce_axis`` the mesh lacks is
    dropped (``gradient_summation.py:106``)."""
    if reduce_axis is not None and reduce_axis not in mesh.axis_names:
        reduce_axis = None
    flat, meta = flatten_tree(grads, pad_multiple=mesh.shape[scatter_axis],
                              dtype=dtype)
    return unflatten_tree(allreduce_2d(flat, mesh, scatter_axis, reduce_axis),
                          meta)


def gradient_allreduce_1d(grads, mesh, *, axes: Sequence[str] = ("data",),
                          dtype=torch.float32):
    """Single-phase baseline: one psum a present axis, no scatter phase."""
    flat, meta = flatten_tree(grads, dtype=dtype)
    for a in axes:
        if a in mesh.axis_names:
            flat = allreduce_1d(flat, mesh, a)
    return unflatten_tree(flat, meta)
