"""The collectives of the paper's techniques on a :class:`~repro_torch.
launch.mesh.Mesh`: the port's counterparts of what the reference's
``shard_map`` bodies call (``jax.lax.psum``, ``psum_scatter``,
``all_gather``, ``ppermute``, ``axis_index`` and ``psum`` with
``axis_index_groups``).

API rule. A port function runs once per rank, on that rank's block as
the reference's ``in_specs`` lay it out (``P(axis)``: this rank's slice
along that dimension; ``P()``: the whole tensor), and returns this rank's
block under its ``out_specs``. Every rank of the mesh calls the same
collectives in the same order.

Gradients. A value is either per-rank (a rank's block, or its own
contribution, as the reference's ``P(axis)``) or replicated (the same on
every rank of the line, ``P()``). ``psum``, ``psum_scatter``,
``all_gather`` and ``ppermute`` take per-rank values to per-rank values,
and their backward is the adjoint collective (psum's is psum, all-gather's
reduce-scatter, ppermute's the inverse permutation): autograd on every
rank gives that rank's share of the gradient of the sum of all ranks'
losses. That is the data axis, whose shares gradient summation adds up
afterwards. ``pvary``, ``shard``, ``all_gather_invariant`` and ``psum_invariant``
cross between replicated and per-rank values, as a ``shard_map``'s ``P()`` in and out
specs do: across them a replicated value gets its whole gradient on every
rank, the same on each, as ``jax.grad`` gives it through ``shard_map``.
That is the model axis, whose ranks replicate everything outside the
techniques. An axis of one rank still goes through its process group (a
copy), so a 1 x 1 mesh runs the same calls.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.distributed as dist


def axis_size(mesh, axis: str) -> int:
    return mesh.shape[axis]


def axis_index(mesh, axis: str) -> int:
    """This rank's index along ``axis`` (a Python int)."""
    return mesh.axis_index(axis)


# --------------------------------------------------------------------------- #
# Raw collectives (no autograd); x contiguous.
# --------------------------------------------------------------------------- #
def _all_reduce(x, group):
    y = x.contiguous().clone()
    dist.all_reduce(y, group=group)
    return y


def _reduce_scatter(x, group, n):
    """The group's sum, cut into dim-0 blocks; group rank r keeps block r."""
    if x.shape[0] % n:
        raise ValueError(f"psum_scatter: dim 0 of {tuple(x.shape)} does not "
                         f"split over {n} ranks")
    out = x.new_empty((x.shape[0] // n, *x.shape[1:]))
    dist.reduce_scatter_tensor(out, x.contiguous(), group=group)
    return out


def _all_gather(x, group, n):
    """Blocks of every rank of the group concatenated along dim 0."""
    out = x.new_empty((x.shape[0] * n, *x.shape[1:]))
    dist.all_gather_into_tensor(out, x.contiguous(), group=group)
    return out


def _permute(x, mesh, axis, perm):
    """Send x to each ``dst`` of a pair (this rank's index, dst) and receive
    from each ``src`` of (src, this rank's index), in one batch of
    point-to-point operations; zeros where nothing arrives."""
    line, me = mesh.line(axis), mesh.axis_index(axis)
    x = x.contiguous()
    out = torch.zeros_like(x)
    ops = []
    for src, dst in perm:
        if src == me and dst == me:
            out.copy_(x)
        elif src == me:
            ops.append(dist.P2POp(dist.isend, x, line[dst]))
        elif dst == me:
            ops.append(dist.P2POp(dist.irecv, out, line[src]))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return out


# --------------------------------------------------------------------------- #
# Differentiable wrappers.
# --------------------------------------------------------------------------- #
class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, dy):
        return _all_reduce(dy, ctx.group), None


class _PsumScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n):
        ctx.group, ctx.n = group, n
        return _reduce_scatter(x, group, n)

    @staticmethod
    def backward(ctx, dy):
        return _all_gather(dy, ctx.group, ctx.n), None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n):
        ctx.group, ctx.n = group, n
        return _all_gather(x, group, n)

    @staticmethod
    def backward(ctx, dy):
        return _reduce_scatter(dy, ctx.group, ctx.n), None, None


class _Ppermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, perm):
        ctx.mesh, ctx.axis, ctx.perm = mesh, axis, perm
        return _permute(x, mesh, axis, perm)

    @staticmethod
    def backward(ctx, dy):
        inverse = [(dst, src) for src, dst in ctx.perm]
        return _permute(dy, ctx.mesh, ctx.axis, inverse), None, None, None


class _Pvary(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dy):
        return _all_reduce(dy, ctx.group), None


class _Shard(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, index):
        ctx.group, ctx.n = group, n
        h = x.shape[0] // n
        return x[index * h:(index + 1) * h].contiguous()

    @staticmethod
    def backward(ctx, dy):
        return _all_gather(dy, ctx.group, ctx.n), None, None, None


class _AllGatherInvariant(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, index):
        ctx.h, ctx.index = x.shape[0], index
        return _all_gather(x, group, n)

    @staticmethod
    def backward(ctx, dy):
        h, i = ctx.h, ctx.index
        return dy[i * h:(i + 1) * h], None, None, None


class _PsumInvariant(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, dy):
        return dy, None


def psum(x, mesh, axis: str):
    """``lax.psum(x, axis)``: the sum over the ranks of this rank's line
    along ``axis``, on every one of them."""
    return _Psum.apply(x, mesh.group(axis))


def psum_scatter(x, mesh, axis: str):
    """``lax.psum_scatter(x, axis, tiled=True)``, the only form the
    techniques call: the sum over the line along ``axis``, cut into blocks
    along dim 0; the rank at index r of the axis keeps block r."""
    return _PsumScatter.apply(x, mesh.group(axis), axis_size(mesh, axis))


def all_gather(x, mesh, axis: str, *, dim: int = 0):
    """``lax.all_gather(x, axis, tiled=True)`` along tensor dim ``dim``:
    the blocks of the line along ``axis`` concatenated in axis order."""
    y = _AllGather.apply(x.movedim(dim, 0), mesh.group(axis),
                         axis_size(mesh, axis))
    return y.movedim(0, dim)


def pvary(x, mesh, axis: str):
    """``jax.lax.pvary``: a replicated ``x`` (a ``P()`` weight) entering
    per-rank work. The identity forward; the backward psums the cotangent
    over the line, so ``x`` gets its whole gradient on every rank."""
    return _Pvary.apply(x, mesh.group(axis))


def shard(x, mesh, axis: str, *, dim: int = 0):
    """This rank's block along tensor dim ``dim`` of a replicated ``x``
    (what a ``P(axis)`` in_spec hands a shard). The backward all-gathers
    the blocks' cotangents, so ``x`` gets its whole cotangent on every
    rank. The dim must divide."""
    n = axis_size(mesh, axis)
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} is not divisible "
                         f"by {n} shards of {axis!r}")
    y = _Shard.apply(x.movedim(dim, 0), mesh.group(axis), n,
                     axis_index(mesh, axis))
    return y.movedim(0, dim)


def all_gather_invariant(x, mesh, axis: str, *, dim: int = 0):
    """The blocks of the line concatenated along ``dim``, as
    :func:`all_gather`, as a replicated result (a ``P(axis)`` out_spec read
    back whole): the backward takes this rank's block of the replicated
    cotangent, with no sum."""
    y = _AllGatherInvariant.apply(x.movedim(dim, 0), mesh.group(axis),
                                  axis_size(mesh, axis),
                                  axis_index(mesh, axis))
    return y.movedim(0, dim)


def psum_invariant(x, mesh, axis: str):
    """The sum over the line along ``axis`` as a replicated result that
    every rank of the line then uses alike (the row-parallel product's
    partial sums, Megatron's "g"): the forward all-reduces, the backward
    is the identity, since each rank's cotangent of the sum is already
    the whole one. :func:`psum`'s all-reduce backward would count it
    once a rank."""
    return _PsumInvariant.apply(x, mesh.group(axis))


def ppermute(x, mesh, axis: str, perm: Sequence[Tuple[int, int]]):
    """``lax.ppermute(x, axis, perm)``: each pair (src, dst) of axis indices
    sends src's x to dst; a rank that no pair sends to gets zeros. Built on
    ``batch_isend_irecv``, so no order of sends and receives can
    deadlock."""
    return _Ppermute.apply(x, mesh, axis, tuple(map(tuple, perm)))


def group_psum(x, mesh, axis: str, group_size: int):
    """``psum`` with ``axis_index_groups`` of ``group_size`` consecutive
    indices along ``axis`` (``repro.core.distributed_norm._group_psum``,
    ``distributed_norm.py:33-41``): the whole axis when ``group_size`` is at
    least its size. Returns (sum, ranks summed)."""
    n = axis_size(mesh, axis)
    if group_size >= n:
        return psum(x, mesh, axis), n
    if group_size == 1:
        return x, 1
    return _Psum.apply(x, mesh.subgroup(axis, group_size)), group_size
