"""Spatial partitioning with halo exchange (paper section 2 "Model
parallelism", Fig. 3; C3; ``repro.core.spatial_partitioning``), and its
transformer analogue, sequence partitioning.

The paper shards convolutions along a spatial dim across 2-4 cores; each
core exchanges a halo of rows with its neighbours before the conv. The
same halo implements sequence-parallel sliding-window attention: a
sequence shard needs exactly the previous shard's last ``window`` keys
and values (Fig. 3 with rows -> tokens).

On a ``torch.distributed`` mesh the neighbour exchange is
:func:`repro_torch.dist.compat.ppermute`. Each function runs on every rank
of the axis with that rank's block (the reference's ``P(None, axis)``
in_specs) and returns its block of the result.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.dist import compat
from repro_torch.kernels import ops


def halo_exchange(x, mesh, axis_name: str, *, lo: int, hi: int, dim: int):
    """x extended along ``dim`` by the ``lo`` trailing rows of the left
    neighbour's block in front and the ``hi`` leading rows of the right
    neighbour's behind. The boundary shards get zeros (no wrap)."""
    n = compat.axis_size(mesh, axis_name)
    size = x.shape[dim]
    if lo > size or hi > size:
        raise ValueError(f"halo_exchange: halos ({lo}, {hi}) exceed the "
                         f"block's {size} rows")
    parts = []
    if lo:
        tail = x.narrow(dim, size - lo, lo)
        parts.append(compat.ppermute(tail, mesh, axis_name,
                                     [(i, i + 1) for i in range(n - 1)]))
    parts.append(x)
    if hi:
        head = x.narrow(dim, 0, hi)
        parts.append(compat.ppermute(head, mesh, axis_name,
                                     [(i, i - 1) for i in range(1, n)]))
    return torch.cat(parts, dim)


def spatial_conv2d(x, w, *, stride: int = 1, mesh, axis_name: str = "model"):
    """SAME conv2d with H sharded over ``axis_name`` (paper Fig. 3;
    ``spatial_partitioning.py:63-101``; in_specs ``(P(None, axis_name,
    None, None), P())``, out_specs ``P(None, axis_name, None, None)``);
    equal to the unsharded conv.

    x: this rank's H block (B, h_loc, W, C), NHWC, of an image whose H =
    h_loc * n is divisible by n * stride (on one shard, any H); w: (O, C,
    kh, kw), the port's conv layout (the reference's HWIO transposed), in
    x's dtype. The split is XLA's SAME (the odd pad row at the end),
    ``pad_lo = total // 2``; each shard gets ``lo`` halo rows in front and
    ``hi`` behind so that it computes exactly its ceil(h_loc / stride)
    output rows (``hi < 0`` trims rows), and pads W on its own. Returns
    this rank's block of the output (B, ceil(h_loc / stride), W', O),
    NHWC. ``w`` enters through ``compat.pvary``, so its gradient is whole
    on every rank; x's is this rank's block.

    On one shard with H not divisible by the stride (SSD's stride-2 conv
    at 75 x 75), the reference's ``hi`` counts floor(h_loc / stride) rows,
    one short of SAME, and its residual add then fails on the shapes; the
    port counts ceil(h_loc / stride), SAME's rows, which the reference's
    formula gives wherever its contract holds. Over several shards such an
    H raises, as no equal blocks exist."""
    n = compat.axis_size(mesh, axis_name)
    kh, kw = w.shape[2], w.shape[3]
    h_loc = x.shape[1]
    H = h_loc * n
    if n > 1 and h_loc % stride:
        raise ValueError(f"spatial_conv2d: H {H} is not divisible by {n} "
                         f"shards x stride {stride}")
    total = max((-(-H // stride) - 1) * stride + kh - H, 0)
    lo = total // 2
    hi = (-(-h_loc // stride) - 1) * stride + kh - lo - h_loc
    xh = halo_exchange(x, mesh, axis_name, lo=lo, hi=max(hi, 0), dim=1)
    if hi < 0:
        xh = xh[:, :xh.shape[1] + hi]
    W = x.shape[2]
    totw = max((-(-W // stride) - 1) * stride + kw - W, 0)
    xn = xh.permute(0, 3, 1, 2)
    if totw:
        xn = F.pad(xn, (totw // 2, totw - totw // 2))
    w = compat.pvary(w, mesh, axis_name)
    return F.conv2d(xn, w, stride=stride).permute(0, 2, 3, 1)


def seq_parallel_swa(q, k, v, *, window: int, mesh,
                     axis_name: str = "model"):
    """Causal sliding-window attention with the sequence sharded over
    ``axis_name`` (``spatial_partitioning.py:107-134``; in_specs and
    out_specs ``P(None, axis_name, None, None)``): each rank takes
    the previous shard's last ``window`` K/V rows by halo exchange and runs
    ``ops.attention`` (the flash forward kernel on the card) with its
    queries at ``q_offset = idx * s_loc`` and the halo'd keys from
    ``k_offset = q_offset - window``; on rank 0 that is negative, and its
    zero halo rows sit at negative positions, which the kernel masks.

    q, k, v: this rank's blocks (B, s_loc, H, D) / (B, s_loc, K, D) with
    window <= s_loc. Returns this rank's block of the output."""
    s_loc = q.shape[1]
    if window > s_loc:
        raise ValueError(f"seq_parallel_swa: window {window} exceeds the "
                         f"shard's {s_loc} positions")
    kx = halo_exchange(k, mesh, axis_name, lo=window, hi=0, dim=1)
    vx = halo_exchange(v, mesh, axis_name, lo=window, hi=0, dim=1)
    q_off = compat.axis_index(mesh, axis_name) * s_loc
    return ops.attention(q, kx, vx, causal=True, window=window,
                         q_offset=q_off, k_offset=q_off - window)
