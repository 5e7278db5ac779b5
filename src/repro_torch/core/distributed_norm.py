"""Batch normalization (``repro.core.distributed_norm``): the one-device
``batch_norm`` and the distributed (cross-replica) batch norm of paper
section 2 (from Ying et al.; C5).

The reference normalizes with batch statistics always, in training and in
eval: there are no running statistics. Statistics are fp32 over every
dimension but the last (channels last), the variance is biased, eps is
1e-5, and the result is cast back to the input's dtype.

When examples a core drop below a threshold, one core's statistics are
too noisy; :func:`distributed_batch_norm` computes them over a subgroup
of ``group_size`` replicas along the data axis (not the whole pod, which
would serialize on the interconnect and change the regularization).
"""
from __future__ import annotations

import torch

from repro_torch.dist import compat


def batch_norm(x, scale, bias, *, eps: float = 1e-5):
    """Plain batch norm over the batch and spatial dims (``distributed_norm.
    py:23-30``). x: (B, H, W, C) or (B, C); scale, bias: (C,) fp32.
    Returns (y in x's dtype, mean, variance), both fp32 of shape (C,)."""
    red = tuple(range(x.dim() - 1))
    x32 = x.float()
    mu = x32.mean(red)
    xc = x32 - mu
    var = (xc * xc).mean(red)  # biased, two-pass, as jnp.var
    y = xc * torch.rsqrt(var + eps) * scale + bias
    return y.to(x.dtype), mu, var


def distributed_batch_norm(x, scale, bias, *, mesh, axis_name: str = "data",
                           group_size: int = 2, eps: float = 1e-5):
    """Batch norm with statistics shared across ``group_size`` consecutive
    replicas of ``axis_name`` (``distributed_norm.py:44-70``; in_specs
    ``(P(axis_name), P(), P())``, out_specs ``P(axis_name)``).

    x: this rank's batch shard (B_local, ..., C); scale, bias: (C,). The
    fp32 sums of x and x^2 go through one group psum, and the variance is
    the reference's one-pass ``s2 / (cnt * g) - mu**2``. Returns y in x's
    dtype."""
    red = tuple(range(x.dim() - 1))
    x32 = x.float()
    cnt = 1
    for i in red:
        cnt *= x.shape[i]
    sums, g = compat.group_psum(
        torch.stack([x32.sum(red), (x32 ** 2).sum(red)]), mesh, axis_name,
        group_size)
    mu = sums[0] / (cnt * g)
    var = sums[1] / (cnt * g) - mu ** 2
    y = (x32 - mu) * torch.rsqrt(var + eps) * scale + bias
    return y.to(x.dtype)
