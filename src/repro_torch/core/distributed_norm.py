"""Batch normalization (``repro.core.distributed_norm``), in its
one-device form.

The reference normalizes with batch statistics always, in training and in
eval: there are no running statistics. Statistics are fp32 over every
dimension but the last (channels last), the variance is biased, eps is
1e-5, and the result is cast back to the input's dtype.
``distributed_batch_norm``, which shares the statistics across a replica
subgroup (paper section 2, C5), needs a device mesh and waits on the
ROADMAP.md item "distribution, fleet and bench".
"""
from __future__ import annotations

import torch


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
