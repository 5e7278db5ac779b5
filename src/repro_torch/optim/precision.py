"""bfloat16 mixed-precision policy (``repro.optim.precision``, paper
C7): matrix products take bf16 operands, master weights stay fp32, and
1-D parameters (norm scales, biases) stay fp32. There is no sharding
here, so the cast is all the policy does."""
from __future__ import annotations

import torch

from repro_torch.utils import tree_map


def compute_cast(params, dtype="bfloat16"):
    """Compute copy of ``params``: every fp32 leaf of 2 or more
    dimensions cast to ``dtype``; the cast is differentiable, so the
    gradient reaches the fp32 master in fp32."""
    dt = getattr(torch, dtype)

    def one(w):
        if w.dtype != torch.float32 or w.dim() <= 1:
            return w
        return w.to(dt)

    return tree_map(one, params)
