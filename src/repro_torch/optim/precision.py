"""bfloat16 mixed-precision policy (``repro.optim.precision``, paper
C7): matrix products take bf16 operands, master weights stay fp32, and
1-D parameters stay fp32. On a mesh the cast runs on each rank's blocks
of the masters, and the blocks are gathered after it, where a layer
uses them (``dist.spmd.Placement.gather``), so the FSDP all-gather moves
bf16: the reference pins the cast copy to the weights' layout for the
same reason (``precision.py:24-47``)."""
from __future__ import annotations

import torch

from repro_torch.utils import tree_map

# The keys under which a parameter tree lists its layers (the reference
# stacks each along a leading axis): the decoder-only stack, the enc-dec
# encoder and decoder.
LAYER_STACKS = ("layers", "enc_blocks", "dec_blocks")


def compute_cast(params, dtype="bfloat16"):
    """Compute copy of ``params`` as the reference's train step makes it
    (``repro.optim.precision.compute_cast`` over its tree, whose layers
    are stacked along a leading axis): every fp32 leaf of 2 or more
    dimensions cast to ``dtype``, a leaf under a layer list
    (:data:`LAYER_STACKS`) counted with that stacking axis, so a layer's
    norm scales and biases are cast too; a 1-D leaf outside the layers
    (the final norms') stays fp32. The cast is differentiable, so the gradient reaches the fp32
    master in fp32."""
    dt = getattr(torch, dtype)

    def cast(min_dim):
        def one(w):
            if w.dtype != torch.float32 or w.dim() < min_dim:
                return w
            return w.to(dt)
        return one

    if isinstance(params, dict) and any(k in params for k in LAYER_STACKS):
        return {k: tree_map(cast(1 if k in LAYER_STACKS else 2), v)
                for k, v in params.items()}
    return tree_map(cast(2), params)
