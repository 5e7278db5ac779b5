"""Graph partitioning (``repro.core.graph_partitioning``, paper section
3, Mask R-CNN stage 2, C10): independent branches of a graph placed on
up to four cores.

The reference runs each branch on its own shard group of a mesh's
'model' axis and rebuilds every output with a psum in fp32, then casts
it back to the branch's dtype. The port has one device: the branches run
in order on it, and each output makes the same round trip through fp32.
A mesh waits on the ROADMAP.md item 'distribution, fleet and bench'.
"""
from __future__ import annotations

from typing import Callable, List, Sequence

import torch


def run_partitioned(branches: Sequence[Callable[[], torch.Tensor]], *,
                    mesh=None, axis_name: str = "model") -> List[torch.Tensor]:
    """The outputs of the independent thunks ``branches``, in order: each
    one's result cast to fp32 and back to its dtype. ``mesh`` must be
    None (one device)."""
    if mesh is not None:
        raise NotImplementedError(
            f"run_partitioned over the mesh axis {axis_name!r} needs a device "
            f"mesh; it waits on the ROADMAP.md item 'distribution, fleet and "
            f"bench'")
    outs = []
    for branch in branches:
        y = branch()
        outs.append(y.float().to(y.dtype))
    return outs
