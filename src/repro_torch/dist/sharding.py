"""Sharding-spec derivation: logical axis names -> specs (the port's
``repro.dist.sharding.Rules``, ``sharding.py:30-137``).

``Rules`` binds a mesh to the policy tables in :mod:`repro_torch.dist.rules`
and derives every spec from them, with two invariants enforced
mechanically:

  * divisibility fallback — a dimension whose size does not divide the
    product of its candidate mesh axes is replicated instead (e.g. 8 KV
    heads on a 16-way model axis);
  * each mesh axis is used at most once per spec — when two dimensions of
    one tensor map to the same mesh axis, the leftmost wins.

A spec is a tuple with one entry per dimension: the tuple of mesh-axis
names that dimension is split over, or None (replicated). The reference's
``PartitionSpec`` writes a single axis as its bare name; the port always
writes a tuple.

The tree-level :func:`param_specs` / :func:`opt_state_specs` lift the
per-tensor derivation to (axes, shapes) trees (``sharding.py:139-155``):
the sharded trainer (:mod:`repro_torch.dist.spmd`) places each rank's
blocks of the weights and of the optimizer moments by them.
"""
from __future__ import annotations

from typing import Any, Iterable, Optional, Sequence, Tuple, Union

from repro_torch.dist.rules import LAYER_AXIS, build_table, lookup
from repro_torch.dist.tagging import Axes
from repro_torch.utils import tree_map

Spec = Tuple[Optional[Tuple[str, ...]], ...]


class Rules:
    """Mesh-bound sharding rules: ``spec_for(names, shape) -> spec``.

    ``mesh`` needs only ``.shape`` (axis name -> size mapping) and
    ``.axis_names``: the port's ``launch.mesh.Mesh`` or any shape-only
    stand-in works, so spec logic is testable without a process group.
    """

    def __init__(self, mesh, mode: str = "fsdp",
                 seq_parallel: bool = False):
        self.mesh = mesh
        self.mode = mode
        self.seq_parallel = bool(seq_parallel)
        self.mesh_axes: Tuple[str, ...] = tuple(mesh.axis_names)
        self._sizes = dict(mesh.shape)
        self.table = build_table(self.mesh_axes, mode, self.seq_parallel)

    def axis_size(self, axes: Union[str, Iterable[str]]) -> int:
        """Product of mesh-axis sizes (1 for unknown axes / empty tuple)."""
        if isinstance(axes, str):
            axes = (axes,)
        n = 1
        for a in axes:
            n *= self._sizes.get(a, 1)
        return n

    def spec_for(self, names: Sequence[Optional[str]],
                 shape: Sequence[int]) -> Spec:
        """The spec of one tensor. ``names`` may be shorter than ``shape``
        (trailing dims replicated)."""
        used = set()
        padded = tuple(names) + (None,) * (len(shape) - len(names))
        return tuple(self._assign(name, dim, used)
                     for name, dim in zip(padded, shape))

    def _assign(self, name: Optional[str], dim: int, used: set):
        axes = tuple(
            a for a in lookup(self.table, name)
            if a not in used and a in self._sizes
        )
        if not axes:
            return None
        if dim % self.axis_size(axes) != 0:
            return None  # divisibility fallback: replicate this dim
        used.update(axes)
        return axes

    def param_spec(self, names: Sequence[Optional[str]],
                   shape: Sequence[int]) -> Spec:
        """Spec for a master-weight tensor under this mode."""
        if self.mode == "replicated":
            return (None,) * len(shape)
        if self.mode == "wus":
            # C1: weights replicated across the data axis; the all-gather
            # after the sharded update rebuilds them (Fig. 4).
            names = tuple(None if n == "fsdp" else n for n in names)
        return self.spec_for(names, shape)

    def opt_spec(self, names: Sequence[Optional[str]],
                 shape: Sequence[int]) -> Spec:
        """Spec for an optimizer-moment tensor under this mode."""
        if self.mode == "replicated":
            return (None,) * len(shape)
        spec = self.spec_for(names, shape)
        if self.mode == "wus":
            spec = self._wus_upgrade(spec, names, shape)
        return spec

    def _wus_upgrade(self, spec: Spec, names: Sequence[Optional[str]],
                     shape: Sequence[int]) -> Spec:
        """C1: ensure the moment carries the ``data`` axis.

        Tensors without a (divisible) ``fsdp`` dim get their largest
        divisible unsharded dim put on ``data`` so every weight's update
        is distributed across the data-parallel cores. The structural
        ``layer`` dim (scan stacking) is never eligible.
        """
        n_data = self._sizes.get("data", 1)
        if n_data <= 1:
            return spec
        if any("data" in e for e in spec if e is not None):
            return spec
        padded = tuple(names) + (None,) * (len(shape) - len(names))
        best = None
        for i, (e, name, dim) in enumerate(zip(spec, padded, shape)):
            if e is None and name != LAYER_AXIS and dim % n_data == 0:
                if best is None or dim > shape[best]:
                    best = i
        if best is None:
            return spec
        entries = list(spec)
        entries[best] = ("data",)
        return tuple(entries)


# --------------------------------------------------------------------------- #
# Tree-level derivation.
# --------------------------------------------------------------------------- #
def _tree_specs(fn, axes: Any, shapes: Any) -> Any:
    """``fn(names, shape)`` over an axes tree and a tree of one structure
    whose leaves have a ``shape`` (tensors, fake tensors, or anything
    with ``.shape``)."""
    return tree_map(lambda a, s: fn(a.names, tuple(s.shape)), axes, shapes,
                    is_leaf=lambda x: isinstance(x, Axes))


def param_specs(axes: Any, shapes: Any, rules: Rules) -> Any:
    """Spec tree of the master weights."""
    return _tree_specs(rules.param_spec, axes, shapes)


def opt_state_specs(axes: Any, shapes: Any, rules: Rules) -> Any:
    """Spec tree of the optimizer moments (the C1 upgrade in wus mode)."""
    return _tree_specs(rules.opt_spec, axes, shapes)
