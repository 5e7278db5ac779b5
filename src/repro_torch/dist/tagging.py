"""Named-axis parameter tagging (the port's ``repro.dist.tagging``).

Every parameter carries *logical* axis names, one a dimension
(``p(w, "fsdp", "mlp")``); the mapping from logical names to mesh axes
lives in :class:`repro_torch.dist.sharding.Rules`. A tagged leaf is the
pair ``(tensor, Axes)``, and :func:`split_tree` separates a tagged tree
into a values tree and an axes tree.

The port's models return untagged trees; each family gives its axes tree
beside its init (``models.lm.param_axes``, ``models.encdec.param_axes``,
from the per-layer ``layers.*_axes`` tagged as the reference's ``p(...)``
calls tag). Its layers are a list, one tree a layer, so the reference's
leading ``layer`` entry (:func:`stack_axes`) appears only where a tree in
the reference's stacked layout is built.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

from repro_torch.dist.rules import LAYER_AXIS
from repro_torch.utils import tree_map


@dataclasses.dataclass(frozen=True)
class Axes:
    """Logical axis names for one tensor, one entry per dimension.

    ``None`` marks a dimension with no sharding preference (replicated
    unless the optimizer-state C1 upgrade picks it). The tree functions
    of :mod:`repro_torch.utils` treat an ``Axes`` as a leaf."""

    names: Tuple[Optional[str], ...]

    def __post_init__(self):
        object.__setattr__(self, "names", tuple(self.names))

    def __iter__(self):
        return iter(self.names)

    def __len__(self) -> int:
        return len(self.names)

    def with_prefix(self, name: str) -> "Axes":
        return Axes((name,) + self.names)


def p(array: Any, *names: Optional[str]) -> Tuple[Any, Axes]:
    """Tag ``array`` with one logical axis name per dimension:
    ``p(w, "fsdp", "mlp")`` -> ``(w, Axes(("fsdp", "mlp")))``. The names
    may be fewer than the dimensions; the trailing ones are replicated."""
    return (array, Axes(tuple(names)))


def _is_tagged(leaf: Any) -> bool:
    return (isinstance(leaf, tuple) and len(leaf) == 2
            and isinstance(leaf[1], Axes))


def _leaf_axes(leaf: Any) -> Axes:
    if _is_tagged(leaf):
        return leaf[1]
    ndim = getattr(leaf, "ndim", None)
    return Axes((None,) * ndim if ndim is not None else ())


def split_tree(tree: Any) -> Tuple[Any, Any]:
    """``(values, axes)`` of a tagged tree. Untagged leaves pass through
    with all-``None`` axes, so it is safe on mixed trees and idempotent
    on values trees."""
    vals = tree_map(lambda l: l[0] if _is_tagged(l) else l, tree,
                    is_leaf=_is_tagged)
    axes = tree_map(_leaf_axes, tree, is_leaf=_is_tagged)
    return vals, axes


def retag_tree(vals: Any, axes: Any) -> Any:
    """The inverse of :func:`split_tree`."""
    return tree_map(lambda v, a: (v, a), vals, axes)


def stack_axes(axes: Any, name: str = LAYER_AXIS) -> Any:
    """Every ``Axes`` of the tree prefixed with a stacking axis (the
    reference's scan-stacked layers; ``layer`` maps to no mesh axis)."""
    return tree_map(lambda a: a.with_prefix(name), axes)
