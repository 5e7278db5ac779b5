"""Parameter trees of the port: nested dicts and lists with tensors at
the leaves (the JAX package's pytrees)."""
from __future__ import annotations

from typing import Any, Callable, List


def tree_map(fn: Callable, *trees, is_leaf: Callable = None) -> Any:
    """``fn`` over the leaves of trees of one structure; ``is_leaf``
    stops the walk at the nodes of the first tree it accepts."""
    head = trees[0]
    if is_leaf is not None and is_leaf(head):
        return fn(*trees)
    if isinstance(head, dict):
        return {k: tree_map(fn, *(t[k] for t in trees), is_leaf=is_leaf)
                for k in head}
    if isinstance(head, (list, tuple)):
        return type(head)(tree_map(fn, *xs, is_leaf=is_leaf)
                          for xs in zip(*trees))
    return fn(*trees)


def tree_leaves(tree) -> List[Any]:
    """Leaves in a fixed order: dict keys sorted, as ``jax.tree_util``
    flattens, so leaf lists of two trees of one structure line up."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in tree_leaves(t)]
    return [tree]


def tree_unflatten(template, leaves) -> Any:
    """A tree of ``template``'s structure whose leaves are ``leaves``, in
    :func:`tree_leaves` order (the inverse of ``tree_leaves``)."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return type(t)(build(x) for x in t)
        return next(it)

    return build(template)


class Stacked:
    """One array of the reference's layout that the port holds as
    ``parts``, one tensor per layer: the reference stacks the layers of
    a pattern position along a new leading axis. A tree leaf (the tree
    functions above do not descend into it); checkpoints save it as the
    stack and restore it into each part."""

    def __init__(self, parts):
        self.parts = list(parts)
        if not self.parts:
            raise ValueError("Stacked needs at least one part")

    @property
    def shape(self):
        return (len(self.parts), *self.parts[0].shape)

    @property
    def dtype(self):
        return self.parts[0].dtype


def count_params(init: Callable[[], Any]) -> int:
    """Parameters of the tree ``init()`` builds, reckoned from shapes:
    ``init`` runs under ``FakeTensorMode``, so no weight is allocated
    (the reference's ``jax.eval_shape`` count)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        return sum(w.numel() for w in tree_leaves(init()))
