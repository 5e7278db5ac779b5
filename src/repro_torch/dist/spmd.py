"""Explicit SPMD on a :class:`~repro_torch.launch.mesh.Mesh`: what GSPMD
does implicitly for the reference's sharded trainer.

The reference places its train state by ``train_state_specs`` and its
batches by ``batch_pspecs``, and XLA partitions the step over the mesh,
with ``constrain`` hinting activation layouts (``repro.train.trainer``,
``repro.dist.context``). This module has no reference counterpart: each
rank holds exactly the reference's block of every weight and moment
(``Rules.param_spec`` / ``opt_spec``), takes its rows of every batch, and
runs the collectives that the partitioned program would run, as named
calls of :mod:`repro_torch.dist.compat`:

- Over the batch axes (``pod``, ``data``). A weight sharded on its
  ``fsdp`` dim is cast to the compute dtype as a block, then all-gathered
  over ``data`` where a layer uses it (:meth:`Placement.gather`); the
  data ranks then compute on different rows, so the backward sums the
  cotangents over ``data`` (in fp32) and keeps the rank's block. A weight
  replicated over ``data`` gets its gradient summed after the backward
  (:meth:`Plan.reduce_grads`): all-reduced by the 2-D schedule of
  ``core/gradient_summation.py`` (reduce-scatter over ``data``, psum over
  ``pod``, all-gather) in replicated mode, reduce-scattered to its
  moment's ``data`` block (``Rules._wus_upgrade``) in wus mode, where Adam
  updates that block and the weight is all-gathered over ``data`` again.
- Over ``model``, the dense path. Attention splits its query and KV heads
  (``act_heads``) and the dense and GLU FFNs their hidden dim (``act_mlp``)
  by the rank's weight blocks. Without ``seq_parallel`` the residual
  stream is replicated: a layer enters through ``pvary`` (backward psum)
  and its row-parallel partial sum leaves through the invariant
  all-reduce (``compat.psum_invariant``). With it, the stream holds the
  rank's sequence block between layers (``seq_res``): a layer enters
  through an all-gather of the sequence (backward reduce-scatter) and
  leaves through a reduce-scatter (backward all-gather). Norms run on
  what the rank holds. In replicated mode the weights are whole on every
  rank, and a layer cuts the rank's heads or units from them (after a
  ``pvary``), as GSPMD partitions the activations. A dim that ``model``
  does not divide is replicated (the rules' divisibility fallback): KV
  heads then give each rank the heads its queries read, a layer whose
  heads or hidden dim do not split runs whole on every rank.
- The embedding and head (``vocab`` over ``model``) are gathered whole
  where used. The cross entropy runs on the rank's positions under
  ``seq_parallel``, else whole on every model rank.

The adjoint rule: after a gather over an axis, the backward sums over
that axis exactly when the axis's ranks then computed on different data
(rows, positions or heads); when they computed the same thing each rank
keeps its block with no sum (``compat.all_gather_invariant``). A weight
replicated over ``model`` whose ranks use it on different data enters
through ``pvary``. Each rank backpropagates its share of the global mean
loss (its rows' sum over the global batch), so the ranks' gradients sum
to the gradient of the global loss.

On a mesh whose ``model`` axis is larger than 1, MoE, Mamba and RWKV-6
layers raise ``NotImplementedError``; so does an enc-dec config on any
mesh (ROADMAP.md item 6.2). On the batch axes alone the MoE, Mamba and
RWKV-6 layers train like the dense ones: weights gathered at use, rows
local, and the MoE load-balance loss formed from the global batch's
means (:meth:`Placement.batch_mean`).
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import gradient_summation as GS
from repro_torch.dist import compat
from repro_torch.dist.compat import _all_gather, _all_reduce, _reduce_scatter
from repro_torch.dist.sharding import Rules, Spec, opt_state_specs, param_specs
from repro_torch.utils import tree_leaves, tree_map, tree_unflatten

BATCH_AXES = ("pod", "data")
KV_LEAVES = ("wk", "wv", "bk", "bv")
ROADMAP = "ROADMAP.md item 6.2"


def on(spec: Spec, axis: str) -> bool:
    """Whether some dim of ``spec`` is split over ``axis``."""
    return dim_of(spec, axis) is not None


def dim_of(spec: Spec, axis: str) -> Optional[int]:
    for d, e in enumerate(spec):
        if e is not None and axis in e:
            return d
    return None


def check_supported(cfg: ModelConfig, mesh, what: str = "train") -> None:
    """Raise ``NotImplementedError`` for what the sharded trainer (and,
    ``what="serve"``, the sharded serving engine) does not run yet: an
    enc-dec config on a mesh, and MoE, Mamba or RWKV-6 layers over a
    ``model`` axis larger than 1."""
    if cfg.is_encdec:
        raise NotImplementedError(
            f"{cfg.name}: the enc-dec family does not {what} on a mesh yet "
            f"({ROADMAP})")
    if mesh.shape.get("model", 1) > 1:
        kinds = sorted({s.mixer for s in cfg.block_pattern
                        if s.mixer in ("mamba", "rwkv6")}
                       | {"moe" for s in cfg.block_pattern if s.ffn == "moe"})
        if kinds:
            raise NotImplementedError(
                f"{cfg.name}: {'/'.join(kinds)} layers are not split over "
                f"a model axis of {mesh.shape['model']} yet ({ROADMAP}); "
                f"use a mesh whose model axis is 1")
    if "data" not in mesh.shape:
        noun = {"train": "training", "serve": "serving"}[what]
        raise ValueError(f"a {noun} mesh needs a 'data' axis; this one "
                         f"has {tuple(mesh.shape)}")


# --------------------------------------------------------------------------- #
# Blocks and rows.
# --------------------------------------------------------------------------- #
def _index(mesh, axes: Sequence[str]):
    """(row-major index of this rank over ``axes``, their product)."""
    idx, n = 0, 1
    for a in axes:
        idx = idx * mesh.shape[a] + mesh.axis_index(a)
        n *= mesh.shape[a]
    return idx, n


def block_slices(spec: Spec, shape, mesh):
    """This rank's slice of each dim of a tensor of ``shape`` under
    ``spec`` (a dim split over several axes takes them row-major)."""
    out = []
    for e, n in zip(spec, shape):
        if e is None:
            out.append(slice(None))
            continue
        idx, k = _index(mesh, e)
        out.append(slice(idx * (n // k), (idx + 1) * (n // k)))
    return tuple(out)


@torch.no_grad()
def shard_tree(tree, specs, mesh):
    """A full tree to this rank's blocks (fresh contiguous tensors, so
    the full tree can be freed)."""
    return tree_map(lambda t, s: t[block_slices(s, t.shape, mesh)].clone(
        memory_format=torch.contiguous_format), tree, specs)


def batch_rows(batch, mesh):
    """This rank's rows of a global batch (dict of arrays or tensors,
    rows on axis 0): block ``p * |data| + d`` of the batch axes, as
    ``batch_pspecs`` lays them out. Rows that the batch axes do not
    divide raise ``ValueError`` (the reference would replicate them)."""
    axes = [a for a in BATCH_AXES if a in mesh.shape]
    idx, n = _index(mesh, axes)
    B = next(iter(batch.values())).shape[0]
    if B % n:
        raise ValueError(f"a batch of {B} rows does not split over the "
                         f"{n} ranks of the batch axes {axes}")
    b = B // n
    return {k: v[idx * b:(idx + 1) * b] for k, v in batch.items()}


# --------------------------------------------------------------------------- #
# Differentiable gathers.
# --------------------------------------------------------------------------- #
class _GatherRows(torch.autograd.Function):
    """All-gather along dim 0 over an axis whose ranks then compute on
    different rows: the backward sums the cotangents over the axis in
    fp32 (C7) and keeps this rank's block."""

    @staticmethod
    def forward(ctx, x, group, n):
        ctx.group, ctx.n = group, n
        return _all_gather(x, group, n)

    @staticmethod
    def backward(ctx, dy):
        return (_reduce_scatter(dy.float(), ctx.group, ctx.n).to(dy.dtype),
                None, None)


def gather_rows(x, mesh, axis: str, dim: int):
    y = _GatherRows.apply(x.movedim(dim, 0), mesh.group(axis),
                          mesh.shape[axis])
    return y.movedim(0, dim)


class _Box:
    """A leaf wrapper, so a spec (a tuple) rides a tree walk whole."""
    __slots__ = ("v",)

    def __init__(self, v):
        self.v = v


def leaf_list(tree, specs) -> List[Spec]:
    """The specs of ``tree``'s leaves in :func:`tree_leaves` order."""
    return [b.v for b in tree_leaves(tree_map(lambda _, s: _Box(s), tree,
                                              specs))]


# --------------------------------------------------------------------------- #
# The forward's view of the mesh.
# --------------------------------------------------------------------------- #
class Placement:
    """What one forward of a rank needs of the mesh: the rank's blocks
    gathered where used, and the ``model`` axis's entries and exits.
    ``seq_len`` is the residual stream's length (media included);
    ``seq_parallel`` holds when the config asks for it, ``model`` is larger
    than 1 and divides it (else the stream is replicated, the rules'
    divisibility fallback)."""

    # The serving slab's layout where ``model`` does not divide the KV
    # heads (``dist.serving``); training computes the rank's KV heads only.
    kv_whole = False

    def __init__(self, plan: "Plan", seq_len: int):
        self.plan, self.mesh = plan, plan.mesh
        self.m = self.mesh.shape.get("model", 1)
        self.index = self.mesh.axis_index("model") if self.m > 1 else 0
        self.sp = (plan.rules.seq_parallel and self.m > 1
                   and seq_len % self.m == 0)
        self.seq_len = seq_len
        self.n_batch = _index(self.mesh, [a for a in BATCH_AXES
                                          if a in self.mesh.shape])[1]

    # ---- weights -------------------------------------------------------- #
    def gather(self, w, spec: Spec, *, whole: bool, split=None,
               vary: bool = False):
        """A weight block at use: gathered over ``data`` (sum adjoint); over
        ``model`` gathered too when ``whole`` (the vocabulary leaves; sum
        adjoint under ``seq_parallel``, else invariant), else kept as the
        rank's heads or hidden units. A weight replicated over ``model``
        that the layer splits on dim ``split`` (its heads or hidden units,
        ``act_heads`` / ``act_mlp``: replicated mode, where the weights are
        whole but the activations split) enters through ``pvary`` and is
        cut to the rank's slice; one that the model ranks use on different
        data (``seq_parallel``, or ``vary``) enters through ``pvary``."""
        d = dim_of(spec, "data")
        if d is not None:
            w = gather_rows(w, self.mesh, "data", d)
        return self.over_model(w, spec, whole=whole, split=split, vary=vary)

    def over_model(self, w, spec: Spec, *, whole: bool, split=None,
                   vary: bool = False):
        """:meth:`gather`'s ``model`` half."""
        if self.m == 1:
            return w
        d = dim_of(spec, "model")
        if d is not None:
            if whole:
                fn = compat.all_gather if self.sp else \
                    compat.all_gather_invariant
                w = fn(w, self.mesh, "model", dim=d)
            return w
        if split is not None or vary or self.sp:
            w = compat.pvary(w, self.mesh, "model")
        if split is not None:
            n = w.shape[split] // self.m
            w = w.narrow(split, self.index * n, n)
        return w

    def leaf(self, params, name: str):
        """A top-level entry (``embed``, ``head``, ``final_norm``) whole."""
        return tree_map(lambda w, s: self.gather(w, s, whole=True),
                        params[name], self.plan.pspecs[name])

    def layer(self, lp, i: int):
        """Layer ``i``'s tree as its ops read it: an attention layer's
        query heads (``wq``, ``bq``, ``wo``) split over ``model`` when it
        divides them, its KV heads too when it divides those, else the KV
        weights whole, entering through ``pvary`` (each rank reads only
        the KV heads of its queries); a dense FFN's hidden units (``wu``,
        ``wg``, ``wd``) when it divides them."""
        specs, cfg, m = self.plan.pspecs["layers"][i], self.plan.cfg, self.m
        heads = m > 1 and "wq" in lp["mixer"] and cfg.n_heads % m == 0
        kv = heads and cfg.n_kv_heads % m == 0
        mlp = (m > 1 and "wu" in lp.get("ffn", {}) and "router" not in
               lp["ffn"] and cfg.d_ff % m == 0)
        splits = {"mixer": dict(({"wq": 1, "bq": 0, "wo": 0} if heads
                                 else {}),
                                **({"wk": 1, "wv": 1, "bk": 0, "bv": 0}
                                   if kv else {})),
                  "ffn": {"wu": 1, "wg": 1, "wd": 0} if mlp else {}}
        kv_whole = heads and not kv
        return {part: {k: self.layer_leaf(
            lp, part, k, w, specs[part][k],
            split=splits.get(part, {}).get(k),
            vary=kv_whole and part == "mixer" and k in KV_LEAVES)
            for k, w in sub.items()} for part, sub in lp.items()}

    def layer_leaf(self, lp, part: str, name: str, w, spec: Spec, *, split,
                   vary):
        """Leaf ``name`` of ``lp[part]`` as the op reads it (:meth:`layer`)."""
        return self.gather(w, spec, whole=False, split=split, vary=vary)

    # ---- products ------------------------------------------------------- #
    # The layers multiply through these, so that a serving placement can
    # keep its weight blocks stationary (``dist.serving``); here the
    # weights are whole over ``data``.
    def proj_in(self, x, w):
        """x @ w, w's first dim the model width."""
        return x @ w

    def proj_out(self, h, w):
        """h @ w, w's last dim the model width."""
        return h @ w

    # ---- activations ---------------------------------------------------- #
    def seq_block(self, x):
        """The rank's block of a whole sequence (dim 1) under
        ``seq_parallel``; x itself otherwise."""
        if not self.sp:
            return x
        n = x.shape[1] // self.m
        return x[:, self.index * n:(self.index + 1) * n]

    def positions(self):
        """[lo, hi): the absolute positions of the rank's stream."""
        if not self.sp:
            return 0, self.seq_len
        n = self.seq_len // self.m
        return self.index * n, (self.index + 1) * n

    def enter(self, x, split: bool):
        """A layer's input: the whole sequence (``seq_parallel``: all-gather
        over ``model``, backward reduce-scatter), or the replicated stream
        entering per-rank heads (``split``: ``pvary``)."""
        if self.sp:
            return compat.all_gather(x, self.mesh, "model", dim=1)
        if split:
            return compat.pvary(x, self.mesh, "model")
        return x

    def exit(self, y, split: bool):
        """A layer's output to the stream: a ``split`` layer's partial sum
        reduce-scattered over the sequence (``seq_parallel``) or summed by
        the invariant all-reduce; a whole layer's output cut to the rank's
        sequence block (``seq_parallel``)."""
        if split:
            if self.sp:
                y = compat.psum_scatter(y.movedim(1, 0).contiguous(),
                                        self.mesh, "model")
                return y.movedim(0, 1)
            return compat.psum_invariant(y, self.mesh, "model")
        return self.seq_block(y)

    def loss_sum(self, v):
        """Per-example sums over the rank's positions to sums over the
        sequence, used alike by every model rank."""
        if not self.sp:
            return v
        return compat.psum_invariant(v, self.mesh, "model")

    def batch_mean(self, t):
        """The mean over the batch axes of a per-rank mean (each rank
        holds as many rows): the MoE load-balance loss's token means."""
        for a in BATCH_AXES:
            if a in self.mesh.shape:
                t = compat.psum(t, self.mesh, a)
        return t / self.n_batch


# --------------------------------------------------------------------------- #
# The state's layout and the update.
# --------------------------------------------------------------------------- #
class Plan:
    """The layout of one model's train state on a mesh: ``pspecs``, the
    weights' spec tree, and ``ospecs``, the moments', from the family's
    axes tree and the full shapes (``dist.sharding``), with the gradient
    reductions, the update views and the global norms of the mode."""

    def __init__(self, cfg: ModelConfig, rules: Rules, axes, shapes):
        self.cfg, self.rules, self.mesh = cfg, rules, rules.mesh
        self.mode = rules.mode
        self.pspecs = param_specs(axes, shapes, rules)
        self.ospecs = opt_state_specs(axes, shapes, rules)
        self._p = leaf_list(shapes, self.pspecs)
        self._o = leaf_list(shapes, self.ospecs)

    def _pod(self):
        return "pod" if "pod" in self.mesh.shape else None

    def _sums_after(self, i: int) -> Optional[int]:
        """The dim a wus leaf's moment takes ``data`` on, or None."""
        if self.mode != "wus" or on(self._p[i], "data"):
            return None
        return dim_of(self._o[i], "data")

    @torch.no_grad()
    def reduce_grads(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        """Each rank's gradient blocks (tree-leaf order) summed over the
        batch axes, in fp32, to the moments' blocks: an fsdp block's
        ``data`` sum ran in the gather's backward, so only ``pod`` is left;
        a wus leaf is reduce-scattered over ``data`` to its moment's block,
        then summed over ``pod``; every other leaf (all of them in
        replicated mode) goes through one 2-D all-reduce."""
        out, rest = list(grads), []
        pod = self._pod()
        for i, g in enumerate(grads):
            d = self._sums_after(i)
            if on(self._p[i], "data"):
                if pod:
                    out[i] = _all_reduce(g.float(), self.mesh.group(pod)
                                         ).to(g.dtype)
            elif d is not None:
                x = g.float().movedim(d, 0).contiguous()
                x = GS.reduce_scatter_2d(x, self.mesh, "data", pod)
                out[i] = x.movedim(0, d).to(g.dtype).contiguous()
            else:
                rest.append(i)
        if rest:
            summed = GS.gradient_allreduce_2d([grads[i] for i in rest],
                                              self.mesh, scatter_axis="data",
                                              reduce_axis=pod)
            for i, g in zip(rest, summed):
                out[i] = g
        return out

    def update_views(self, params) -> List[torch.Tensor]:
        """The weight blocks the optimizer updates (tree-leaf order): in
        wus mode a leaf's ``data`` block of its moment's dim (a view, so
        the update writes through), else the block itself."""
        views = []
        for i, w in enumerate(tree_leaves(params)):
            d = self._sums_after(i)
            if d is not None:
                n, k = w.shape[d] // self.mesh.shape["data"], \
                    self.mesh.axis_index("data")
                w = w.narrow(d, k * n, n)
            views.append(w)
        return views

    @torch.no_grad()
    def rebuild(self, params, views) -> None:
        """After a wus update: each leaf's updated ``data`` blocks
        all-gathered over ``data`` into the weight, in place."""
        group, n = self.mesh.group("data"), self.mesh.shape["data"]
        for i, (w, v) in enumerate(zip(tree_leaves(params), views)):
            d = self._sums_after(i)
            if d is not None:
                full = _all_gather(v.movedim(d, 0).contiguous(), group, n)
                w.copy_(full.movedim(0, d))

    def views_tree(self, params):
        return tree_unflatten(params, self.update_views(params))

    @torch.no_grad()
    def global_norm(self, leaves, *, moments: bool) -> torch.Tensor:
        """The L2 norm (fp32) of the whole tree whose blocks ``leaves``
        are (the moments' layout or the weights'): each block's squares
        summed over the axes it is split over, so every distinct block
        counts once."""
        specs = self._o if moments else self._p
        groups = {}
        for t, s in zip(leaves, specs):
            axes = tuple(a for a in self.mesh.axis_names if on(s, a))
            groups.setdefault(axes, []).append(t.float().square().sum())
        total = None
        for axes, parts in groups.items():
            v = torch.stack(parts).sum()
            for a in axes:
                v = _all_reduce(v, self.mesh.group(a))
            total = v if total is None else total + v
        return torch.sqrt(total)

    @torch.no_grad()
    def batch_sum(self, t):
        """A per-rank value summed over the batch axes (metrics)."""
        for a in BATCH_AXES:
            if a in self.mesh.shape:
                t = _all_reduce(t, self.mesh.group(a))
        return t


def plan_of(cfg: ModelConfig, mesh, axes, shapes) -> Plan:
    """The :class:`Plan` of ``cfg`` on ``mesh`` in the config's mode."""
    rules = Rules(mesh, cfg.param_sharding, seq_parallel=cfg.seq_parallel)
    return Plan(cfg, rules, axes, shapes)
