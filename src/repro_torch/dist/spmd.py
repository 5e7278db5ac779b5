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

Over ``model``, the MoE, Mamba and RWKV-6 layers (:meth:`Placement.layer`)
enter and leave as the dense path does, the whole sequence entering
under ``seq_parallel`` (the scans and the MoE's groups of ``min(256, S)``
tokens need it):

- MoE. Where ``model`` divides the experts each rank holds its experts
  (``expert``), else, where it divides ``d_ff``, every expert's block of
  hidden units (``mlp``). The replicated router runs the gating whole on
  every rank, each rank multiplies its experts or units, and the
  combine's partial sum leaves as the dense FFN's. The load-balance
  loss, which every model rank forms alike from inputs that entered per
  rank, counts once (:meth:`Placement.once`).
- Mamba. Each rank holds its block of the inner channels (``mlp``): the
  per-channel leaves stay local; ``x_proj`` gives a partial sum over the
  rank's channels, summed over ``model`` by :meth:`Placement.model_sum`,
  whose backward sums as well, since each rank then uses the sum for its
  own channels; the scan runs on the rank's channels and ``out_proj`` is
  row-parallel.
- RWKV-6. Where ``model`` divides the heads each rank holds its heads
  (``wr``, ``wk``, ``wv``, ``wg`` and ``w2`` by columns, ``wo`` by rows;
  ``u``, ``w0`` and ``ln_scale`` narrowed to its channels; ``mu`` and
  ``w1`` used whole). Where it does not, the blocks are gathered and the
  layer runs on whole heads on every rank, as attention does, since the
  recurrence and the per-head norm need whole heads.

A layer whose dim ``model`` does not divide runs whole on every rank. On
the batch axes the MoE load-balance loss is formed from the global
batch's means (:meth:`Placement.batch_mean`).

The enc-dec family (whisper) runs its encoder's and decoder's layers
(``enc_blocks[i]``: ``attn``, ``ffn``; ``dec_blocks[i]``: ``self_attn``,
``cross_attn``, ``ffn``) as the decoder-only stack runs its attention and
dense FFNs, with one placement a stream: the encoder's (its frames) and
the decoder's (its tokens) each split their sequence under
``seq_parallel`` where ``model`` divides its own length, else keep it
whole. The encoder's output enters each cross-attention's rank heads
whole over the sequence (:meth:`Placement.enter_source`).

A batch whose rows the batch axes do not divide is replicated over them,
as the reference's ``batch_pspecs`` gives it no axis
(:func:`batch_rows`): every batch rank computes every row. Each rank's
loss then is 1/n of the global mean (the sum over its rows over B x n,
the rule for split rows too), so the gradient sums over the batch axes
(:meth:`Plan.reduce_grads`, the ``fsdp`` gathers' backward) add n
shares of 1/n: one device's gradient.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from repro_torch.configs.base import MambaConfig, ModelConfig, RWKV6Config
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
    """Raise ``ValueError`` for a mesh the sharded trainer (and,
    ``what="serve"``, the sharded serving engine) cannot run on: one
    without a ``data`` axis."""
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
    ``batch_pspecs`` lays them out. A batch whose rows the batch axes do
    not divide is returned whole: ``batch_pspecs``' divisibility fallback
    replicates it, and every batch rank computes every row (the loss
    share and the gradient sums then count each row once: module
    docstring)."""
    axes = [a for a in BATCH_AXES if a in mesh.shape]
    idx, n = _index(mesh, axes)
    B = next(iter(batch.values())).shape[0]
    if B % n:
        return dict(batch)
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


# The dims that ``model`` splits in a Mamba layer (its inner channels) and
# in an RWKV-6 layer whose heads it divides (``Placement.layout``).
MAMBA_SPLIT = {"wx": 1, "wz": 1, "conv_w": 1, "conv_b": 0, "x_proj": 0,
               "dt_w": 1, "dt_bias": 0, "A_log": 0, "D": 0, "out_proj": 0}
RWKV_SPLIT = {"wr": 1, "wk": 1, "wv": 1, "wg": 1, "w2": 1, "wo": 0, "u": 0,
              "w0": 0, "ln_scale": 0}
RWKV_BLOCKS = ("wr", "wk", "wv", "wg", "w2", "wo")  # the ``mlp`` leaves
NO_SPLIT = dict(split=None, vary=False, whole=False)


def _split(dim, *, vary=False, whole=False):
    return dict(split=dim, vary=vary, whole=whole)


class _Share(torch.autograd.Function):
    """The identity, whose backward divides the cotangent by ``n``."""

    @staticmethod
    def forward(ctx, x, n):
        ctx.n = n
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dy):
        return dy / ctx.n, None


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
        # an enc-dec decoder's placement: the encoder stream's
        self.source: Optional["Placement"] = None

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

    def layer(self, lp, i: int, stack: str = "layers", parts=None):
        """Layer ``i`` of ``params[stack]`` (``layers``, or an enc-dec's
        ``enc_blocks`` / ``dec_blocks``) as its ops read it, each leaf by
        :meth:`layout`: the rank's heads, units, experts or channels where
        ``model`` divides them, else the leaf as the layer needs it;
        ``parts`` keeps only those parts of it."""
        specs = self.plan.pspecs[stack][i]
        how = self.layout(lp)
        return {part: {k: self.layer_leaf(
            lp, part, k, w, specs[part][k],
            **how.get(part, {}).get(k, NO_SPLIT))
            for k, w in sub.items()} for part, sub in lp.items()
            if parts is None or part in parts}

    def layout(self, lp):
        """{part: {leaf: the keywords of :meth:`gather`}} of one layer
        (leaves left out take :data:`NO_SPLIT`): what ``model`` splits.

        - Attention (an LM's ``mixer``; an enc-dec's ``attn``,
          ``self_attn`` and ``cross_attn``): the query heads (``wq``,
          ``bq``, ``wo``) where ``model`` divides them, the KV heads too
          where it divides those, else the KV weights whole, entering
          through ``pvary`` (each rank reads only the KV heads of its
          queries).
        - A dense FFN: the hidden units (``wu``, ``wg``, ``wd``).
        - An MoE FFN: the experts (``act_expert``) where ``model`` divides
          them, else the hidden units (``act_mlp``); the router, used
          whole on every rank, enters through ``pvary``.
        - Mamba: the inner channels of every leaf.
        - RWKV-6: the heads (:data:`RWKV_SPLIT`; ``mu`` and ``w1``, used
          whole, through ``pvary``) where ``model`` divides them, else the
          :data:`RWKV_BLOCKS` gathered whole (``whole``).

        ``split`` names the dim of the rank's slice; it cuts only a leaf
        that the mode keeps whole over ``model`` (replicated mode), the
        others being the rank's blocks already."""
        cfg, m = self.plan.cfg, self.m
        if m == 1:
            return {}
        out = {}
        for part, sub in lp.items():
            if "wq" in sub:
                if cfg.n_heads % m == 0:
                    out[part] = self._attn_layout()
            elif "A_log" in sub:
                di = (cfg.mamba or MambaConfig()).expand * cfg.d_model
                if di % m == 0:
                    out[part] = {k: _split(d) for k, d in MAMBA_SPLIT.items()}
            elif "w0" in sub:
                if (cfg.d_model // (cfg.rwkv6 or RWKV6Config()).head_dim) % m:
                    out[part] = {k: _split(None, whole=True)
                                 for k in RWKV_BLOCKS}
                else:
                    out[part] = {k: _split(d) for k, d in RWKV_SPLIT.items()}
                    out[part].update(mu=_split(None, vary=True),
                                     w1=_split(None, vary=True))
            elif "router" in sub:
                E = cfg.moe.n_experts
                dims = ({"wu": 0, "wg": 0, "wd": 0} if E % m == 0 else
                        {"wu": 2, "wg": 2, "wd": 1} if cfg.d_ff % m == 0
                        else None)
                if dims:
                    out[part] = {k: _split(d) for k, d in dims.items()}
                    out[part]["router"] = _split(None, vary=True)
            elif "wu" in sub and cfg.d_ff % m == 0:
                out[part] = {"wu": _split(1), "wg": _split(1), "wd": _split(0)}
        return out

    def _attn_layout(self):
        """An attention's leaves split by heads (``model`` divides the
        query heads)."""
        cfg, m = self.plan.cfg, self.m
        mx = {"wq": 1, "bq": 0, "wo": 0}
        if cfg.n_kv_heads % m == 0:
            mx.update(wk=1, wv=1, bk=0, bv=0)
        out = {k: _split(d) for k, d in mx.items()}
        if cfg.n_kv_heads % m:
            out.update({k: _split(None, vary=True) for k in KV_LEAVES})
        return out

    def layer_leaf(self, lp, part: str, name: str, w, spec: Spec, *, split,
                   vary, whole):
        """Leaf ``name`` of ``lp[part]`` as the op reads it (:meth:`layer`)."""
        return self.gather(w, spec, whole=whole, split=split, vary=vary)

    def embed(self, params, tokens):
        """The token embeddings, the table gathered whole."""
        table = self.leaf(params, "embed")
        return table[tokens.to(table.device, torch.long)]

    def head(self, params, x):
        """The logits of x, the head (or the tied table) gathered whole."""
        if "head" in params:
            return x @ self.leaf(params, "head")
        return x @ self.leaf(params, "embed").T

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

    def enter_source(self, src, split: bool):
        """An enc-dec encoder's output (the :attr:`source` stream's)
        entering a cross-attention of this, the decoder's, stream: whole
        over its sequence on every rank, since each query reads every
        frame. Where the encoder's stream is split it is all-gathered
        over ``model``, with the sum adjoint when the model ranks then
        use it on different data (their heads, ``split``, or their
        sequence blocks' queries) and the invariant one otherwise; a
        replicated stream so used enters through ``pvary``."""
        if self.m == 1:
            return src
        vary = split or self.sp
        if self.source is not None and self.source.sp:
            fn = compat.all_gather if vary else compat.all_gather_invariant
            return fn(src, self.mesh, "model", dim=1)
        return compat.pvary(src, self.mesh, "model") if vary else src

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
        holds as many rows): the MoE load-balance loss's token means.
        Where the rows are whole on every batch rank (:func:`batch_rows`)
        the sum adds n equal means, so the quotient is the mean again, and
        each rank's aux term counts 1/n, as its nll does."""
        for a in BATCH_AXES:
            if a in self.mesh.shape:
                t = compat.psum(t, self.mesh, a)
        return t / self.n_batch

    def once(self, t, split: bool):
        """A value that every model rank forms alike from inputs that
        entered it per rank (``split``, or the sequence all-gathered under
        ``seq_parallel``): the MoE load-balance loss. Its gradient is
        shared out, 1/m a rank, so that the entries' backward sums count
        it once."""
        if self.m == 1 or not (split or self.sp):
            return t
        return _Share.apply(t, self.m)

    def heads_whole(self, t):
        """A serving state of the rank's heads (dim 1) gathered over
        ``model``: every head's (no gradient)."""
        y = _all_gather(t.movedim(1, 0).contiguous(),
                        self.mesh.group("model"), self.m)
        return y.movedim(0, 1).contiguous()

    def model_sum(self, t):
        """The sum over ``model`` of partial sums that each rank then uses
        for its own channels (Mamba's ``x_proj`` product): the backward
        sums the ranks' cotangents as well (``compat.psum``)."""
        return compat.psum(t, self.mesh, "model")


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
