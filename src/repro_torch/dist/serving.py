"""The serving engine on a :class:`~repro_torch.launch.mesh.Mesh`: what
GSPMD does for the reference's ``Engine(cfg, params, rules, serve)``,
done by hand (``repro.serve.engine``, ``repro.train.steps:
make_serve_chunk_step``).

Every rank runs the same host loop (scheduler, page tables, prefix
index) on the same requests; only the model's programs are split.
Each rank holds its block of every weight (``train.steps.
param_specs_serving``: the rules of the mode) and of the caches:

- The paged pool keeps every page on every rank, and on each rank the
  KV heads of its queries: its block of the KV heads where ``model``
  divides them, else the KV heads its query heads read
  (``layers.rank_kv_heads``; all of them when the queries are not
  split). When the rank computes only its rows of the batch, the new
  K/V of every row are gathered over the batch axes before they are
  written, so every rank's pool holds every row's pages (a page the
  prefix cache shares may have been written by another rank's row).
- The slot slab holds the rank's block as ``train.steps.cache_pspecs``
  lays it out: its rows, and its KV heads where the mode puts them on
  ``model`` and ``model`` divides them; otherwise every KV head over the
  rank's block of slots (``kv_seq``), gathered whole for a decode step
  and written back.

The modes:

- ``tp2d`` (weight-stationary 2-D tensor parallelism). Weights live on
  both axes: the ``fsdp`` dim on ``data``, heads, hidden units and the
  vocabulary on ``model``; the batch is not split over ``data``, and
  the weights are never gathered. A product whose contraction dim is
  the rank's ``data`` block takes the rank's slice of the activations
  and sums the partial products over ``data``; one whose output dim is
  that block all-gathers the outputs over ``data``
  (:class:`StationaryPlacement`). The embedding looks up the rank's
  vocabulary rows and sums over ``model``; the head's logits of the
  rank's vocabulary block are all-gathered over ``model``. MoE, Mamba
  and RWKV-6 layers (served on the batch axes only) gather their
  ``data`` blocks at use.
- ``fsdp``, ``wus``, ``replicated``. Weights are gathered at use as the
  sharded trainer gathers them (``dist.spmd.Placement``); the batch is
  split over the batch axes (``pod``, ``data``): each rank computes its
  rows (slots) of the global batch, and the emitted tokens are
  all-gathered, so the host loop stays the same on every rank.

Over ``model`` every mode splits attention by heads and the dense FFN by
hidden units and sums the row-parallel partial products with an
all-reduce. The emitted tokens are taken, on every rank, from logits
that the collectives leave bitwise equal on every rank (all-gathers are
copies, and an all-reduce hands every rank the same sum); no token is
broadcast. ``check_ranks`` (a debug check the tests turn on) gathers
each step's tokens from every rank and raises if any differs from rank
0's; it corrects nothing.

MoE, Mamba and RWKV-6 layers over a ``model`` axis larger than 1, and an
enc-dec config on any mesh, raise ``NotImplementedError``
(``dist.spmd.check_supported``, ROADMAP.md item 6.2).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.dist.compat import _all_gather, _all_reduce
from repro_torch.dist.sharding import Rules
from repro_torch.dist.spmd import (
    KV_LEAVES,
    Placement,
    Plan,
    _index,
    block_slices,
    check_supported,
    dim_of,
)
from repro_torch.models import layers as L
from repro_torch.models import lm
from repro_torch.train.steps import ModelAPI, cache_pspecs
from repro_torch.utils import tree_map

BATCH_AXES = ("pod", "data")


def _gather_last(x, group, n):
    """The blocks of a group concatenated along x's last dim."""
    return _all_gather(x.movedim(-1, 0).contiguous(), group, n).movedim(0, -1)


@torch.no_grad()
def shard_blocks(tree, specs, mesh):
    """A full tree to this rank's blocks: a leaf the rank holds whole is
    kept as it is (serving never writes a weight), a block is copied
    out so the full tree can be freed."""
    def one(t, s):
        sl = block_slices(s, t.shape, mesh)
        if all(x.stop is None or x.stop - x.start == n
               for x, n in zip(sl, t.shape)):
            return t
        return t[sl].clone(memory_format=torch.contiguous_format)

    return tree_map(one, tree, specs)


class ServePlan:
    """The layout of one serving engine on a mesh: the rank's weight
    blocks (``params``), its rows of the batch (``rows``), its caches,
    and the placements the programs run under. ``max_batch`` must split
    over the batch axes of the mode."""

    def __init__(self, cfg: ModelConfig, rules: Rules, params, *,
                 max_batch: int, layout: str, check_ranks: bool = False):
        mesh = rules.mesh
        check_supported(cfg, mesh, "serve")
        self.cfg, self.rules, self.mesh, self.mode = cfg, rules, mesh, \
            rules.mode
        self.layout = layout
        self.check_ranks = check_ranks
        self.device = resolve_device(mesh.device_mesh.device_type)
        self.plan = Plan(cfg, rules, ModelAPI(cfg).param_axes(), params)
        self.params = shard_blocks(params, self.plan.pspecs, mesh)
        self.row_axes = [a for a in BATCH_AXES
                         if a in mesh.shape and a in rules.table["batch"]]
        idx, n = _index(mesh, self.row_axes)
        if max_batch % n:
            raise ValueError(
                f"max_batch={max_batch} slots do not split over the {n} "
                f"ranks of the batch axes {self.row_axes} ({self.mode})")
        b = max_batch // n
        self.local_batch = b
        self.rows = None if n == 1 else slice(idx * b, (idx + 1) * b)
        m = mesh.shape.get("model", 1)
        index = mesh.axis_index("model") if m > 1 else 0
        H, K = cfg.n_heads, cfg.n_kv_heads
        heads = m > 1 and H % m == 0
        self.pool_kv = (K // m if heads and K % m == 0
                        else len(L.rank_kv_heads(cfg, H // m, index))
                        if heads else K)
        # the slab's layout (``init_slab``): every KV head on every model
        # rank (``kv_whole``), its slots split over ``model`` (``slab_seq``)
        self.kv_whole = self.slab_seq = False
        self._full_slab = self._slab_specs = None

    # ---- rows ------------------------------------------------------------ #
    def all_rows(self, t):
        """Every rank's rows of ``t`` (rows on dim 0) concatenated in the
        batch axes' row-major order: ``data`` first, then ``pod``."""
        for a in reversed(self.row_axes):
            t = _all_gather(t.contiguous(), self.mesh.group(a),
                            self.mesh.shape[a])
        return t

    def emit(self, tok, rows: bool = True):
        """The step's tokens of every row from this rank's ``rows`` (or
        from every row, which it computed); with ``check_ranks`` every
        rank's are held to rank 0's."""
        if rows and self.rows is not None:
            tok = self.all_rows(tok)
        if self.check_ranks:
            world = dist.get_world_size()
            t = tok.reshape(-1).to(torch.int64)
            got = _all_gather(t, None, world).reshape(world, -1)
            bad = [r for r in range(world) if not torch.equal(got[r], got[0])]
            if bad:
                raise RuntimeError(
                    f"ranks {bad} emitted other tokens than rank 0: "
                    f"{got.tolist()}")
        return tok

    # ---- caches ---------------------------------------------------------- #
    def init_paged_cache(self, n_pages: int, page: int):
        return L.init_paged_kv_cache(self.cfg, n_pages, page,
                                     n_layers=self.cfg.n_layers,
                                     device=self.device, n_kv=self.pool_kv)

    def init_slab(self, max_batch: int, max_len: int):
        """The rank's block of the slot slab (``cache_pspecs``)."""
        full = lm.init_cache(self.cfg, max_batch, max_len, device="meta")
        self._full_slab = full
        self._slab_specs = cache_pspecs(self.cfg, full, self.rules)
        m = self.mesh.shape.get("model", 1)
        out = []
        for layer, specs in zip(full, self._slab_specs):
            if "slot_pos" in layer and m > 1:
                self.kv_whole = dim_of(specs["k"], "model") != 2
                self.slab_seq = dim_of(specs["k"], "model") == 1
            out.append({n: torch.full(
                t[block_slices(specs[n], t.shape, self.mesh)].shape,
                -1 if n == "slot_pos" else 0, dtype=t.dtype,
                device=self.device) for n, t in layer.items()})
        return out

    def write_slot(self, slab, cache, slot: int):
        """A prefilled one-request cache (``lm.prefill``'s, every slot of
        the sequence, the rank's KV heads or all of them) into ``slot``
        of the rank's slab, if the slot is one of its rows."""
        if self.rows is not None:
            if not self.rows.start <= slot < self.rows.stop:
                return slab
            slot -= self.rows.start
        for dst, src, full, specs in zip(slab, cache, self._full_slab,
                                         self._slab_specs):
            for n, t in dst.items():
                s = src[n]
                blk = block_slices(specs[n], full[n].shape, self.mesh)
                idx = tuple(blk[i] if s.shape[i] != t.shape[i] else slice(None)
                            for i in range(1, t.dim()))
                t[slot:slot + 1] = s[(slice(None),) + idx].to(t.dtype)
        return slab

    # ---- placements ------------------------------------------------------ #
    def placement(self, *, rows: bool) -> "ServePlacement":
        """The placement of one program: over the rank's ``rows`` (the
        batched steps), or the whole batch (a prefill's one request)."""
        cls = StationaryPlacement if self.mode == "tp2d" else ServePlacement
        return cls(self, self.rows if rows else None)


class ServePlacement(Placement):
    """A serving program's view of the mesh in the gathering modes
    (``fsdp``, ``wus``, ``replicated``): the rank's weight blocks gathered
    over ``data`` where used, heads and hidden units split over
    ``model``, the embedding and head gathered whole. ``rows`` is the
    rank's slice of the batch, or None when it computes every row."""

    batch_mean = None  # serving drops the MoE aux loss

    def __init__(self, serving: ServePlan, rows: Optional[slice]):
        super().__init__(serving.plan, 1)
        self.sp = False  # serving never splits the sequence
        self.serving, self.rows = serving, rows
        self.kv_whole = serving.kv_whole and serving.layout == "slab"

    def all_rows(self, t):
        return t if self.rows is None else self.serving.all_rows(t)

    def gather(self, w, spec, *, whole, split=None, vary=False):
        # A block gathered along a dim other than 0 comes back in the
        # gather's layout; the products read it in the weight's own, as
        # on one device, so the matrix kernels (and their sums) are the
        # same.
        return super().gather(w, spec, whole=whole, split=split,
                              vary=vary).contiguous()

    def layer_leaf(self, lp, part, name, w, spec, *, split, vary):
        if self.kv_whole and part == "mixer" and name in KV_LEAVES:
            split = None  # the slab keeps every KV head
        return super().layer_leaf(lp, part, name, w, spec, split=split,
                                  vary=vary)

    def embed(self, params, tokens):
        return lm._embed({"embed": self.leaf(params, "embed")}, tokens)

    def head(self, params, x):
        key = "head" if "head" in params else "embed"
        return lm._head({key: self.leaf(params, key)}, x)

    # ---- the slab over its slots ----------------------------------------- #
    def kv_full(self, cache):
        """A slab layer whose slots are split over ``model``, gathered."""
        if not self.serving.slab_seq:
            return cache
        group = self.mesh.group("model")
        return {n: _all_gather(t.movedim(1, 0).contiguous(), group,
                               self.m).movedim(0, 1).contiguous()
                for n, t in cache.items()}

    def kv_store(self, block, full) -> None:
        """The rank's slots of a gathered layer back into its block."""
        if full is block:
            return
        n = block["slot_pos"].shape[1]
        lo = self.index * n
        for name, t in block.items():
            t.copy_(full[name][:, lo:lo + n])


class StationaryPlacement(ServePlacement):
    """``tp2d``: no weight is gathered. Attention and the dense FFN
    multiply the rank's blocks in place (:meth:`proj_in`,
    :meth:`proj_out`); MoE, Mamba and RWKV-6 layers gather their ``data``
    blocks at use."""

    def gather(self, w, spec, *, whole, split=None, vary=False):
        return self.over_model(w, spec, whole=False, split=split, vary=vary)

    def layer_leaf(self, lp, part, name, w, spec, *, split, vary):
        if (part == "mixer" and "wq" in lp["mixer"]) or (
                part == "ffn" and "router" not in lp["ffn"]):
            return super().layer_leaf(lp, part, name, w, spec, split=split,
                                      vary=vary)
        return ServePlacement.gather(self, w, spec, whole=False, split=split,
                                     vary=vary)

    def proj_in(self, x, w):
        n = w.shape[0]
        if n == x.shape[-1]:
            return x @ w
        k = self.mesh.axis_index("data")
        return _all_reduce(x[..., k * n:(k + 1) * n] @ w,
                           self.mesh.group("data"))

    def proj_out(self, h, w):
        y = h @ w
        if y.shape[-1] == self.plan.cfg.d_model:
            return y
        return _gather_last(y, self.mesh.group("data"),
                            self.mesh.shape["data"])

    def embed(self, params, tokens):
        table = params["embed"]
        tokens = tokens.to(table.device, torch.long)
        n = table.shape[0]
        if n < self.plan.cfg.vocab:  # the rank's vocabulary rows
            t = tokens - self.index * n
            hit = (t >= 0) & (t < n)
            x = torch.where(hit[..., None], table[t.clamp(0, n - 1)],
                            torch.zeros((), dtype=table.dtype,
                                        device=table.device))
            x = _all_reduce(x, self.mesh.group("model"))
        else:
            x = table[tokens]
        if x.shape[-1] < self.plan.cfg.d_model:
            x = _gather_last(x, self.mesh.group("data"),
                             self.mesh.shape["data"])
        return x

    def head(self, params, x):
        w = params["head"] if "head" in params else params["embed"].T
        y = self.proj_in(x, w)
        if y.shape[-1] < self.plan.cfg.vocab:
            y = _gather_last(y, self.mesh.group("model"), self.m)
        return y
