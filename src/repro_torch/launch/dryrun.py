"""The dry run (``repro.launch.dryrun``): one rank's train, prefill and
decode steps for every (architecture x input shape) on the production
meshes, sized from one process, and the derived sharding-spec tables.

    python -m repro_torch run --arch gemma-7b --mode dryrun \
        --set dryrun.shape=train_4k [--mesh multipod]
    python -m repro_torch run --mode dryrun --set dryrun.all=true
    python -m repro_torch run --arch gemma-7b --mode dryrun \
        --set dryrun.specs=true [--mesh multipod]

The reference lowers and compiles each step for 256 or 512 placeholder
CPU devices and reads XLA's analyses. The port traces rank 0's step of
the mesh's real program (``dist.spmd``, ``dist.serving``) instead:

- **A fake world.** :func:`fake_world` opens a default process group of
  the ``fake`` backend (``torch.testing``'s ``FakeStore``) with the mesh's
  world size and this process as rank 0, and builds the port's
  :class:`~repro_torch.launch.mesh.Mesh` over ``init_device_mesh("cpu",
  ...)``. Collectives on it complete at once and move nothing. The dry
  run owns the process: an open default group raises ``RuntimeError``.
- **Fake tensors.** Everything runs under one ``FakeTensorMode`` on the
  CPU, so nothing is allocated and every kernel wrapper takes its plain
  version (the reference's dry run lowers its pure-JAX paths alike). A
  step that reads a value on the host (``.item()``, a data-dependent
  branch) raises, naming the line.
- *Train:* the state from the family's init, cut to the rank's blocks by
  ``spmd.plan_of`` / ``shard_tree``, and the mode's ``make_train_step``
  on the rank's rows of the global batch. *Prefill* and *decode:* the
  serving weights (cast to bf16 as the reference's dry run casts its
  stacked tree, :func:`serving_cast`) placed by ``dist.serving.ServePlan``,
  the slot slab's block for decode, and ``train.steps``'
  ``make_prefill_step`` / ``make_decode_step`` under the plan's
  placement. Serving runs the config's ``param_sharding``, or
  ``REPRO_SERVE_MODE`` where that is set.
- **FLOPs** come from ``FlopCounterMode`` over the step (forward and
  backward). Full-sequence attention counts what the reference's
  chunked path computes: the (query, key) pairs of the KV chunks each
  query chunk visits, which block skipping halves for a causal prefill
  (:func:`attention_as_chunks`). The Mamba scan and the RWKV-6
  recurrence, plain Python loops over the positions, are traced as one
  product each with their loops' counted flops and their outputs' shapes
  (:func:`recurrences_as_shapes`).
  **Collectives** from a dispatch mode over the ``c10d`` ops: the
  bytes of each op's result on this rank, summed by the reference's kind
  names (``all-gather``, ``all-reduce``, ``reduce-scatter``,
  ``collective-permute`` for the point-to-point pairs of a ``ppermute``,
  ``all-to-all``).
- **Memory.** Arguments: the bytes of the rank's state (or serving
  weights and cache) and its batch rows or token rows. Outputs: the bytes
  of the returned tree (the train state is updated in place and returned,
  so it counts again, as a donated state does in the reference). Peak:
  the high-water mark of live storage bytes during the step, the
  arguments included; temporary: peak minus arguments. The reference's
  ``peak`` is arguments + outputs + temporaries, so a donated state
  counts twice there; the port's counts live bytes once. Attention
  holds the chunked path's working set (one block of fp32 logits, the
  fp32 accumulators and copies of q, k and v), not (B, H, Sq, Sk) scores,
  and keeps for the backward what the flash kernels keep (q, k, v, the
  output and the log-sum-exp).

The reference's ``hbm_bytes_accessed_per_device`` has no counterpart
here, and its ``lower_s`` / ``compile_s`` become one ``trace_s``. The
dry run touches no device: it builds fake CPU tensors whatever
``--device`` says, as the reference compiles for placeholder CPU
devices.

The spec tables (``spec_table``) list every parameter's logical axes and
the specs ``dist.sharding.Rules`` derives for its master weight and its
optimizer moments. Specs print in the reference's ``PartitionSpec(...)``
form; rows are in the port's layout, one tree a layer
(``['layers'][i]...``), where the reference stacks a pattern position's
layers under a leading ``layer`` dim.
"""
from __future__ import annotations

import argparse
import contextlib
import math
import os
import sys
import time
import traceback
import warnings
import weakref
from collections import defaultdict
from typing import Dict, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import get_config

# c10d op (the calls of ``dist.compat``) -> the reference's collective
# kind; an op not listed is recorded under its own name. A ``send``
# carries no result: a point-to-point pair counts at its ``recv_``.
COLLECTIVE_KINDS = {
    "_allgather_base_": "all-gather",
    "allreduce_": "all-reduce",
    "_reduce_scatter_base_": "reduce-scatter",
    "recv_": "collective-permute",
    "alltoall_base_": "all-to-all",
}


class ShapeMesh:
    """Shape-only mesh: ``shape`` (axis name -> size) and ``axis_names``,
    all ``Rules`` reads."""

    def __init__(self, shape, names):
        self.shape = dict(zip(names, shape))
        self.axis_names = tuple(names)


# --------------------------------------------------------------------------- #
# Derived sharding-spec tables (--set dryrun.specs=true).
# --------------------------------------------------------------------------- #
def partition_spec_str(spec) -> str:
    """A port spec (one tuple of mesh axes or None a dim) as the
    reference prints its ``PartitionSpec``: the tuple of its entries, a
    single axis by its bare name."""
    return "PartitionSpec" + repr(tuple(
        e if e is None else e[0] if len(e) == 1 else tuple(e)
        for e in spec))


def _leaves(tree, path=""):
    """(keystr path, leaf) of a dict/list tree, keys sorted, as
    ``jax.tree_util.keystr`` writes the path."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)) and not hasattr(tree, "names"):
        for i, t in enumerate(tree):
            yield from _leaves(t, f"{path}[{i}]")
    else:
        yield path, tree


def spec_table(arch: str, *, multi_pod: bool = False, mode: str = None
               ) -> Tuple[Dict, List[Dict]]:
    """Rows of (param, shape, logical axes, param spec, opt spec)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.dist.sharding import Rules
    from repro_torch.launch.mesh import production_mesh_shape
    from repro_torch.train.steps import ModelAPI

    cfg = get_config(arch)
    mesh = ShapeMesh(*production_mesh_shape(multi_pod=multi_pod))
    mode = mode or cfg.param_sharding
    rules = Rules(mesh, mode, seq_parallel=cfg.seq_parallel)
    api = ModelAPI(cfg)
    with FakeTensorMode():
        params = api.init(cfg, 0, device="cpu", dtype=torch.float32)
    shapes = dict(_leaves(params))
    rows = []
    for path, a in _leaves(api.param_axes()):
        shape = tuple(shapes[path].shape)
        rows.append({
            "param": path,
            "shape": shape,
            "axes": tuple(a.names),
            "param_spec": partition_spec_str(rules.param_spec(a.names,
                                                              shape)),
            "opt_spec": partition_spec_str(rules.opt_spec(a.names, shape)),
        })
    meta = {
        "arch": arch,
        "mode": mode,
        "seq_parallel": cfg.seq_parallel,
        "mesh": {a: int(mesh.shape[a]) for a in mesh.axis_names},
    }
    return meta, rows


def print_spec_table(arch: str, *, multi_pod: bool = False,
                     mode: str = None):
    meta, rows = spec_table(arch, multi_pod=multi_pod, mode=mode)
    mesh_desc = ",".join(f"{a}={n}" for a, n in meta["mesh"].items())
    print(f"== spec table: {arch} (mode={meta['mode']}, "
          f"seq_parallel={meta['seq_parallel']}, mesh {mesh_desc}) ==")
    hdr = f"{'param':44s} {'shape':22s} {'axes':28s} {'param_spec':26s} opt_spec"
    print(hdr)
    print("-" * len(hdr))
    for r in rows:
        print(f"{r['param']:44s} {str(r['shape']):22s} "
              f"{str(r['axes']):28s} {r['param_spec']:26s} {r['opt_spec']}")
    sys.stdout.flush()
    return meta, rows


# --------------------------------------------------------------------------- #
# The fake world and what is recorded in it.
# --------------------------------------------------------------------------- #
@contextlib.contextmanager
def fake_world(mesh_shape: Dict[str, int]):
    """A :class:`~repro_torch.launch.mesh.Mesh` of ``mesh_shape`` (axis
    name -> size) over a ``fake`` default group in which this process is
    rank 0; the group is destroyed on exit."""
    import torch.distributed as dist

    world = math.prod(mesh_shape.values())
    if dist.is_available() and dist.is_initialized():
        raise RuntimeError(
            f"the dry run opens a fake world of {world} "
            f"ranks and must own the process, but a default process group "
            f"({dist.get_backend()}, {dist.get_world_size()} rank(s)) is "
            f"already up: run `python -m repro_torch run --mode dryrun ...` "
            f"as its own command")
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.launch.mesh import Mesh

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield Mesh(init_device_mesh("cpu", tuple(mesh_shape.values()),
                                    mesh_dim_names=tuple(mesh_shape)))
    finally:
        dist.destroy_process_group()


def _tensors(x):
    if torch.is_tensor(x):
        yield x
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)


def tree_bytes(tree) -> int:
    """Bytes of the distinct storages the tensors of ``tree`` hold."""
    seen = {}
    for t in _tensors(tree):
        st = t.untyped_storage()
        seen[st._cdata] = st.nbytes()
    return sum(seen.values())


class CollectiveRecorder(TorchDispatchMode):
    """Bytes and counts of this rank's collective results, by kind. Over
    a real step on a real process group it counts what the dry run
    counts."""

    def __init__(self):
        super().__init__()
        self.bytes = defaultdict(int)
        self.counts = defaultdict(int)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.namespace == "c10d":
            name = func.name().split("::")[-1]
            if name != "send":
                kind = COLLECTIVE_KINDS.get(name, name)
                self.bytes[kind] += sum(t.numel() * t.element_size()
                                        for t in _tensors(args[0]))
                self.counts[kind] += 1
        return func(*args, **(kwargs or {}))


class LiveBytes(TorchDispatchMode):
    """The high-water mark of live storage bytes: ``base`` (the bytes of
    ``held``, the arguments, live throughout) plus every storage an op
    makes, until it is freed."""

    def __init__(self, held, base: int):
        super().__init__()
        self.live = self.peak = base
        self._seen = {t.untyped_storage()._cdata for t in _tensors(held)}

    def _free(self, key, n):
        self._seen.discard(key)
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in _tensors(out):
            st = t.untyped_storage()
            key = st._cdata
            if key not in self._seen:
                self._seen.add(key)
                n = st.nbytes()
                self.live += n
                self.peak = max(self.peak, self.live)
                weakref.finalize(st, self._free, key, n)
        return out


@contextlib.contextmanager
def _fresh(cached):
    """An ``lru_cache`` emptied on the way in and on the way out."""
    cached.cache_clear()
    try:
        yield
    finally:
        cached.cache_clear()


@contextlib.contextmanager
def _set_aside(table: dict):
    """A module's cache dict emptied for the block, its entries put back
    after it."""
    kept = dict(table)
    table.clear()
    try:
        yield
    finally:
        table.clear()
        table.update(kept)


# --------------------------------------------------------------------------- #
# The recurrences as their outputs' shapes.
# --------------------------------------------------------------------------- #
def _products(rows, m, k, n, dtype):
    """One (rows, m, k) @ (rows, k, n) product of empty operands: the
    flops ``FlopCounterMode`` gives the plain loops' per-step products,
    in one op."""
    a = torch.empty((rows, m, k), dtype=dtype)
    return torch.bmm(a, torch.empty((rows, k, n), dtype=dtype))


def scan_shapes(u, dt, A, B, C, D, *, state_every=None):
    """``kernels.mamba.mamba_scan_torch``'s outputs (y in u's dtype, h, and
    the boundary states with ``state_every``) from one product with the
    flops of its S per-step ``einsum`` s, 2 Bt S Di N."""
    Bt, S, Di = u.shape
    N = A.shape[-1]
    y = _products(Bt, Di, N, S, torch.float32).transpose(1, 2).to(u.dtype)
    h = torch.empty((Bt, Di, N), dtype=torch.float32)
    if not state_every:
        return y, h
    from repro_torch.kernels.mamba import n_saved_states

    hs = torch.empty((Bt, n_saved_states(S, state_every), Di, N),
                     dtype=torch.float32)
    return y, h, hs


def scan_bwd_shapes(u, dt, A, B, C, D, hs, dy, dh=None, *, state_every):
    """``kernels.mamba.mamba_scan_bwd_torch``'s gradients (du in u's dtype,
    the others fp32) from one product with the flops of its rebuilt
    forward and its two backward ``einsum`` s a step, 6 Bt S Di N."""
    Bt, S, Di = u.shape
    N = A.shape[-1]
    _products(Bt, Di, N, 3 * S, torch.float32)
    f32 = torch.float32
    return (torch.empty_like(u), torch.empty(dt.shape, dtype=f32),
            torch.empty(A.shape, dtype=f32), torch.empty(B.shape, dtype=f32),
            torch.empty(C.shape, dtype=f32), torch.empty(D.shape, dtype=f32))


class _WkvShapes(torch.autograd.Function):
    """``models.layers._rwkv_wkv_scan`` as its outputs' shapes, with the
    flops of its per-step ``einsum`` s: 2 B S H dh^2 forward; backward
    twice that, and once more where ``chunked_scan`` recomputes its
    chunks (more than one chunk of 64)."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, H, dh):
        B, S, d = r.shape
        ctx.passes = 3 if S > 64 else 2
        ctx.shape = (B, S, H, dh)
        y = _products(B * H, dh, dh, S, torch.float32)
        y = y.reshape(B, H, dh, S).permute(0, 3, 1, 2).reshape(B, S, d)
        return y, torch.empty((B, H, dh, dh), dtype=torch.float32)

    @staticmethod
    def backward(ctx, dy, dstate):
        B, S, H, dh = ctx.shape
        _products(B * H, dh, dh, ctx.passes * S, torch.float32)
        g = torch.empty((B, S, H * dh), dtype=torch.float32)
        return (g, torch.empty_like(g), torch.empty_like(g),
                torch.empty_like(g), torch.empty((H * dh,),
                                                 dtype=torch.float32),
                None, None)


def wkv_shapes(r, k, v, w, u, H: int, dh: int):
    return _WkvShapes.apply(r, k, v, w, u, H, dh)


@contextlib.contextmanager
def recurrences_as_shapes():
    """The plain Mamba scan (forward and backward) and RWKV-6 wkv
    recurrence replaced by :func:`scan_shapes`, :func:`scan_bwd_shapes`
    and :func:`wkv_shapes` while a step is traced: their Python loops
    over every position cost seconds a layer under fake tensors (jamba's
    ``train_4k`` would trace for hours), and the outputs, the flops
    ``FlopCounterMode`` counts and the bytes the kernels hold (their
    outputs, not the loops' per-step temporaries) are all the dry run
    reads of them."""
    from repro_torch.kernels import mamba
    from repro_torch.models import layers

    swaps = ((mamba, "mamba_scan_torch", scan_shapes),
             (mamba, "mamba_scan_bwd_torch", scan_bwd_shapes),
             (layers, "_rwkv_wkv_scan", wkv_shapes))
    kept = [getattr(mod, name) for mod, name, _ in swaps]
    for mod, name, fn in swaps:
        setattr(mod, name, fn)
    try:
        yield
    finally:
        for (mod, name, _), fn in zip(swaps, kept):
            setattr(mod, name, fn)


# --------------------------------------------------------------------------- #
# Attention as the reference's chunked path computes it.
# --------------------------------------------------------------------------- #
CHUNK = 512  # ``repro.kernels.ops.attention``'s ``chunk``


def chunk_band(Sq: int, Sk: int, *, causal: bool, window, q_offset: int,
               k_offset: int, chunk: int = CHUNK):
    """(the (query, key) position pairs ``_chunked_attention`` computes,
    the query rows of its logits block): with ``ck = min(chunk, Sk)``
    and the keys padded to whole chunks, a causal call of ``Sq > ck``
    queries visits, for each ``ck``-query chunk, only the KV chunks its
    causal and window band reaches (every position of each counted, as
    the path computes it, masked or not), one (ck, ck) block at a time;
    any other call scans every KV chunk for all ``Sq`` queries at once
    (``repro/kernels/ops.py:53-148``)."""
    ck = min(chunk, Sk)
    n_chunks = -(-Sk // ck)
    if not (causal and Sq > ck):
        return Sq * n_chunks * ck, Sq
    pairs = 0
    for q_lo in range(0, Sq, ck):
        q_hi = min(Sq, q_lo + ck)
        chunk_hi = min(n_chunks, (q_offset + q_hi - 1 - k_offset) // ck + 1)
        chunk_lo = 0
        if window is not None:
            lo_pos = max(q_offset + q_lo - window + 1 - k_offset, 0)
            chunk_lo = min(max(lo_pos // ck, 0), chunk_hi)
        pairs += (q_hi - q_lo) * max(chunk_hi - chunk_lo, 0) * ck
    return pairs, ck


def _pair_products(rows: int, pairs: int, D: int, n: int) -> None:
    """``n`` products of 2 D flops a (query, key) pair over ``rows``
    (batch x heads) rows: ``FlopCounterMode`` counts a bmm by its shapes,
    and these operands are views of one element, so nothing of their
    size is held."""
    one = torch.empty((1, 1, 1), dtype=torch.float32)
    for _ in range(n):
        torch.bmm(one.expand(rows, 1, pairs * D), one.expand(rows, pairs * D,
                                                             1))


class _ChunkedAttentionShapes(torch.autograd.Function):
    """``flash_attention_torch`` as the reference's chunked path costs it
    (:func:`chunk_band`): the output's shape and dtype; forward flops
    4 D a visited (query, key) pair and head (the two einsums), backward
    8 D (``jax.grad`` of them: two products each); and the fp32 working
    set the path holds at once, made and dropped so that the live-bytes
    peak sees it: q, the padded k and v and the output in fp32, one
    logits block and its probabilities of (B, rows, H, ck), the running
    max, sum and accumulator of those rows. For the backward it keeps
    what the card's flash kernels keep: q, k, v, the output and the fp32
    log-sum-exp (B, H, Sq), not the scores; its backward holds fp32 dq,
    dk and dv and one block's scores, probabilities and their
    gradient."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset, k_offset, scale):
        B, Sq, H, D = q.shape
        Sk, K = k.shape[1], k.shape[2]
        pairs, rows = chunk_band(Sq, Sk, causal=causal, window=window,
                                 q_offset=q_offset, k_offset=k_offset)
        ck = min(CHUNK, Sk)
        ctx.cost = (B * H, pairs, D, B, Sq, Sk, H, K, rows, ck)
        f32 = torch.float32
        held = [torch.empty((B, Sq, H, D), dtype=f32),
                torch.empty((2, B, -(-Sk // ck) * ck, K, D), dtype=f32),
                torch.empty((B, Sq, H, D), dtype=f32),
                torch.empty((B, rows, H, D + 2), dtype=f32),
                torch.empty((2, B, rows, H, ck), dtype=f32)]
        _pair_products(B * H, pairs, D, 2)
        del held
        out = torch.empty_like(q)
        ctx.lse = torch.empty((B, H, Sq), dtype=f32)
        ctx.save_for_backward(q, k, v, out)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, _ = ctx.saved_tensors
        rows_bh, pairs, D, B, Sq, Sk, H, K, rows, ck = ctx.cost
        f32 = torch.float32
        held = [torch.empty((B, Sq, H, D), dtype=f32),
                torch.empty((2, B, Sk, K, D), dtype=f32),
                torch.empty((3, B, rows, H, ck), dtype=f32)]
        _pair_products(rows_bh, pairs, D, 4)
        del held
        return (torch.empty_like(q), torch.empty_like(k),
                torch.empty_like(v), None, None, None, None, None)


def chunked_attention_shapes(q, k, v, *, causal=True, window=None,
                             q_offset=0, k_offset=0, scale=None):
    """:class:`_ChunkedAttentionShapes` with
    ``flash_attention_torch``'s signature."""
    return _ChunkedAttentionShapes.apply(q, k, v, causal, window, q_offset,
                                         k_offset, scale)


@contextlib.contextmanager
def attention_as_chunks():
    """The plain full-sequence attention (``kernels.flash_attention.
    flash_attention_torch``, the core of ``layers.attention_full``: the
    LMs' attention layers, whisper's encoder, decoder self- and
    cross-attention, the prefills) replaced by
    :func:`chunked_attention_shapes` while a step is traced: the plain
    version holds (B, H, Sq, Sk) fp32 scores and counts every masked
    key, where the reference's dry run lowers ``_chunked_attention``
    (O(S) memory, and block skipping that halves a causal prefill's
    flops) and the card's flash kernels hold no score matrix either. A
    decode step's attention (``ops.decode_attention``, the slab layout
    the dry run serves from) is the reference's own plain path, one
    query against every slot, and stays as it is; the paged and
    cross-chunk cores run only in the paged chunk program, which the dry
    run does not trace."""
    from repro_torch.kernels import flash_attention

    kept = flash_attention.flash_attention_torch
    flash_attention.flash_attention_torch = chunked_attention_shapes
    try:
        yield
    finally:
        flash_attention.flash_attention_torch = kept


def _host_read(e: BaseException) -> str:
    """The innermost line outside torch that the exception passed."""
    lib = os.path.dirname(os.path.abspath(torch.__file__))
    here = os.path.abspath(__file__)
    where = "the step"
    for fr in traceback.extract_tb(e.__traceback__):
        f = os.path.abspath(fr.filename)
        if not f.startswith(lib) and f != here:
            where = f"{fr.filename}:{fr.lineno} ({fr.line})"
    return where


# --------------------------------------------------------------------------- #
# One rank's steps.
# --------------------------------------------------------------------------- #
def _train_step(cfg, shape, mesh):
    """(the step, its arguments, the arguments as counted)."""
    from repro_torch.dist import spmd
    from repro_torch.launch import specs as S
    from repro_torch.train import steps as T

    spmd.check_supported(cfg, mesh)
    optimizer = T.make_optimizer(cfg)
    api = T.ModelAPI(cfg)
    params = api.init(cfg, 0, device="cpu",
                      dtype=getattr(torch, cfg.param_dtype))
    plan = spmd.plan_of(cfg, mesh, api.param_axes(), params)
    blocks = spmd.shard_tree(params, plan.pspecs, mesh)
    state = {"params": blocks, "opt": optimizer.init(plan.views_tree(blocks))}
    batch = {k: v.clone() for k, v in spmd.batch_rows(
        S.batch_structure(cfg, shape), mesh).items()}
    step = T.make_train_step(cfg, optimizer, plan=plan)
    return (lambda: step(state, batch)), (state, batch), (state, batch)


def serving_cast(tree, stacked: bool = False):
    """Serving checkpoints are bf16: the fp32 leaves that the reference's
    dry run casts, which are those of two or more dims in its layout,
    where each layer list is stacked under a leading ``layer`` dim (a
    layer's norm scale is one such leaf)."""
    if isinstance(tree, dict):
        return {k: serving_cast(v, stacked) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [serving_cast(v, True) for v in tree]
    if tree.dtype == torch.float32 and tree.dim() + stacked > 1:
        return tree.to(torch.bfloat16)
    return tree


def _serve_step(cfg, shape, mesh, mode):
    """As :func:`_train_step`; a decode step is handed every row's token
    and counted with its own rows'."""
    from repro_torch.dist.serving import ServePlan
    from repro_torch.dist.sharding import Rules
    from repro_torch.launch import specs as S
    from repro_torch.train import steps as T

    rules = Rules(mesh, mode, seq_parallel=cfg.seq_parallel)
    params = serving_cast(T.ModelAPI(cfg).init(cfg, 0, device="cpu",
                                               dtype=torch.float32))
    plan = ServePlan(cfg, rules, params, max_batch=shape.global_batch,
                     layout="slab")
    del params
    weights = plan.params
    if shape.kind == "prefill":
        place = plan.placement(rows=True)
        batch = S.batch_structure(cfg, shape)
        if place.rows is not None:
            batch = {k: v[place.rows].clone() for k, v in batch.items()}
        step = T.make_prefill_step(cfg, shape, rules)
        return ((lambda: step(weights, batch, place)), (weights, batch),
                (weights, batch))
    cache = plan.init_slab(shape.global_batch, shape.seq_len,
                           cfg.effective_window(shape))
    place = plan.placement(rows=True)
    d = S.decode_structure(cfg, shape)
    token, pos = d["token"], d["pos"]
    rows = token if place.rows is None else token[place.rows].clone()
    step = T.make_decode_step(cfg, shape, rules)
    return ((lambda: step(weights, token, cache, pos, place)),
            (weights, token, cache, pos), (weights, rows, cache, pos))


def dryrun_step(cfg, shape, mesh_shape: Dict[str, int], mode: str = None
                ) -> Dict:
    """Trace rank 0's step of ``shape.kind`` for ``cfg`` on a fake world
    of ``mesh_shape`` (axis name -> size) in ``mode`` (default: the
    config's ``param_sharding``; for serving ``REPRO_SERVE_MODE`` where
    set). Returns the dry run's measured keys."""
    import dataclasses

    from torch._subclasses.fake_tensor import (
        DataDependentOutputException,
        DynamicOutputShapeException,
        FakeTensorMode,
    )
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.models import encdec, layers

    if mode is None:
        mode = cfg.param_sharding
        if shape.kind != "train" and os.environ.get("REPRO_SERVE_MODE"):
            mode = os.environ["REPRO_SERVE_MODE"]
    t0 = time.perf_counter()
    # the rotary and sinusoid tables are cached a (width, theta or dtype,
    # device): tensors made under the fake mode must not outlive it, nor
    # real ones enter it
    with warnings.catch_warnings(), _fresh(layers._rope_tables), \
            _set_aside(encdec._SIN_TABLES), recurrences_as_shapes(), \
            attention_as_chunks(), \
            fake_world(mesh_shape) as mesh, FakeTensorMode():
        # c10d's deprecation notes on the collectives the port calls
        warnings.simplefilter("ignore", FutureWarning)
        if shape.kind == "train":
            cfg = dataclasses.replace(cfg, param_sharding=mode)
            run, passed, counted = _train_step(cfg, shape, mesh)
        else:
            run, passed, counted = _serve_step(cfg, shape, mesh, mode)
        args = tree_bytes(counted)
        coll = CollectiveRecorder()
        live = LiveBytes(passed, args)
        try:
            with FlopCounterMode(display=False) as flops, coll, live:
                out = run()
        except (DataDependentOutputException,
                DynamicOutputShapeException) as e:
            raise RuntimeError(
                f"{cfg.name} x {shape.name}: the step reads a value on the "
                f"host at {_host_read(e)}; a dry-run step must not") from e
        result = {
            "devices": math.prod(mesh_shape.values()),
            "mode": mode,
            "flops_per_device": float(flops.get_total_flops()),
            "collective_bytes_per_device": dict(coll.bytes),
            "collective_counts": dict(coll.counts),
            "argument_bytes_per_device": args,
            "output_bytes_per_device": tree_bytes(out),
            "temp_bytes_per_device": live.peak - args,
            "peak_bytes_per_device": live.peak,
        }
    result["trace_s"] = round(time.perf_counter() - t0, 1)
    return result


def dryrun_one(arch: str, shape_name: str, *, multi_pod: bool = False,
               verbose: bool = True) -> Dict:
    """The dry run of one (arch, input shape) on the 16 x 16 mesh (256
    ranks) or, ``multi_pod``, the 2 x 16 x 16 mesh (512)."""
    from repro_torch.analysis import mesh_shape
    from repro_torch.configs import get_shape

    cfg = get_config(arch)
    shape = get_shape(shape_name)
    if shape.kind == "decode" and shape_name == "long_500k":
        if not cfg.supports_long_context():
            return {"arch": arch, "shape": shape_name,
                    "multi_pod": multi_pod, "skipped": "no sub-quadratic "
                    "long-context path (see DESIGN.md §Arch-applicability)"}
    ms = mesh_shape(multi_pod)
    result = {"arch": arch, "shape": shape_name, "multi_pod": multi_pod,
              **dryrun_step(cfg, shape, ms)}
    if verbose:
        r, gib = result, 2 ** 30
        mib = {k: f"{v / 2**20:.1f}MiB"
               for k, v in r["collective_bytes_per_device"].items()}
        print(f"== {arch} x {shape_name} ({'2-pod' if multi_pod else '1-pod'},"
              f" {r['devices']} devices) ==")
        print(f"  memory: args={r['argument_bytes_per_device'] / gib:.2f}GiB"
              f" out={r['output_bytes_per_device'] / gib:.2f}GiB"
              f" temp={r['temp_bytes_per_device'] / gib:.2f}GiB"
              f" peak={r['peak_bytes_per_device'] / gib:.2f}GiB")
        print(f"  flops: {r['flops_per_device']:.3e} FLOPs/dev ({r['mode']})")
        print(f"  collectives: {mib} counts {r['collective_counts']}")
        print(f"  trace {r['trace_s']:.1f}s")
        sys.stdout.flush()
    return result


def main(argv=None):
    """The reference's flags over the run layer: they map onto a
    ``RunSpec(mode="dryrun")`` that ``run.dispatch.run_spec`` runs."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="all (arch x shape) on the single-pod mesh")
    ap.add_argument("--json", default=None)
    ap.add_argument("--bench-out", default=None,
                    help="a BENCH_*.json artifact of the results (the "
                         "port has none yet: ROADMAP.md item 6.5)")
    ap.add_argument("--bench-tag", default="dryrun")
    ap.add_argument("--specs", action="store_true",
                    help="print the Rules-derived sharding-spec table "
                         "per arch instead of tracing the steps")
    args = ap.parse_args(argv)

    from repro_torch.run.dispatch import run_spec
    from repro_torch.run.spec import DryrunSection, RunSpec

    do_all = args.all or (args.specs and not args.arch)
    if not do_all and not args.arch:
        ap.error("--arch (with --shape) or --all is required")
    if not do_all and not args.specs and not args.shape:
        ap.error("--shape is required with --arch")
    spec = RunSpec(
        arch=args.arch or "gemma-7b",
        mode="dryrun",
        mesh="multipod" if args.multi_pod else "pod",
        dryrun=DryrunSection(
            shape=args.shape or "train_4k",
            all=do_all,
            specs=args.specs,
            json_out=args.json or "",
            bench_out=args.bench_out or "",
            bench_tag=args.bench_tag,
        ),
    )
    return run_spec(spec, device="cpu")["exit_code"]


if __name__ == "__main__":
    sys.exit(main())
