"""The port's dry run (``launch.dryrun``, ``launch.specs``) against the
reference's input and sharding specs, and against real steps on the CPU.

- *Specs.* For every architecture at its published widths and every
  input shape, ``batch_structure`` and ``decode_structure`` have the
  shapes and dtypes of the reference's ``ShapeDtypeStruct``s (token ids
  int32 on both sides), and ``cache_structure``'s leaves those of the
  reference's ``jax.eval_shape`` cache, layer ``i`` of the port's list at
  the reference's pattern position ``i % len(block_pattern)``, the
  stacked ``layer`` dim dropped (``tests/test_torch_dist_specs.py``'s
  mapping).
- *Fake is real.* On a one-rank mesh, ``dryrun_step``'s flops for reduced
  yi-9b (train and decode), reduced jamba-1.5-large and rwkv6-3b (train)
  and reduced whisper-medium (train and decode) equal exactly
  ``FlopCounterMode``'s count of the same step run on real CPU tensors
  over a one-rank gloo mesh (the trainer's own step for train), and its
  argument bytes the real tensors' bytes: at these lengths (at most 512
  keys) the chunked path scans one chunk, and its count is the plain
  attention's.
- *Blocks on the pod mesh.* Reduced yi-9b in ``wus`` and ``fsdp`` on a
  fake 16 x 16 world, train and decode: the argument bytes equal the sum,
  over the reference's ``train_state_specs``, ``param_specs_serving``,
  ``batch_pspecs`` and ``cache_pspecs`` on an ``AbstractMesh``, of each
  leaf's bytes over the product of the axes it is split over (shapes
  only: nothing is compiled).
- *Layers split over ``model``.* A decode step of mixtral-8x7b and of
  rwkv6-3b on 16 x 16 gives a result whose all-reduces are the
  row-parallel exits of its split layers.
- *Attention as the chunked path.* The traced attention's flops are
  those of the (query, key) pairs ``_chunked_attention``'s band visits
  (causal, windowed and non-causal counts written out here), and a
  prefill's temporaries grow with S, not S^2.
- The collective recorder names each ``dist.compat`` collective by the
  reference's kind; ``dryrun_one`` skips ``long_500k`` where the config
  has no long-context path, and a step that reads a value on the host
  raises naming the line.

The collectives of a real (4, 2) step against the dry run's are held in
``tests/test_torch_sharded_trainer.py`` (its 8 gloo ranks).
"""
import dataclasses
import math

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AbstractMesh, PartitionSpec  # noqa: E402

from repro.configs import INPUT_SHAPES as JSHAPES  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.dist import Rules as JRules  # noqa: E402
from repro.launch import specs as JS  # noqa: E402
from repro.train import steps as JT  # noqa: E402
from repro_torch.configs import (  # noqa: E402
    INPUT_SHAPES,
    InputShape,
    get_config,
    list_archs,
)
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch import specs as S  # noqa: E402

ARCHS = list_archs()
ONE = {"data": 1, "model": 1}
POD = {"data": 16, "model": 16}


def dtype_name(t):
    return str(t.dtype).replace("torch.", "")


def unstack_shape(shape, stacked):
    return tuple(shape[1:]) if stacked else tuple(shape)


@pytest.mark.parametrize("arch", ARCHS)
def test_input_structures_are_the_references(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    for name, shape in INPUT_SHAPES.items():
        with FakeTensorMode():
            got = {**S.batch_structure(cfg, shape),
                   **S.decode_structure(cfg, shape)}
            specs = S.input_specs(cfg, shape)
        want = {**JS.batch_structure(jcfg, JSHAPES[name]),
                **JS.decode_structure(jcfg, JSHAPES[name])}
        assert set(got) == set(want)
        for k, w in want.items():
            assert tuple(got[k].shape) == tuple(w.shape), (name, k)
            assert dtype_name(got[k]) == str(w.dtype), (name, k)
        assert set(specs) == ({"batch"} if shape.kind != "decode"
                              else {"token", "pos", "cache"})


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_structure_is_the_references(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    for name, shape in INPUT_SHAPES.items():
        with FakeTensorMode():
            got = S.cache_structure(cfg, shape)
        want = JS.cache_structure(jcfg, JSHAPES[name])
        if cfg.is_encdec:
            pairs = [(g, want[part]) for part in ("self", "cross")
                     for g in got[part]]
        else:
            n = len(cfg.block_pattern)
            assert len(got) == cfg.n_layers
            pairs = [(g, want[i % n]) for i, g in enumerate(got)]
        for g, w in pairs:
            assert set(g) == set(w), name
            for k in g:
                assert tuple(g[k].shape) == unstack_shape(w[k].shape, True), \
                    (name, k)
                assert dtype_name(g[k]) == str(w[k].dtype), (name, k)


def test_demo_batch_draws_from_its_generator():
    cfg = get_config("qwen2-vl-7b").reduced()
    shape = InputShape("small", 40, 2, "train")
    a = S.demo_batch(cfg, shape, torch.Generator().manual_seed(3))
    b = S.demo_batch(cfg, shape, torch.Generator().manual_seed(3))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert a["tokens"].dtype == torch.int32 and a["tokens"].shape == (2, 24)
    assert a["media"].shape == (2, 16, cfg.d_model)
    assert int(a["tokens"].max()) < cfg.vocab


# --------------------------------------------------------------------------- #
# Fake is real: a one-rank mesh, fake tensors against real ones.
# --------------------------------------------------------------------------- #
def real_train(cfg, shape):
    """(flops, argument bytes) of the trainer's own step on real CPU
    tensors over a one-rank gloo mesh."""
    import torch.distributed as dist

    from repro_torch.dist import spmd
    from repro_torch.launch.mesh import single_device_mesh
    from repro_torch.train import Trainer, TrainerConfig

    mesh = single_device_mesh("cpu")
    try:
        tr = Trainer(cfg, TrainerConfig(total_steps=1, log_every=0),
                     device="cpu", mesh=mesh)
        rows = spmd.batch_rows(S.demo_batch(cfg, shape), mesh)
        with FlopCounterMode(display=False) as flops:
            tr._train_step(tr.state, rows)
        return flops.get_total_flops(), D.tree_bytes((tr.state, rows))
    finally:
        dist.destroy_process_group()


def real_serve(cfg, shape):
    """The same for the dry run's serving step built on real tensors."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import single_device_mesh

    mesh = single_device_mesh("cpu")
    try:
        run, _, counted = D._serve_step(cfg, shape, mesh, cfg.param_sharding)
        with FlopCounterMode(display=False) as flops:
            run()
        return flops.get_total_flops(), D.tree_bytes(counted)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("arch,kind", [("yi-9b", "train"),
                                       ("yi-9b", "decode"),
                                       ("jamba-1.5-large-398b", "train"),
                                       ("rwkv6-3b", "train"),
                                       ("whisper-medium", "train"),
                                       ("whisper-medium", "decode")])
def test_fake_step_counts_what_the_real_step_does(arch, kind):
    cfg = dataclasses.replace(get_config(arch).reduced(),
                              param_sharding="wus")
    shape = InputShape("small", 32 if kind == "train" else 64, 4, kind)
    fake = D.dryrun_step(cfg, shape, ONE)
    flops, args = (real_train if kind == "train" else real_serve)(cfg, shape)
    assert fake["flops_per_device"] == flops > 0
    assert fake["argument_bytes_per_device"] == args > 0
    assert fake["peak_bytes_per_device"] >= args
    if kind == "train":  # the gradient sums run on a 1 x 1 mesh too
        assert fake["collective_counts"]


# --------------------------------------------------------------------------- #
# Blocks on the pod mesh against the reference's specs (shapes only).
# --------------------------------------------------------------------------- #
def block_bytes(tree, specs, mesh):
    is_spec = lambda x: isinstance(x, PartitionSpec)  # noqa: E731
    total = 0
    for leaf, spec in zip(jax.tree_util.tree_leaves(tree),
                          jax.tree_util.tree_leaves(specs, is_leaf=is_spec)):
        split = math.prod(mesh.shape[a] for e in spec if e is not None
                          for a in ((e,) if isinstance(e, str) else e))
        n = math.prod(leaf.shape) * jnp.dtype(leaf.dtype).itemsize
        assert n % split == 0
        total += n // split
    return total


def reference_argument_bytes(jcfg, shape, mode):
    mesh = AbstractMesh((16, 16), ("data", "model"))
    rules = JRules(mesh, mode, seq_parallel=jcfg.seq_parallel)
    key = jax.random.PRNGKey(0)
    if shape.kind == "train":
        state, axes = JT.init_train_state(jcfg, JT.make_optimizer(jcfg), key)
        batch = JS.batch_structure(jcfg, shape)
        return (block_bytes(state, JT.train_state_specs(jcfg, state, axes,
                                                        rules), mesh)
                + block_bytes(batch, JT.batch_pspecs(batch, rules), mesh))
    params, axes = JT.init_params_and_axes(jcfg, key)
    params = jax.tree_util.tree_map(
        lambda s: jax.ShapeDtypeStruct(
            s.shape, jnp.bfloat16 if (s.dtype == jnp.float32
                                      and len(s.shape) > 1) else s.dtype),
        params)
    cache = JS.cache_structure(jcfg, shape)
    d = JS.decode_structure(jcfg, shape)
    tok = {"t": d["token"]}
    return (block_bytes(params, JT.param_specs_serving(jcfg, params, axes,
                                                       rules), mesh)
            + block_bytes(cache, JT.cache_pspecs(jcfg, cache, rules), mesh)
            + block_bytes(tok, JT.batch_pspecs(tok, rules), mesh)
            + block_bytes(d["pos"], PartitionSpec(), mesh))


@pytest.mark.parametrize("mode", ["wus", "fsdp"])
@pytest.mark.parametrize("shape", ["train_4k", "decode_32k"])
def test_pod_blocks_are_the_references(mode, shape):
    cfg = dataclasses.replace(get_config("yi-9b").reduced(),
                              param_sharding=mode)
    jcfg = dataclasses.replace(jax_get_config("yi-9b").reduced(),
                               param_sharding=mode)
    got = D.dryrun_step(cfg, INPUT_SHAPES[shape], POD, mode)
    assert got["devices"] == 256
    assert got["argument_bytes_per_device"] == \
        reference_argument_bytes(jcfg, JSHAPES[shape], mode)
    assert got["flops_per_device"] > 0
    assert got["peak_bytes_per_device"] == (
        got["argument_bytes_per_device"] + got["temp_bytes_per_device"])


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "rwkv6-3b"])
def test_split_layers_decode_on_the_pod(arch):
    """A decode step of mixtral-8x7b (32/8 heads and 8 experts of 14336
    hidden units on ``model`` 16: the hidden-split MoE) and of rwkv6-3b
    (40 heads of 64, which 16 does not divide: the time mix runs whole
    from its six ``mlp`` blocks gathered over ``model``; its FFN's 8960
    units split) on 16 x 16: a result, whose all-reduces are the
    row-parallel exits over ``model``, one a split layer part (mixtral:
    attention and MoE; rwkv6: the FFN). Decode keeps it cheap: a train
    or prefill shape traces the plain wkv and scan loops over every
    position."""
    cfg = get_config(arch)
    got = D.dryrun_step(cfg, INPUT_SHAPES["decode_32k"], POD)
    assert got["devices"] == 256
    assert got["flops_per_device"] > 0
    parts = 2 if arch == "mixtral-8x7b" else 1
    assert got["collective_counts"]["all-reduce"] == parts * cfg.n_layers
    if arch == "rwkv6-3b":
        assert got["collective_counts"]["all-gather"] >= 6 * cfg.n_layers


def test_recurrences_as_shapes_count_the_plain_loops():
    """The dry run's shape-only Mamba scan (forward with and without
    boundary states, backward) and RWKV-6 recurrence (forward, and a
    backward over one chunk of 64 and over several) give the plain loops'
    output shapes and dtypes and the flops ``FlopCounterMode`` counts for
    them."""
    from repro_torch.kernels import mamba as mk
    from repro_torch.models import layers as L

    def counted(fn, *a, **k):
        with FlopCounterMode(display=False) as f:
            out = fn(*a, **k)
        return out, f.get_total_flops()

    g = torch.Generator().manual_seed(0)
    Bt, S_, Di, N = 2, 37, 24, 5
    u = torch.randn(Bt, S_, Di, generator=g).to(torch.bfloat16)
    dt = torch.rand(Bt, S_, Di, generator=g)
    A = -torch.rand(Di, N, generator=g)
    B, C = (torch.randn(Bt, S_, N, generator=g) for _ in range(2))
    Dv = torch.randn(Di, generator=g)
    for K in (None, 16):
        want, wf = counted(mk.mamba_scan_torch, u, dt, A, B, C, Dv,
                           state_every=K)
        got, gf = counted(D.scan_shapes, u, dt, A, B, C, Dv, state_every=K)
        assert gf == wf > 0
        assert [(t.shape, t.dtype) for t in got] == \
            [(t.shape, t.dtype) for t in want]
    hs = want[2]
    dy = torch.randn(Bt, S_, Di, generator=g).to(torch.bfloat16)
    want, wf = counted(mk.mamba_scan_bwd_torch, u, dt, A, B, C, Dv, hs, dy,
                       state_every=16)
    got, gf = counted(D.scan_bwd_shapes, u, dt, A, B, C, Dv, hs, dy,
                      state_every=16)
    assert gf == wf > 0
    assert [(t.shape, t.dtype) for t in got] == \
        [(t.shape, t.dtype) for t in want]
    H, dh = 3, 8
    for S_ in (48, 128):
        xs = [torch.randn(2, S_, H * dh, generator=g, requires_grad=True)
              for _ in range(5)]
        xs[4] = torch.randn(H * dh, generator=g, requires_grad=True)
        flops = []
        for fn in (L._rwkv_wkv_scan, D.wkv_shapes):
            with FlopCounterMode(display=False) as f:
                y, state = fn(*xs[:4], xs[4], H, dh)
                grads = torch.autograd.grad(y.sum() + state.sum(), xs)
            flops.append(f.get_total_flops())
            shapes = [(t.shape, t.dtype) for t in (y, state, *grads)]
            if fn is L._rwkv_wkv_scan:
                want = shapes
        assert shapes == want
        assert flops[1] == flops[0] > 0, (S_, flops)


# Full-sequence attention as ``_chunked_attention`` (``repro/kernels/
# ops.py:53-148``, ``chunk=512``) computes it. Each count is written out
# from its band: ck = min(512, Sk) keys a chunk, the keys padded to whole
# chunks, and a causal call of Sq > ck queries visits, for each
# 512-query chunk [q_lo, q_hi), the KV chunks [chunk_lo, chunk_hi) with
# chunk_hi = (q_hi - 1) // 512 + 1 and, under a window W, chunk_lo =
# max(q_lo - W + 1, 0) // 512; any other call scans every chunk.
CHUNKED = {
    # causal, Sq = Sk = 1200, 3 chunks: 1, 2 and 3 chunks visited
    "causal": ((1200, 1200, True, None),
               512 * 1 * 512 + 512 * 2 * 512 + 176 * 3 * 512),
    # window 300: the third query chunk starts at chunk (1024 - 299) // 512
    # = 1, so it visits 2
    "window": ((1200, 1200, True, 300),
               512 * 1 * 512 + 512 * 2 * 512 + 176 * 2 * 512),
    # non-causal (a cross-attention): every query over ceil(1500 / 512) = 3
    # whole chunks
    "cross": ((600, 1500, False, None), 600 * 3 * 512),
}


@pytest.mark.parametrize("case", list(CHUNKED))
def test_attention_flops_are_the_chunked_paths(case):
    """The dry run's attention (``attention_as_chunks``): forward flops 4
    D a visited (query, key) pair and head, forward and backward 12 D (the
    backward two products for each of the two einsums, as ``jax.grad``
    of them), the pairs those of the chunked path's band written out in
    :data:`CHUNKED`; the output has q's shape and dtype and the
    gradients the inputs'."""
    from repro_torch.kernels import ops

    (Sq, Sk, causal, window), pairs = CHUNKED[case]
    B, H, K, Dh = 2, 4, 2, 64
    with D.attention_as_chunks(), FakeTensorMode():
        q = torch.empty((B, Sq, H, Dh), dtype=torch.bfloat16,
                        requires_grad=True)
        k, v = (torch.empty((B, Sk, K, Dh), dtype=torch.bfloat16,
                            requires_grad=True) for _ in range(2))
        with FlopCounterMode(display=False) as f:
            out = ops.attention(q, k, v, causal=causal, window=window)
            fwd = f.get_total_flops()
            out.float().sum().backward()
        total = f.get_total_flops()
        assert (out.shape, out.dtype) == (q.shape, q.dtype)
        assert [t.grad.shape for t in (q, k, v)] == [q.shape, k.shape,
                                                      k.shape]
    assert D.chunk_band(Sq, Sk, causal=causal, window=window, q_offset=0,
                        k_offset=0)[0] == pairs
    assert fwd == 4 * Dh * B * H * pairs
    assert total == 12 * Dh * B * H * pairs
    if causal and window is None:  # block skipping: below the plain count
        assert pairs < Sq * Sk


def test_prefill_peak_grows_with_the_sequence_not_its_square():
    """A prefill's temporaries at S 1024, 2048 and 4096 (reduced yi-9b,
    one row, 4 heads) grow by equal steps per doubling, twice the last
    (the chunked path's O(S) working set), where the plain attention's
    (B, H, Sq, Sk) fp32 scores alone would quadruple: at S 4096 the
    temporaries stay below those scores' bytes."""
    cfg = dataclasses.replace(get_config("yi-9b").reduced(),
                              param_sharding="wus")
    temp = [D.dryrun_step(cfg, InputShape("p", S_, 1, "prefill"),
                          ONE)["temp_bytes_per_device"]
            for S_ in (1024, 2048, 4096)]
    assert temp[2] - temp[1] <= 2.2 * (temp[1] - temp[0])
    assert temp[2] < cfg.n_heads * 4096 * 4096 * 4


def test_recorder_names_the_references_kinds():
    """Each collective of ``dist.compat`` on a fake (1, 4) world is
    recorded under the reference's kind with its result's bytes; a
    ``ppermute`` pair counts once, at its receive."""
    from repro_torch.dist import compat

    with D.fake_world({"data": 1, "model": 4}) as mesh, FakeTensorMode():
        x = torch.zeros(8, 16)
        with D.CollectiveRecorder() as rec:
            compat.ppermute(x, mesh, "model", [(i, (i + 1) % 4)
                                                for i in range(4)])
            compat.all_gather(x, mesh, "model")
            compat.psum_scatter(x, mesh, "model")
            compat.psum(x, mesh, "model")
    n = 8 * 16 * 4
    assert dict(rec.counts) == {"collective-permute": 1, "all-gather": 1,
                                "reduce-scatter": 1, "all-reduce": 1}
    assert dict(rec.bytes) == {"collective-permute": n, "all-gather": 4 * n,
                               "reduce-scatter": n // 4, "all-reduce": n}


# --------------------------------------------------------------------------- #
# Rows and refusals.
# --------------------------------------------------------------------------- #
def test_long_context_skip_and_host_reads_raise(monkeypatch):
    r = D.dryrun_one("whisper-medium", "long_500k", verbose=False)
    assert set(r) == {"arch", "shape", "multi_pod", "skipped"}
    from repro_torch.train import steps as T

    real = T.make_train_step

    def reads_the_loss(*a, **k):
        step = real(*a, **k)
        return lambda state, batch: float(step(state, batch)[1]["loss"])

    monkeypatch.setattr(T, "make_train_step", reads_the_loss)
    cfg = get_config("yi-9b").reduced()
    with pytest.raises(RuntimeError, match=r"reads a value on the host at "
                       r".*test_torch_dryrun\.py:\d+"):
        D.dryrun_step(cfg, InputShape("small", 32, 4, "train"), ONE)
