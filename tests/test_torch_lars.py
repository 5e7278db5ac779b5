"""The port's LARS against the JAX reference: the plain update against
``ref.lars_update`` and the Pallas kernels in interpret mode, in both
rules, at zero norms too; the norms kernel's grid rule and both kernels'
leaf tables; the routing of ``ops.lars_update`` at the reference's
1024-element minimum; the wrappers' refusals; ``polynomial_warmup``; the ``lars`` and ``sgd_momentum``
optimizers over a tree of 1-D and larger leaves; and, on a card only
(marked ``cuda``), both CUDA kernels against the plain version."""
import ctypes

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import lars as jax_lars  # noqa: E402
from repro.kernels import ref as jax_ref  # noqa: E402
from repro.optim import constant as jax_constant  # noqa: E402
from repro.optim import lars as jax_lars_opt  # noqa: E402
from repro.optim import sgd_momentum as jax_sgd  # noqa: E402
from repro.optim.schedules import polynomial_warmup as jax_poly  # noqa: E402
from repro_torch.kernels import lars as lk  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.optim import (  # noqa: E402
    constant,
    lars,
    polynomial_warmup,
    sgd_momentum,
)
from repro_torch.utils import tree_leaves  # noqa: E402

HYPER = dict(lr=0.1, weight_decay=1e-4, momentum=0.9, eta=0.001)
# tests/test_kernels.py's shapes, and one of three 64k Pallas blocks.
SHAPES = [(300, 170), (64,), (7, 9, 11), (2 * 65536 + 5,)]


def _inputs(shape, seed=0, zero=None):
    """w, g ~ N(0, 1) and m ~ N(0, 0.1) as fp32 numpy; ``zero`` names an
    input set to 0."""
    rng = np.random.default_rng(seed)
    w, g = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    m = (0.1 * rng.standard_normal(shape)).astype(np.float32)
    if zero == "w":
        w[...] = 0
    if zero == "g":
        g[...] = 0
    return w, g, m


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("scaled", [True, False])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_plain_matches_ref_and_pallas_kernel(shape, scaled):
    w, g, m = _inputs(shape)
    kw = dict(HYPER, scaled_momentum=scaled)
    got_w, got_m = lk.lars_update_torch(*map(torch.from_numpy, (w, g, m)),
                                        **kw)
    assert got_w.dtype == got_m.dtype == torch.float32
    j = [jnp.asarray(a) for a in (w, g, m)]
    for want_w, want_m in (jax_ref.lars_update(*j, **kw),
                           jax_lars.lars_update(*j, interpret=True, **kw)):
        _close(got_w, want_w)
        _close(got_m, want_m)


@pytest.mark.parametrize("scaled", [True, False])
@pytest.mark.parametrize("zero", ["w", "g"])
def test_zero_norm_makes_trust_exactly_one(zero, scaled):
    w, g, m = _inputs((33, 40), seed=1, zero=zero)
    tw, tg, tm = map(torch.from_numpy, (w, g, m))
    trust = lk.lars_trust_torch(tw, tg, weight_decay=1e-4, eta=0.001)
    assert trust.dtype == torch.float32 and trust.item() == 1.0
    kw = dict(HYPER, scaled_momentum=scaled)
    got_w, got_m = lk.lars_update_torch(tw, tg, tm, **kw)
    want_w, want_m = jax_ref.lars_update(*map(jnp.asarray, (w, g, m)), **kw)
    _close(got_w, want_w)
    _close(got_m, want_m)
    # trust 1: the update is plain momentum SGD at lr
    upd = g + 1e-4 * w
    m1 = 0.9 * m + (upd if scaled else 0.1 * upd)
    _close(got_m, m1)
    _close(got_w, w - (0.1 * m1 if scaled else m1))


def test_trust_follows_the_reference_formula():
    w, g, _ = _inputs((64, 64), seed=2)
    wn, gn = np.linalg.norm(w.astype(np.float64)), np.linalg.norm(g)
    want = 0.001 * wn / (gn + 1e-4 * wn + 1e-9)
    got = lk.lars_trust_torch(torch.from_numpy(w), torch.from_numpy(g),
                              weight_decay=1e-4, eta=0.001)
    assert got.item() == pytest.approx(want, rel=1e-6)


def test_norm_blocks_is_a_function_of_n_within_the_kernels_grid():
    """One partial pair a chunk: chunks of at least 4096 elements, so up
    to 1,081,344 elements (264 x 4096) a leaf has n / 4096 of them, and
    past that at most 264 (ResNet-50's largest leaf: 256 of 9216)."""
    assert [lk.norm_blocks(n) for n in (1, 1024, 1025, 4096, 270_336,
                                         1_081_344, 1_081_345)] == [
        1, 1, 1, 1, 66, 264, 212]
    assert lk.norm_blocks(3 * 3 * 512 * 512) == 256
    assert lk.MAX_NORM_BLOCKS == 264


SIZES = [1, 1023, 1024, 4096, 4097, 9408, 270_336, 1_000_003, 1_081_344,
         1_081_345, 2_048_000, 2_359_296, 10 ** 8]


def test_chunk_plan_is_a_function_of_n_with_cumulative_rows():
    """Each leaf's chunk length is a multiple of 1024, at least 4096, and
    gives at most 264 chunks that just cover the leaf; a leaf's (rows,
    chunk) does not depend on the leaves beside it; first rows add up."""
    for n in SIZES:
        chunk, k = lk.norm_chunk(n), lk.norm_blocks(n)
        assert chunk % lk.CHUNK_ALIGN == 0 and chunk >= lk.MIN_CHUNK
        assert 1 <= k <= lk.MAX_NORM_BLOCKS
        assert (k - 1) * chunk < n <= k * chunk
    rng = np.random.default_rng(0)
    for _ in range(5):
        ns = list(rng.permutation(SIZES))
        plan = lk.chunk_plan(ns)
        first = 0
        for n, (row, rows, chunk) in zip(ns, plan):
            assert (row, rows, chunk) == (first, lk.norm_blocks(n),
                                          lk.norm_chunk(n))
            first += rows


def test_leaf_table_packing_field_order_and_launch_cap():
    """The ctypes leaf matches csrc/lars.cu's NormLeaf field for field (w,
    g, n, first, chunk at offsets 0, 8, 16, 24, 28; 32 bytes); on fake
    pointers, 130 leaves pack into launches of 64, 64 and 2, each leaf's
    ``first`` counted from its launch's first output row."""
    L = lk._NormLeaf
    assert [(f, getattr(L, f).offset) for f, _ in L._fields_] == [
        ("w", 0), ("g", 8), ("n", 16), ("first", 24), ("chunk", 28)]
    assert ctypes.sizeof(L) == 32
    ns = [4096 * (1 + i % 7) + i for i in range(130)]
    ws = [0x7F0000000000 + 0x100000 * i for i in range(130)]
    gs = [0x7E0000000000 + 0x100000 * i for i in range(130)]
    tables = lk.leaf_tables(ws, gs, ns)
    assert [len(t) for t, _, _ in tables] == [lk.MAX_LEAVES] * 2 + [2]
    plan = lk.chunk_plan(ns)
    i = 0
    for table, row0, rows in tables:
        assert row0 == plan[i][0]
        for leaf in table:
            first, k, chunk = plan[i]
            assert (leaf.w, leaf.g, leaf.n, leaf.first, leaf.chunk) == (
                ws[i], gs[i], ns[i], first - row0, chunk)
            i += 1
        assert rows == plan[i - 1][0] + plan[i - 1][1] - row0
    assert i == 130 and sum(r for _, _, r in tables) == sum(
        k for _, k, _ in plan)


@pytest.mark.parametrize("n", [1, 1023, 4096, 9408, 2 * 65536 + 5])
def test_partials_torch_are_chunk_sums(n):
    """The plain version of the norms kernel's output: one (sum w^2, sum
    g^2) row per chunk, adding up to the squared norms."""
    w, g, _ = map(torch.from_numpy, _inputs((n,), seed=8))
    part = lk.lars_partials_torch(w, g)
    assert part.shape == (lk.norm_blocks(n), 2)
    assert part.dtype == torch.float32
    chunk = lk.norm_chunk(n)
    torch.testing.assert_close(part[0, 0], w[:chunk].square().sum())
    torch.testing.assert_close(part.sum(0), torch.stack(
        [w.square().sum(), g.square().sum()]), rtol=1e-5, atol=0)


@pytest.fixture
def counted_kernel(monkeypatch):
    """``ops.lars_update`` sees every tensor as a CUDA tensor, and the
    kernel wrapper is a counted stand-in computing the plain update."""
    calls = []

    def stand_in(w, g, m, **kw):
        calls.append(w.numel())
        return lk.lars_update_torch(w, g, m, **kw)

    monkeypatch.setattr(ops, "_is_cuda", lambda t: True)
    monkeypatch.setattr(lk, "lars_update_cuda", stand_in)
    return calls


@pytest.mark.parametrize("n,kernel", [(1023, False), (1024, True),
                                      (4096, True), (64, False)])
def test_ops_routes_by_the_reference_min_size(counted_kernel, n, kernel):
    w, g, m = map(torch.from_numpy, _inputs((n,), seed=3))
    got = ops.lars_update(w, g, m, **HYPER)
    want = lk.lars_update_torch(w, g, m, **HYPER)
    assert counted_kernel == ([n] if kernel else [])
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_ops_routes_cpu_tensors_to_plain():
    before = (lk.lars_norms_cuda.launches, lk.lars_apply_cuda.launches)
    w, g, m = map(torch.from_numpy, _inputs((64, 64), seed=4))
    got = ops.lars_update(w, g, m, **HYPER)
    for a, b in zip(got, lk.lars_update_torch(w, g, m, **HYPER)):
        assert torch.equal(a, b)
    assert (lk.lars_norms_cuda.launches, lk.lars_apply_cuda.launches) == before


@pytest.fixture
def counted_leaves(monkeypatch):
    """``ops.lars_update_leaves`` sees every tensor as a CUDA tensor; the
    multi-leaf norms and update wrappers are counted stand-ins: the first
    returns the plain chunk sums and each leaf's slice of them, the
    second updates every leaf in place from the trust of its slice."""
    calls = {"norms": [], "apply": []}

    def norms(ws, gs):
        calls["norms"].append([w.numel() for w in ws])
        parts = [lk.lars_partials_torch(w, g) for w, g in zip(ws, gs)]
        cat = torch.cat(parts)
        plan = lk.chunk_plan([w.numel() for w in ws])
        return cat, [cat[first:first + k] for first, k, _ in plan]

    def apply(ws, gs, ms, parts, *, lr, weight_decay, momentum, eta,
              eps=1e-9, scaled_momentum=True):
        calls["apply"].append([w.numel() for w in ws])
        for w, g, m, partial in zip(ws, gs, ms, parts):
            assert partial.shape == (lk.norm_blocks(w.numel()), 2)
            wn, gn = partial.sum(0).sqrt()
            trust = torch.where((wn > 0) & (gn > 0),
                                eta * wn / (gn + weight_decay * wn + eps),
                                torch.ones(()))
            new_w, new_m = lk.lars_apply_torch(
                w, g, m, trust, lr=lr, weight_decay=weight_decay,
                momentum=momentum, scaled_momentum=scaled_momentum)
            w.copy_(new_w)
            m.copy_(new_m)
        return ws, ms

    monkeypatch.setattr(ops, "_is_cuda", lambda t: True)
    monkeypatch.setattr(lk, "lars_norms_multi_cuda", norms)
    monkeypatch.setattr(lk, "lars_apply_multi_cuda", apply)
    return calls


def test_ops_update_leaves_routes_by_min_size(counted_leaves):
    """Leaves of >= 1024 elements share one norms call and one update
    call, in place; smaller ones take the plain update; every leaf's (w',
    m') matches ``lars_update_torch``."""
    ns = [1023, 4096, 64, 1024, 9408]
    leaves = [tuple(map(torch.from_numpy, _inputs((n,), seed=10 + i)))
              for i, n in enumerate(ns)]
    want = [lk.lars_update_torch(w, g, m, **HYPER) for w, g, m in leaves]
    ws, gs, ms = ([x.clone() for x in t] for t in zip(*leaves))
    got = ops.lars_update_leaves(ws, gs, ms, **HYPER)
    assert counted_leaves == {"norms": [[4096, 1024, 9408]],
                              "apply": [[4096, 1024, 9408]]}
    for i, ((gw, gm), (ww, wm)) in enumerate(zip(got, want)):
        if ns[i] >= ops.LARS_MIN_SIZE:
            assert gw is ws[i] and gm is ms[i]
        _close(gw, ww)
        _close(gm, wm)


@pytest.mark.parametrize("scaled", [True, False])
def test_optimizer_makes_one_norms_launch_a_step(counted_leaves, monkeypatch,
                                                 scaled):
    """``lars`` over the tree of 1-D leaves, a 512-element leaf and two
    kernel leaves, through the stand-ins: one norms call and one update
    call a step over the two kernel leaves, the small leaf on the plain path,
    and the same weights and momenta as the CPU path (within rtol 1e-5,
    atol 1e-6) after 3 steps."""
    params, grads = _tree()
    runs = {}
    for cuda in (True, False):
        if not cuda:
            monkeypatch.setattr(ops, "_is_cuda", lambda t: False)
        opt = lars(polynomial_warmup(0.5, 2, 10), scaled_momentum=scaled)
        vals = _to_torch(params)
        st = opt.init(vals)
        for g in grads:
            vals, st = opt.update(_to_torch(g), st, vals)
        runs[cuda] = tree_leaves(vals) + tree_leaves(st["m"])
    assert counted_leaves["norms"] == [[1152, 2560]] * 3
    assert counted_leaves["apply"] == [[1152, 2560]] * 3
    for got, want in zip(runs[True], runs[False]):
        _close(got, want)


def test_ops_update_leaves_routes_cpu_tensors_to_plain():
    before = (lk.lars_norms_multi_cuda.launches,
              lk.lars_apply_multi_cuda.launches)
    leaves = [tuple(map(torch.from_numpy, _inputs(s, seed=20 + i)))
              for i, s in enumerate([(64, 64), (3, 3, 8, 16), (7,)])]
    got = ops.lars_update_leaves(*zip(*leaves), **HYPER)
    for (gw, gm), (w, g, m) in zip(got, leaves):
        ww, wm = lk.lars_update_torch(w, g, m, **HYPER)
        assert torch.equal(gw, ww) and torch.equal(gm, wm)
    assert (lk.lars_norms_multi_cuda.launches,
            lk.lars_apply_multi_cuda.launches) == before


def test_multi_norms_refuses_bad_inputs():
    w, g, _ = map(torch.from_numpy, _inputs((64, 64), seed=9))
    with pytest.raises(ValueError, match="as many gradients"):
        lk.lars_norms_multi_cuda([w, w], [g])
    with pytest.raises(ValueError, match="at least one leaf"):
        lk.lars_norms_multi_cuda([], [])
    with pytest.raises(ValueError, match="CUDA tensor"):
        lk.lars_norms_multi_cuda([w], [g])


def test_update_tiles_cover_each_leaf():
    """The update kernel's work items: tiles of 4096 elements, the last
    one short, so a leaf of n elements has ceil(n / 4096) of them."""
    assert lk.UPDATE_TILE == 4096
    assert [lk.update_tiles(n) for n in (1, 1024, 4096, 4097, 9408,
                                         2_359_296)] == [1, 1, 1, 2, 3, 576]
    for n in SIZES:
        k = lk.update_tiles(n)
        assert (k - 1) * lk.UPDATE_TILE < n <= k * lk.UPDATE_TILE


def test_update_leaf_table_packing_field_order_and_launch_cap():
    """The ctypes leaf matches csrc/lars.cu's UpdateLeaf field for field
    (w, g, m, part, n, parts, first at offsets 0, 8, 16, 24, 32, 40, 44;
    48 bytes); on fake pointers, 130 leaves pack into launches of 64, 64
    and 2, each starting at its first leaf's index, each leaf's ``first``
    the tiles of the leaves before it in its launch."""
    L = lk._UpdateLeaf
    assert [(f, getattr(L, f).offset) for f, _ in L._fields_] == [
        ("w", 0), ("g", 8), ("m", 16), ("part", 24), ("n", 32),
        ("parts", 40), ("first", 44)]
    assert ctypes.sizeof(L) == 48
    ns = [4096 * (1 + i % 7) + i for i in range(130)]
    ptrs = [[base + 0x100000 * i for i in range(130)]
            for base in (0x7F0000000000, 0x7E0000000000, 0x7D0000000000,
                         0x7C0000000000)]
    parts = [lk.norm_blocks(n) for n in ns]
    tables = lk.update_tables(*ptrs, parts, ns)
    assert [(len(t), s) for t, s in tables] == [(lk.MAX_LEAVES, 0),
                                                (lk.MAX_LEAVES, 64), (2, 128)]
    i = 0
    for table, start in tables:
        first = 0
        for leaf in table:
            assert (leaf.w, leaf.g, leaf.m, leaf.part) == tuple(
                p[i] for p in ptrs)
            assert (leaf.n, leaf.parts, leaf.first) == (ns[i], parts[i],
                                                        first)
            first += lk.update_tiles(ns[i])
            i += 1
    assert i == 130


def test_multi_update_refuses_bad_inputs():
    """Lists of different lengths, no leaf, CPU tensors, and leaves that
    share written memory are refused before anything launches."""
    w, g, m = map(torch.from_numpy, _inputs((64, 64), seed=9))
    part = torch.zeros(1, 2)
    kw = dict(HYPER)
    before = lk.lars_apply_multi_cuda.launches
    with pytest.raises(ValueError, match="one gradient, momentum and "
                                         "partial"):
        lk.lars_apply_multi_cuda([w, w], [g], [m], [part], **kw)
    with pytest.raises(ValueError, match="one gradient, momentum and "
                                         "partial"):
        lk.lars_apply_multi_cuda([w], [g], [m], [], **kw)
    with pytest.raises(ValueError, match="at least one leaf"):
        lk.lars_apply_multi_cuda([], [], [], [], **kw)
    with pytest.raises(ValueError, match="CUDA tensor"):
        lk.lars_apply_multi_cuda([w], [g], [m], [part], **kw)
    assert lk.lars_apply_multi_cuda.launches == before
    w2, m2 = w.clone(), m.clone()
    lk._check_disjoint("x", [w, w2], [g, g], [m, m2])  # g read twice: fine
    for ws, gs, ms in (([w, w], [g, g], [m, m2]), ([w, w2], [g, g], [m, w]),
                       ([w, w2], [g, m2], [m, m2]), ([w], [w], [m])):
        with pytest.raises(ValueError, match="must not share memory"):
            lk._check_disjoint("x", ws, gs, ms)


def test_cuda_wrappers_refuse_cpu_tensors():
    w, g, m = map(torch.from_numpy, _inputs((64, 64), seed=5))
    with pytest.raises(ValueError, match="CUDA tensor"):
        lk.lars_update_cuda(w, g, m, **HYPER)
    with pytest.raises(ValueError, match="CUDA tensor"):
        lk.lars_norms_cuda(w, g)
    with pytest.raises(ValueError, match="CUDA tensor"):
        lk.lars_apply_cuda(w, g, m, torch.zeros(1, 2), lr=0.1,
                           weight_decay=1e-4, momentum=0.9, eta=0.001)
    with pytest.raises(ValueError, match="CUDA tensor"):
        lk.lars_apply_multi_cuda([w], [g], [m], [torch.zeros(1, 2)], lr=0.1,
                                 weight_decay=1e-4, momentum=0.9, eta=0.001)


@pytest.mark.parametrize("args", [(0.25, 10, 60), (0.5, 2, 30),
                                  (10.0, 5, 100), (1.0, 0, 7, 1.0, 0.0),
                                  (0.3, 3, 3)], ids=str)
def test_polynomial_warmup_matches_reference_exactly(args):
    """Every step of 0..total+2 (warmup, decay and past the end), in
    fp32, bit for bit; as a Python int and as a tensor step."""
    total = args[2]
    want_f, got_f = jax_poly(*args), polynomial_warmup(*args)
    for step in range(total + 3):
        want = np.float32(want_f(step))
        got = got_f(step)
        assert got.dtype == torch.float32
        assert got.item() == want, step
        assert got_f(torch.tensor(step, dtype=torch.int32)).item() == want


def _tree(seed=6):
    """1-D leaves, a leaf under the 1024 minimum and two above it, as
    numpy: params and three steps of gradients."""
    rng = np.random.default_rng(seed)
    shapes = {"b": (16,), "bn": {"scale": (8,), "bias": (8,)},
              "small": (16, 32), "conv": (3, 3, 8, 16), "head": (64, 40)}

    def draw(scale):
        def one(s):
            if isinstance(s, dict):
                return {k: one(v) for k, v in s.items()}
            return (scale * rng.standard_normal(s)).astype(np.float32)
        return one(shapes)

    return draw(0.5), [draw(0.1) for _ in range(3)]


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(tree.copy())


OPTIMIZERS = {
    "lars_scaled": (lambda s, a: jax_lars_opt(s(*a), scaled_momentum=True),
                    lambda s, a: lars(s(*a), scaled_momentum=True)),
    "lars_unscaled": (lambda s, a: jax_lars_opt(s(*a), scaled_momentum=False),
                      lambda s, a: lars(s(*a), scaled_momentum=False)),
    "sgd": (lambda s, a: jax_sgd(s(*a), momentum=0.9),
            lambda s, a: sgd_momentum(s(*a), momentum=0.9)),
    "sgd_nesterov_wd": (
        lambda s, a: jax_sgd(s(*a), momentum=0.8, weight_decay=1e-3,
                             nesterov=True),
        lambda s, a: sgd_momentum(s(*a), momentum=0.8, weight_decay=1e-3,
                                  nesterov=True)),
}


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_optimizer_three_steps_match_reference(name):
    """Weights and fp32 momenta of every leaf after each of 3 steps under
    ``polynomial_warmup(0.5, 2, 10)``, within rtol 1e-5, atol 1e-6; the
    port updates in place and keeps ``step`` a tensor."""
    make_j, make_t = OPTIMIZERS[name]
    params, grads = _tree()
    jopt = make_j(jax_poly, (0.5, 2, 10))
    topt = make_t(polynomial_warmup, (0.5, 2, 10))
    jvals = jax.tree_util.tree_map(jnp.asarray, params)
    jst = jopt.init(jvals)
    tvals = _to_torch(params)
    tst = topt.init(tvals)
    leaves = tree_leaves(tvals)
    assert all(m.dtype == torch.float32 for m in tree_leaves(tst["m"]))
    for g in grads:
        jvals, jst = jopt.update(jax.tree_util.tree_map(jnp.asarray, g),
                                 jst, jvals)
        out, tst = topt.update(_to_torch(g), tst, tvals)
        assert out is tvals and all(
            a is b for a, b in zip(tree_leaves(out), leaves))
        for got, want in zip(tree_leaves(tvals) + tree_leaves(tst["m"]),
                             jax.tree_util.tree_leaves(jvals)
                             + jax.tree_util.tree_leaves(jst["m"])):
            _close(got, want)
    assert isinstance(tst["step"], torch.Tensor) and int(tst["step"]) == 3


def test_lars_1d_params_skip_adaptation():
    """tests/test_optim.py's case: a bias takes plain momentum, b - lr*g,
    with no trust ratio and no weight decay."""
    params = {"w": torch.ones(8, 4) * 0.5, "b": torch.zeros(4)}
    grads = {"w": torch.ones(8, 4) * 0.1, "b": torch.ones(4) * 0.2}
    opt = lars(constant(0.1), momentum=0.9)
    p1, _ = opt.update(grads, opt.init(params), params)
    np.testing.assert_allclose(p1["b"].numpy(), -0.1 * 0.2, rtol=1e-6)
    jparams = {"w": jnp.ones((8, 4)) * 0.5, "b": jnp.zeros((4,))}
    jopt = jax_lars_opt(jax_constant(0.1), momentum=0.9)
    jp1, _ = jopt.update({"w": jnp.ones((8, 4)) * 0.1,
                          "b": jnp.ones((4,)) * 0.2}, jopt.init(jparams),
                         jparams)
    _close(p1["w"], jp1["w"])


# --------------------------------------------------------------------------- #
# On the card (skipped without one).
# --------------------------------------------------------------------------- #
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


# The sizes chip_smoke.py holds the kernels at: ResNet-50's largest leaf,
# an odd size, the minimum, and zero w / zero g.
CUDA_CASES = [(3 * 3 * 512 * 512, None), (1_000_003, None), (1024, None),
              (65_536, "w"), (65_536, "g")]


@pytest.mark.cuda
@pytest.mark.parametrize("scaled", [True, False])
@pytest.mark.parametrize("n,zero", CUDA_CASES, ids=str)
def test_cuda_kernels_match_plain(cuda_device, n, zero, scaled):
    """Both kernels, in place, against the plain version on the same
    inputs: w' and m' within rtol 1e-5, atol 1e-6; the trust exactly 1 at
    a zero norm; one launch of each; a rerun bitwise equal."""
    w, g, m = (torch.from_numpy(a).to(cuda_device)
               for a in _inputs((n,), seed=7, zero=zero))
    lr = torch.full((), 0.1, device=cuda_device)
    kw = dict(HYPER, lr=lr, scaled_momentum=scaled)
    want_w, want_m = lk.lars_update_torch(w, g, m, **kw)
    before = (lk.lars_norms_cuda.launches, lk.lars_apply_cuda.launches)
    outs = []
    for _ in range(2):
        wk, mk, t = w.clone(), m.clone(), torch.empty(1, device=cuda_device)
        got = lk.lars_update_cuda(wk, g, mk, **kw, trust_out=t)
        assert got[0] is wk and got[1] is mk
        outs.append((wk, mk, t))
    torch.cuda.synchronize()
    assert (lk.lars_norms_cuda.launches - before[0],
            lk.lars_apply_cuda.launches - before[1]) == (2, 2)
    assert all(torch.equal(a, b) for a, b in zip(*outs))
    wk, mk, t = outs[0]
    torch.testing.assert_close(wk, want_w, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(mk, want_m, rtol=1e-5, atol=1e-6)
    if zero:
        assert t.item() == 1.0


def _resnet50_leaves(device, seed=11):
    """ResNet-50's 54 kernel leaves (weights from seed 0) with gradients
    and momenta ~N(0, 1e-3) from ``seed``, on ``device``."""
    from repro_torch.models import resnet

    gen = torch.Generator(device=device).manual_seed(seed)
    ws = [w for w in tree_leaves(resnet.init_resnet(resnet.RESNET50, 0,
                                                    device=device))
          if w.dim() > 1]
    return [(w, torch.randn(w.shape, generator=gen, device=device) * 1e-3,
             torch.randn(w.shape, generator=gen, device=device) * 1e-3)
            for w in ws]


def _offset(x, k):
    """A copy of x starting k floats into a fresh buffer (k = 1: not 16-byte
    aligned)."""
    buf = torch.empty(x.numel() + k, device=x.device)
    return buf[k:].copy_(x.reshape(-1))


@pytest.mark.cuda
def test_cuda_multi_norms_equal_one_leaf_norms_bitwise(cuda_device):
    """The multi-leaf launch's partials equal the one-leaf call's bit for
    bit, for ResNet-50's 54 kernel leaves (one launch), for odd, unaligned
    and 1024-element leaves among them, and past one launch's table cap
    (120 leaves, two launches); each within rtol 1e-5 of the plain chunk
    sums; a rerun bitwise equal."""
    leaves = _resnet50_leaves(cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(12)
    extra = [torch.randn(n, generator=gen, device=cuda_device)
             for n in (1_000_003, 1024, 1_000_003, 4097)]
    extra[2] = _offset(extra[2], 1)  # not 16-byte aligned
    cases = {"resnet50": [(w, g) for w, g, _ in leaves],
             "edges": [(x, x.flip(0).contiguous()) for x in extra]
             + [(w, g) for w, g, _ in leaves[:3]],
             "past_cap": [(w, g) for w, g, _ in leaves] * 2
             + [(extra[1], extra[0][:1024])] * 12}
    for name, pairs in cases.items():
        ws, gs = (list(t) for t in zip(*pairs))
        before = lk.lars_norms_multi_cuda.launches
        cat, parts = lk.lars_norms_multi_cuda(ws, gs)
        again, _ = lk.lars_norms_multi_cuda(ws, gs)
        torch.cuda.synchronize()
        assert lk.lars_norms_multi_cuda.launches - before == 2 * -(
            -len(ws) // lk.MAX_LEAVES), name
        assert torch.equal(cat, again), name
        assert cat.shape == (sum(lk.norm_blocks(w.numel()) for w in ws), 2)
        for i, (w, g) in enumerate(pairs):
            one = lk.lars_norms_cuda(w, g)
            assert torch.equal(parts[i], one), (name, i)
            torch.testing.assert_close(one, lk.lars_partials_torch(w, g),
                                       rtol=1e-5, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("scaled", [True, False])
def test_cuda_update_leaves_match_plain(cuda_device, scaled):
    """``ops.lars_update_leaves`` over ResNet-50's 54 kernel leaves: one
    norms launch and one update launch, w' and m' within rtol 1e-5, atol
    1e-6 of the plain version, written in place."""
    leaves = _resnet50_leaves(cuda_device, seed=13)
    lr = torch.full((), 0.1, device=cuda_device)
    kw = dict(HYPER, lr=lr, scaled_momentum=scaled)
    want = [lk.lars_update_torch(w, g, m, **kw) for w, g, m in leaves]
    ws, gs, ms = ([x.clone() for x in t] for t in zip(*leaves))
    before = (lk.lars_norms_multi_cuda.launches,
              lk.lars_apply_multi_cuda.launches, lk.lars_apply_cuda.launches)
    got = ops.lars_update_leaves(ws, gs, ms, **kw)
    torch.cuda.synchronize()
    assert (lk.lars_norms_multi_cuda.launches - before[0],
            lk.lars_apply_multi_cuda.launches - before[1],
            lk.lars_apply_cuda.launches - before[2]) == (1, 1, 0)
    for (gw, gm), (ww, wm), w, m in zip(got, want, ws, ms):
        assert gw is w and gm is m
        torch.testing.assert_close(gw, ww, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(gm, wm, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("scaled", [True, False])
def test_cuda_multi_update_equals_one_leaf_update_bitwise(cuda_device,
                                                          scaled):
    """The multi-leaf update launch's w', m' and trusts equal the one-leaf
    launch's bit for bit, for ResNet-50's 54 kernel leaves (one launch),
    for odd, unaligned and 1024-element leaves among them, and past one
    launch's table cap (120 leaves, two launches); a rerun bitwise
    equal."""
    leaves = _resnet50_leaves(cuda_device, seed=14)
    gen = torch.Generator(device=cuda_device).manual_seed(15)
    extra = [torch.randn(n, generator=gen, device=cuda_device)
             for n in (1_000_003, 1024, 1_000_003, 4097)]
    extra[2] = _offset(extra[2], 1)  # not 16-byte aligned
    edges = [(x, x.flip(0).contiguous(), 1e-2 * x) for x in extra]
    lr = torch.full((), 0.1, device=cuda_device)
    kw = dict(HYPER, lr=lr, scaled_momentum=scaled)
    cases = {"resnet50": leaves, "edges": edges + leaves[:3],
             "past_cap": [(w.clone(), g, m.clone()) for w, g, m in leaves]
             + leaves + [(torch.randn(1024, generator=gen,
                                      device=cuda_device), edges[1][1],
                          torch.zeros(1024, device=cuda_device))
                         for _ in range(12)]}
    for name, triples in cases.items():
        ws, gs, ms = (list(t) for t in zip(*triples))
        _, parts = lk.lars_norms_multi_cuda(ws, gs)
        before = lk.lars_apply_multi_cuda.launches
        runs = []
        for _ in range(2):
            wk, mk = [w.clone() for w in ws], [m.clone() for m in ms]
            t = torch.empty(len(ws), device=cuda_device)
            lk.lars_apply_multi_cuda(wk, gs, mk, parts, **kw, trust_out=t)
            runs.append((wk, mk, t))
        torch.cuda.synchronize()
        assert lk.lars_apply_multi_cuda.launches - before == 2 * -(
            -len(ws) // lk.MAX_LEAVES), name
        (wk, mk, t), (w2, m2, t2) = runs
        assert torch.equal(t, t2) and all(
            torch.equal(a, b) for a, b in zip(wk + mk, w2 + m2)), name
        for i, (w, g, m) in enumerate(triples):
            w1, m1 = w.clone(), m.clone()
            t1 = torch.empty(1, device=cuda_device)
            lk.lars_apply_cuda(w1, g, m1, parts[i], **kw, trust_out=t1)
            assert torch.equal(wk[i], w1) and torch.equal(mk[i], m1), (
                name, i)
            assert torch.equal(t[i:i + 1], t1), (name, i)
