"""The port's LARS against the JAX reference: the plain update against
``ref.lars_update`` and the Pallas kernels in interpret mode, in both
rules, at zero norms too; the norms kernel's grid rule; the routing of
``ops.lars_update`` at the reference's 1024-element minimum; the wrappers'
refusals; ``polynomial_warmup``; the ``lars`` and ``sgd_momentum``
optimizers over a tree of 1-D and larger leaves; and, on a card only
(marked ``cuda``), both CUDA kernels against the plain version."""
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
    assert [lk.norm_blocks(n) for n in (1, 1024, 1025, 4096, 270_336)] == [
        1, 1, 2, 4, 264]
    assert lk.norm_blocks(3 * 3 * 512 * 512) == lk.MAX_NORM_BLOCKS == 264


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


def test_cuda_wrappers_refuse_cpu_tensors():
    w, g, m = map(torch.from_numpy, _inputs((64, 64), seed=5))
    with pytest.raises(ValueError, match="CUDA tensor"):
        lk.lars_update_cuda(w, g, m, **HYPER)
    with pytest.raises(ValueError, match="CUDA tensor"):
        lk.lars_norms_cuda(w, g)
    with pytest.raises(ValueError, match="CUDA tensor"):
        lk.lars_apply_cuda(w, g, m, torch.zeros(1, 2), lr=0.1,
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
