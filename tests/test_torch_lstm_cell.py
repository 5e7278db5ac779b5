"""The port's LSTM cell against the JAX reference: the plain forward
against ``ref.lstm_cell`` and the Pallas kernel in interpret mode, the
plain backward (through the five input gradients it implies) against
``jax.vjp`` of ``ref.lstm_cell`` (the reference has no backward kernel),
the autograd function's wiring, the routing of ``ops.lstm_cell``, the
wrappers' refusals, and, on a card only (marked ``cuda``), the CUDA
kernels against the plain versions."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import lstm_cell as jax_lk  # noqa: E402
from repro.kernels import ref as jax_ref  # noqa: E402
from repro_torch.kernels import lstm_cell as lk  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

# (B, F, block_b): the shapes of tests/test_kernels.py's cell test.
SHAPES = [(48, 96, 32), (5, 64, 128), (128, 128, 64)]
# tests/test_kernels.py's _tol: bf16 3e-2, fp32 2e-5.
TOL = {"float32": 2e-5, "bfloat16": 3e-2}


def _inputs(B, F, seed=0):
    """x_proj, h, c, w_h, b, dh, dc as fp32 numpy, at the reference
    test's scales (w_h and b times 0.1)."""
    rng = np.random.RandomState(seed)
    n = rng.standard_normal
    return [n(s).astype(np.float32) * m for s, m in (
        ((B, 4 * F), 1.0), ((B, F), 1.0), ((B, F), 1.0), ((F, 4 * F), 0.1),
        ((4 * F,), 0.1), ((B, F), 1.0), ((B, F), 1.0))]


def _in_dtype(arrays, dtype):
    """x_proj, h and w_h in ``dtype`` (c and b stay fp32), as torch and
    as jax arrays rounded the same way."""
    xp, h, c, w, b = arrays[:5]
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    t = [torch.from_numpy(xp).to(tdt), torch.from_numpy(h).to(tdt),
         torch.from_numpy(c), torch.from_numpy(w).to(tdt),
         torch.from_numpy(b)]
    j = [jnp.asarray(xp, jdt), jnp.asarray(h, jdt), jnp.asarray(c),
         jnp.asarray(w, jdt), jnp.asarray(b)]
    return t, j


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,F,block", SHAPES)
def test_plain_forward_matches_ref_and_pallas_kernel(B, F, block, dtype):
    t, j = _in_dtype(_inputs(B, F), dtype)
    h, c = lk.lstm_cell_torch(*t)
    assert h.dtype == getattr(torch, dtype) and c.dtype == torch.float32
    tol = TOL[dtype]
    for want_h, want_c in (jax_ref.lstm_cell(*j),
                           jax_lk.lstm_cell(*j, interpret=True,
                                            block_b=block)):
        np.testing.assert_allclose(h.float().numpy(),
                                   np.asarray(want_h, np.float32),
                                   rtol=tol, atol=tol)
        np.testing.assert_allclose(c.numpy(), np.asarray(want_c),
                                   rtol=tol, atol=tol)


def _five_grads(t, gates, c_new, dh, dc):
    """dx_proj, dh_prev, dc_prev, dw_h, db from the plain backward (which
    gives dx_proj and db itself), as ``LSTMCell.backward`` forms them."""
    xp, h, c, w, b = t
    dgates, dc_prev, dx, db = lk.lstm_cell_bwd_torch(gates, c, c_new,
                                                     dh.to(xp.dtype), dc)
    return (dx, (dgates @ w.float().t()).to(h.dtype), dc_prev,
            (h.float().t() @ dgates).to(w.dtype), db)


def _gates(t):
    """The activated gates (B, 4F) in fp32, as the forward kernel saves
    them."""
    xp, h, c, w, b = t
    pre = xp.float() + h.float() @ w.float() + b
    i, f, g, o = pre.chunk(4, dim=-1)
    return torch.cat([torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g),
                      torch.sigmoid(o)], dim=-1)


@pytest.mark.parametrize("B,F,block", SHAPES)
def test_plain_backward_matches_jax_vjp_of_ref(B, F, block):
    arrays = _inputs(B, F, seed=1)
    t, j = _in_dtype(arrays, "float32")
    dh, dc = arrays[5], arrays[6]
    (want_h, want_c), vjp = jax.vjp(jax_ref.lstm_cell, *j)
    want = vjp((jnp.asarray(dh), jnp.asarray(dc)))
    _, c_new = lk.lstm_cell_torch(*t)
    np.testing.assert_allclose(c_new.numpy(), np.asarray(want_c), rtol=1e-5,
                               atol=1e-5)
    got = _five_grads(t, _gates(t), c_new, torch.from_numpy(dh),
                      torch.from_numpy(dc))
    for name, g, w in zip(("x_proj", "h_prev", "c_prev", "w_h", "b"), got,
                          want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5, err_msg=f"d{name}")


@pytest.mark.parametrize("B,F,block", SHAPES)
def test_plain_backward_dx_and_db_match_jax_grad(B, F, block):
    """The plain backward's own dx and db against ``jax.grad`` of
    ``ref.lstm_cell`` with respect to x_proj and b (fp32, rtol 1e-5, atol
    1e-6); dx is dgates in dh's dtype, bit for bit, in fp32 and bf16."""
    arrays = _inputs(B, F, seed=5)
    t, j = _in_dtype(arrays, "float32")
    dh, dc = arrays[5], arrays[6]

    def loss(xp, b):
        h, c = jax_ref.lstm_cell(xp, j[1], j[2], j[3], b)
        return jnp.sum(h * dh) + jnp.sum(c * dc)

    want_dx, want_db = jax.grad(loss, argnums=(0, 1))(j[0], j[4])
    _, c_new = lk.lstm_cell_torch(*t)
    dgates, _, dx, db = lk.lstm_cell_bwd_torch(
        _gates(t), t[2], c_new, torch.from_numpy(dh), torch.from_numpy(dc))
    assert dx.dtype == torch.float32 and db.shape == (4 * F,)
    np.testing.assert_allclose(dx.numpy(), np.asarray(want_dx), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(db.numpy(), np.asarray(want_db), rtol=1e-5,
                               atol=1e-6)
    *_, dx16, db16 = lk.lstm_cell_bwd_torch(
        _gates(t), t[2], c_new, torch.from_numpy(dh).bfloat16(),
        torch.from_numpy(dc))
    assert dx16.dtype == torch.bfloat16 and db16.dtype == torch.float32
    _, _, _, db_again = lk.lstm_cell_bwd_torch(
        _gates(t), t[2], c_new, torch.from_numpy(dh).bfloat16().float(),
        torch.from_numpy(dc))
    assert torch.equal(db16, db_again)


def test_autograd_function_matches_autograd_of_plain_bf16(monkeypatch):
    """``LSTMCell`` on bf16 x_proj, h and W_h with its kernels swapped for
    their plain versions: dx_proj comes back in bf16 and every gradient
    matches autograd of :func:`lstm_cell_torch` (within bf16 rounding of
    dx_proj, dh_prev and dW_h: 1e-2); the backward runs once, with bf16
    dh."""
    seen = []

    def fwd(xp, h, c, w, b, *, save_gates=False):
        h2, c2 = lk.lstm_cell_torch(xp, h, c, w, b)
        return h2, c2, _gates((xp, h, c, w, b)) if save_gates else None

    def bwd(gates, c_prev, c_new, dh, dc):
        seen.append(dh.dtype)
        return lk.lstm_cell_bwd_torch(gates, c_prev, c_new, dh, dc)

    monkeypatch.setattr(lk, "lstm_cell_fwd_cuda", fwd)
    monkeypatch.setattr(lk, "lstm_cell_bwd_cuda", bwd)
    arrays = _inputs(6, 16, seed=6)
    t, _ = _in_dtype(arrays, "bfloat16")
    dh = torch.from_numpy(arrays[5]).bfloat16()
    dc = torch.from_numpy(arrays[6])
    leaves = [[x.clone().requires_grad_() for x in t] for _ in range(2)]
    torch.autograd.backward(lk.LSTMCell.apply(*leaves[0]), (dh, dc))
    torch.autograd.backward(lk.lstm_cell_torch(*leaves[1]), (dh, dc))
    assert seen == [torch.bfloat16]
    assert leaves[0][0].grad.dtype == torch.bfloat16
    for a, b in zip(*leaves):
        assert a.grad.dtype == b.grad.dtype
        torch.testing.assert_close(a.grad.float(), b.grad.float(),
                                   rtol=1e-2, atol=1e-2)


def test_autograd_function_matches_autograd_of_plain(monkeypatch):
    """``LSTMCell`` run on the CPU with its two kernels swapped for their
    plain versions: its forward, saved gates and hand-written backward
    give autograd's gradients of :func:`lstm_cell_torch`, also under
    ``torch.no_grad`` and with no input needing a gradient (the forward
    alone, no gates), and with one input frozen."""
    calls = {"fwd": [], "bwd": 0}

    def fwd(xp, h, c, w, b, *, save_gates=False):
        calls["fwd"].append(save_gates)
        h2, c2 = lk.lstm_cell_torch(xp, h, c, w, b)
        return h2, c2, _gates((xp, h, c, w, b)) if save_gates else None

    def bwd(*args):
        calls["bwd"] += 1
        return lk.lstm_cell_bwd_torch(*args)

    monkeypatch.setattr(lk, "lstm_cell_fwd_cuda", fwd)
    monkeypatch.setattr(lk, "lstm_cell_bwd_cuda", bwd)
    arrays = _inputs(6, 16, seed=2)
    dh, dc = (torch.from_numpy(a) for a in arrays[5:])
    leaves = [[torch.from_numpy(a).requires_grad_() for a in arrays[:5]]
              for _ in range(2)]
    got = lk.LSTMCell.apply(*leaves[0])
    want = lk.lstm_cell_torch(*leaves[1])
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    torch.autograd.backward(got, (dh, dc))
    torch.autograd.backward(want, (dh, dc))
    for a, b in zip(*leaves):
        torch.testing.assert_close(a.grad, b.grad, rtol=1e-5, atol=1e-6)
    assert calls == {"fwd": [True], "bwd": 1}
    with torch.no_grad():
        lk.lstm_cell_cuda(*leaves[0])
    lk.lstm_cell_cuda(*(x.detach() for x in leaves[0]))
    assert calls["fwd"][1:] == [False, False] and calls["bwd"] == 1
    frozen = [x.detach() for x in leaves[0]]
    frozen[1].requires_grad_()  # only h_prev needs a gradient
    h, c = lk.lstm_cell_cuda(*frozen)
    (gh,) = torch.autograd.grad(h.sum() + c.sum(), frozen[1])
    ref = [x.detach() for x in leaves[1]]
    ref[1].requires_grad_()
    (wh,) = torch.autograd.grad(sum(x.sum() for x in lk.lstm_cell_torch(
        *ref)), ref[1])
    torch.testing.assert_close(gh, wh, rtol=1e-5, atol=1e-6)


def test_ops_lstm_cell_routes_cpu_to_plain():
    t, _ = _in_dtype(_inputs(5, 64), "bfloat16")
    before = (lk.lstm_cell_fwd_cuda.launches, lk.lstm_cell_bwd_cuda.launches)
    got = ops.lstm_cell(*t)
    for g, w in zip(got, lk.lstm_cell_torch(*t)):
        assert torch.equal(g, w)
    assert (lk.lstm_cell_fwd_cuda.launches,
            lk.lstm_cell_bwd_cuda.launches) == before


def test_cuda_wrappers_refuse_cpu_tensors_and_bad_inputs():
    t, _ = _in_dtype(_inputs(5, 64), "float32")
    xp, h, c, w, b = t
    with pytest.raises(ValueError, match="CUDA tensor"):
        lk.lstm_cell_fwd_cuda(*t)
    with pytest.raises(ValueError, match="CUDA tensor"):
        lk.lstm_cell_bwd_cuda(torch.zeros(5, 256), c, c, h, c)
    with pytest.raises(TypeError, match="c_prev"):
        lk.lstm_cell_fwd_cuda(xp, h, c.half(), w, b)
    with pytest.raises(TypeError, match="h_prev"):
        lk.lstm_cell_fwd_cuda(xp, h.bfloat16(), c, w, b)
    with pytest.raises(TypeError, match="x_proj"):
        lk.lstm_cell_fwd_cuda(xp.half(), h.half(), c, w.half(), b)
    with pytest.raises(ValueError, match="multiple of 8"):
        lk.lstm_cell_fwd_cuda(xp[:, :4 * 60], h[:, :60], c[:, :60],
                              w[:60, :240], b[:240])
    with pytest.raises(ValueError, match="w_h"):
        lk.lstm_cell_fwd_cuda(xp, h, c, w[:, :128], b)
    with pytest.raises(ValueError, match="gates"):
        lk.lstm_cell_bwd_cuda(torch.zeros(5, 64), c, c, h, c)
    with pytest.raises(TypeError, match="dc"):
        lk.lstm_cell_bwd_cuda(torch.zeros(5, 256), c, c, h, c.double())


def test_backward_wrapper_refuses_f_off_the_tile():
    """The backward kernel's blocks own 8 units: F must be a multiple of
    8, checked before the device."""
    c = torch.zeros(5, 60)
    with pytest.raises(ValueError, match="multiple of 8"):
        lk.lstm_cell_bwd_cuda(torch.zeros(5, 240), c, c, c, c)


# --------------------------------------------------------------------------- #
# On the card (skipped without one).
# --------------------------------------------------------------------------- #
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


# The shapes chip_smoke.py holds the kernels at: GNMT's (B 128, F 1024), a
# ragged batch tile (B 200), and the reference test's small ones; then
# the edges of the bf16 forward's tiles (128 rows and 8 units a block, k
# in stages of 64): B 5, 200 and 128 by F 96, 1000 and 1024.
CUDA_CASES = [(128, 1024, "bfloat16"), (200, 1024, "bfloat16"),
              (5, 64, "float32"), (48, 96, "bfloat16"), (37, 1024, "float32"),
              (5, 96, "bfloat16"), (5, 1000, "bfloat16"),
              (5, 1024, "bfloat16"), (200, 96, "bfloat16"),
              (200, 1000, "bfloat16"), (128, 96, "bfloat16"),
              (128, 1000, "bfloat16")]


@pytest.mark.cuda
@pytest.mark.parametrize("B,F,dtype", CUDA_CASES, ids=str)
def test_cuda_kernels_match_plain(cuda_device, B, F, dtype):
    """Forward (with and without gates) and backward kernels against the
    plain versions on the same inputs: bf16 within 2e-2 (h' is rounded to
    bf16), fp32 within 1e-4 (sums in another order); a second forward
    equal bit for bit."""
    tol = 2e-2 if dtype == "bfloat16" else 1e-4
    arrays = _inputs(B, F, seed=3)
    t, _ = _in_dtype(arrays, dtype)
    t = [x.to(cuda_device) for x in t]
    dh = torch.from_numpy(arrays[5]).to(cuda_device, t[0].dtype)
    dc = torch.from_numpy(arrays[6]).to(cuda_device)
    h0, c0, none = lk.lstm_cell_fwd_cuda(*t)
    h, c, gates = lk.lstm_cell_fwd_cuda(*t, save_gates=True)
    again = lk.lstm_cell_fwd_cuda(*t, save_gates=True)
    dg, dcp, dx, db = lk.lstm_cell_bwd_cuda(gates, t[2], c, dh, dc)
    torch.cuda.synchronize()
    assert none is None and torch.equal(h0, h) and torch.equal(c0, c)
    assert all(torch.equal(a, b) for a, b in zip((h, c, gates), again))
    want_h, want_c = lk.lstm_cell_torch(*t)
    want_g = _gates(t)
    want_dg, want_dcp, want_dx, want_db = lk.lstm_cell_bwd_torch(
        want_g, t[2], want_c, dh, dc)
    assert dx.dtype == dh.dtype
    for got, ref in ((h, want_h), (c, want_c), (gates, want_g),
                     (dg, want_dg), (dcp, want_dcp), (dx, want_dx)):
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got.float(), ref.float(), rtol=tol,
                                   atol=tol)
    # db sums B rows of dgates: the tolerance of one entry, times sqrt(B)
    torch.testing.assert_close(db, want_db, rtol=tol, atol=tol * B ** 0.5)


# The backward's own edges: one row, a ragged second row tile, F 40 (5
# blocks) and GNMT's F 1024, each with bf16 and fp32 dh.
BWD_CASES = [(1, 1024), (200, 1024), (128, 40), (200, 40), (128, 1024)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("B,F", BWD_CASES, ids=str)
def test_cuda_backward_four_outputs_match_plain(cuda_device, B, F, dtype):
    """dgates, dc_prev, dx (in dh's dtype; dgates itself for fp32) and db
    from the kernel against the plain backward on the same inputs (the
    gates from the plain forward): fp32 within 1e-5 (the same arithmetic
    in another compiler), dx within one bf16 rounding, db within 1e-5 x
    sqrt(B) (rows summed in another order); one launch a call; a rerun
    bitwise equal."""
    arrays = _inputs(B, F, seed=7)
    t, _ = _in_dtype(arrays, dtype)
    t = [x.to(cuda_device) for x in t]
    dh = torch.from_numpy(arrays[5]).to(cuda_device, t[0].dtype)
    dc = torch.from_numpy(arrays[6]).to(cuda_device)
    gates = _gates(t)
    _, c_new = lk.lstm_cell_torch(*t)
    before = lk.lstm_cell_bwd_cuda.launches
    outs = [lk.lstm_cell_bwd_cuda(gates, t[2], c_new, dh, dc)
            for _ in range(2)]
    torch.cuda.synchronize()
    assert lk.lstm_cell_bwd_cuda.launches - before == 2
    assert all(torch.equal(a, b) for a, b in zip(*outs))
    dg, dcp, dx, db = outs[0]
    want = lk.lstm_cell_bwd_torch(gates, t[2], c_new, dh, dc)
    assert dx.dtype == dh.dtype and db.shape == (4 * F,)
    if dtype == "float32":
        assert dx.data_ptr() == dg.data_ptr()
    for got in (dg, dcp, dx, db):
        assert torch.isfinite(got).all()
    torch.testing.assert_close(dg, want[0], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(dcp, want[1], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(dx.float(), want[2].float(),
                               rtol=1e-2 if dtype == "bfloat16" else 1e-5,
                               atol=1e-5)
    torch.testing.assert_close(db, want[3], rtol=1e-5,
                               atol=1e-5 * B ** 0.5)


@pytest.mark.cuda
def test_cuda_autograd_matches_plain_autograd(cuda_device):
    arrays = _inputs(64, 128, seed=4)
    leaves = [[torch.from_numpy(a).to(cuda_device).requires_grad_()
               for a in arrays[:5]] for _ in range(2)]
    dh, dc = (torch.from_numpy(a).to(cuda_device) for a in arrays[5:])
    before = (lk.lstm_cell_fwd_cuda.launches, lk.lstm_cell_bwd_cuda.launches)
    torch.autograd.backward(ops.lstm_cell(*leaves[0]), (dh, dc))
    torch.autograd.backward(lk.lstm_cell_torch(*leaves[1]), (dh, dc))
    assert (lk.lstm_cell_fwd_cuda.launches - before[0],
            lk.lstm_cell_bwd_cuda.launches - before[1]) == (1, 1)
    for a, b in zip(*leaves):
        torch.testing.assert_close(a.grad, b.grad, rtol=1e-4, atol=1e-4)

