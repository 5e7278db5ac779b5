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
    """dx_proj, dh_prev, dc_prev, dw_h, db from the plain backward, as
    ``LSTMCell.backward`` forms them."""
    xp, h, c, w, b = t
    dgates, dc_prev = lk.lstm_cell_bwd_torch(gates, c, c_new, dh, dc)
    return (dgates.to(xp.dtype), (dgates @ w.float().t()).to(h.dtype),
            dc_prev, (h.float().t() @ dgates).to(w.dtype), dgates.sum(0))


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
    dg, dcp = lk.lstm_cell_bwd_cuda(gates, t[2], c, dh, dc)
    torch.cuda.synchronize()
    assert none is None and torch.equal(h0, h) and torch.equal(c0, c)
    assert all(torch.equal(a, b) for a, b in zip((h, c, gates), again))
    want_h, want_c = lk.lstm_cell_torch(*t)
    want_g = _gates(t)
    want_dg, want_dcp = lk.lstm_cell_bwd_torch(want_g, t[2], want_c, dh, dc)
    for got, ref in ((h, want_h), (c, want_c), (gates, want_g),
                     (dg, want_dg), (dcp, want_dcp)):
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got.float(), ref.float(), rtol=tol,
                                   atol=tol)


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

