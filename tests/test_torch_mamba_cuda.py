"""The Mamba scan's CUDA kernels on the card (all marked ``cuda``; they
skip without one): the forward at S 2048 and its boundary states, and
the backward kernel (a last block partly filled among its cases), against
their plain versions, reruns bitwise, the autograd route on the card
against the CPU's, and the wrappers' refusals. No JAX here: this file
runs where the card is (``pytest -m cuda``); the plain versions are held
against the JAX reference in ``tests/test_torch_mamba_train.py``.

Tolerances: the forward's y, h and boundary states rtol 1e-4, atol 1e-5
(the reference's, ``tests/test_kernels.py``; y with bf16 u, which both
round once, one bf16 ulp beyond it); the gradients |kernel - plain| <=
1e-4 |plain| + 1e-4 max |plain| (fp32 sums over channels, states and rows
in other orders), du with bf16 u one bf16 ulp beyond that."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import mamba as mk
from repro_torch.kernels import ops


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _inputs(Bt, S, Di, N, u_dtype, dev, seed=0):
    """u ~ 0.5 N, dt = 0.1 softplus(N), A = -|N|, B, C ~ 0.3 N as column
    views of one (Bt, S, 3N) tensor, D ~ 0.1 N; cotangents dy ~ N in u's
    dtype and dh ~ N, from numpy."""
    rng = np.random.default_rng(seed)
    n = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32)).to(dev)
    u = (0.5 * n(Bt, S, Di)).to(u_dtype)
    dt = 0.1 * torch.nn.functional.softplus(n(Bt, S, Di))
    bc = 0.3 * n(Bt, S, 3 * N)
    args = (u, dt, -n(Di, N).abs(), bc[..., :N], bc[..., N:2 * N],
            0.1 * n(Di))
    return args, n(Bt, S, Di).to(u_dtype), n(Bt, Di, N)


def _ulp(w):
    """One bf16 ulp at each value of w."""
    _, e = torch.frexp(w)
    return torch.ldexp(torch.ones_like(w), e - 8)


def _close(got, want, bf16_ulp=False):
    g, w = got.float(), want.float()
    if not w.numel():  # S 1 saves no boundary state
        return g.shape == w.shape
    tol = 1e-4 * w.abs() + 1e-4 * w.abs().max()
    if bf16_ulp:
        tol = tol + _ulp(w)
    return bool(torch.isfinite(g).all() and ((g - w).abs() <= tol).all())


@pytest.mark.cuda
@pytest.mark.parametrize("u_dtype", [torch.bfloat16, torch.float32],
                         ids=str)
def test_forward_holds_the_reference_tolerance_at_s2048(cuda_device,
                                                        u_dtype):
    """The forward at a train step's length against the plain scan: h to
    rtol 1e-4, atol 1e-5 over 2048 decays, y the same (one bf16 ulp
    beyond it with bf16 u); B and C as column views."""
    args, _, _ = _inputs(1, 2048, 4096, 16, u_dtype, cuda_device, seed=7)
    y, h = mk.mamba_scan_cuda(*args)
    want_y, want_h = mk.mamba_scan_torch(*args)
    assert torch.allclose(h, want_h, rtol=1e-4, atol=1e-5)
    g, w = y.float(), want_y.float()
    extra = _ulp(w) if u_dtype == torch.bfloat16 else 0.0
    assert bool(((g - w).abs() <= 1e-5 + 1e-4 * w.abs() + extra).all())


CASES = [(1, 2048, 2048, 16, torch.bfloat16, 16),
         (2, 33, 520, 16, torch.float32, 16), (1, 1, 300, 16, torch.bfloat16, 16),
         (3, 50, 260, 5, torch.float32, 16), (2, 70, 1000, 64, torch.float32, 16),
         (2, 150, 700, 16, torch.float32, 48),
         (2, 2048, 16400, 16, torch.bfloat16, 16)]  # last block 16 of 64


@pytest.mark.cuda
@pytest.mark.parametrize("with_dh", [False, True], ids=["dy", "dy+dh"])
@pytest.mark.parametrize("case", CASES, ids=str)
def test_backward_kernel_matches_plain(cuda_device, case, with_dh):
    """The forward's boundary states against the plain scan's (y and h
    bitwise those of the launch without states), then the backward
    kernel's six gradients against ``mamba_scan_bwd_torch`` from the same
    states; one count a call; a rerun bitwise equal."""
    Bt, S, Di, N, u_dtype, K = case
    args, dy, dh = _inputs(Bt, S, Di, N, u_dtype, cuda_device, seed=S + N)
    dh = dh if with_dh else None
    y0, h0 = mk.mamba_scan_cuda(*args)
    y, h, hs = mk.mamba_scan_cuda(*args, state_every=K)
    assert torch.equal(y, y0) and torch.equal(h, h0)
    _, _, want_hs = mk.mamba_scan_torch(*args, state_every=K)
    assert hs.shape == want_hs.shape
    assert torch.allclose(hs, want_hs, rtol=1e-4, atol=1e-5)
    before = mk.mamba_scan_bwd_cuda.launches
    got = mk.mamba_scan_bwd_cuda(*args, hs, dy, dh, state_every=K)
    again = mk.mamba_scan_bwd_cuda(*args, hs, dy, dh, state_every=K)
    torch.cuda.synchronize()
    assert mk.mamba_scan_bwd_cuda.launches - before == 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    want = mk.mamba_scan_bwd_torch(*args, hs, dy, dh, state_every=K)
    assert got[0].dtype == u_dtype
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape
        assert _close(g, w, bf16_ulp=i == 0 and u_dtype == torch.bfloat16), i


@pytest.mark.cuda
def test_autograd_route_on_the_card_matches_the_cpu(cuda_device):
    """``ops.mamba_scan`` where autograd records: the card's two kernels
    against the CPU's plain pair, y and every gradient."""
    outs = {}
    for dev in ("cpu", cuda_device):
        args, dy, _ = _inputs(2, 40, 96, 16, torch.float32, dev, seed=1)
        leaves = [a.clone().requires_grad_() for a in args]
        y, h = ops.mamba_scan(*leaves)
        grads = torch.autograd.grad((y * dy).sum() + h.sum(), leaves)
        outs[str(dev)] = [t.detach().cpu() for t in (y, *grads)]
    for a, b in zip(outs["cpu"], outs[str(cuda_device)]):
        assert _close(b, a)


@pytest.mark.cuda
def test_wrappers_refuse_what_the_kernels_do_not_take(cuda_device):
    args, dy, dh = _inputs(1, 40, 64, 16, torch.bfloat16, cuda_device)
    u, dt, A, B, C, D = args
    _, _, hs = mk.mamba_scan_cuda(*args, state_every=16)
    before = (mk.mamba_scan_cuda.launches, mk.mamba_scan_bwd_cuda.launches)
    with pytest.raises(TypeError, match="D is torch.bfloat16"):
        mk.mamba_scan_cuda(u, dt, A, B, C, D.bfloat16(), state_every=16)
    with pytest.raises(ValueError, match="multiple of 16"):
        mk.mamba_scan_cuda(*args, state_every=24)
    with pytest.raises(ValueError, match="multiple of 16"):
        mk.mamba_scan_bwd_cuda(*args, hs, dy, state_every=8)
    with pytest.raises(ValueError, match="hs has shape"):
        mk.mamba_scan_bwd_cuda(*args, hs[:, :1], dy, state_every=16)
    with pytest.raises(TypeError, match="dy is torch.float32"):
        mk.mamba_scan_bwd_cuda(*args, hs, dy.float(), state_every=16)
    with pytest.raises(TypeError, match="dh is torch.bfloat16"):
        mk.mamba_scan_bwd_cuda(*args, hs, dy, dh.bfloat16(), state_every=16)
    with pytest.raises(ValueError, match="on cpu"):
        mk.mamba_scan_bwd_cuda(*args, hs.cpu(), dy, state_every=16)
    assert (mk.mamba_scan_cuda.launches,
            mk.mamba_scan_bwd_cuda.launches) == before
