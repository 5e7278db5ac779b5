"""The port's Mamba path against the JAX reference: the plain selective
scan against ``ref.mamba_scan``, ``ops._mamba_scan_jnp`` and the Pallas
kernel in interpret mode; the written-out conv (values and state,
bit for bit); softplus; ``apply_mamba`` and ``apply_mamba_step`` on the
reference's weights, and step against scan on the port; the routing of
``ops.mamba_scan`` and the strided B/C views it receives; the CUDA
wrapper's refusals; and, on a card only (marked ``cuda``), the kernel
against the plain version."""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.dist import split_tree  # noqa: E402
from repro.kernels import mamba as jax_mamba  # noqa: E402
from repro.kernels import ops as jax_ops  # noqa: E402
from repro.kernels import ref as jax_ref  # noqa: E402
from repro.models import layers as jax_layers  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import mamba as mk  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402

ARCH = "jamba-1.5-large-398b"
FP32 = dict(dtype="float32", kv_cache_dtype="float32")
# tests/test_kernels.py's shapes (Bt, S, Di, N).
SHAPES = [(2, 24, 48, 8), (1, 17, 33, 4)]
# jitted: one compile instead of one per eager op
ref_scan = jax.jit(jax_ref.mamba_scan)
ref_apply_mamba = jax.jit(jax_layers.apply_mamba, static_argnums=2)
ref_mamba_step = jax.jit(jax_layers.apply_mamba_step, static_argnums=2)


def _scan_inputs(Bt, S, Di, N, seed=0):
    """tests/test_kernels.py's input recipe, from numpy: u ~ 0.5 N,
    dt = 0.1 softplus(N), A = -|N|, B, C ~ 0.3 N, D ~ 0.1 N (fp32)."""
    rng = np.random.default_rng(seed)
    n = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return (0.5 * n(Bt, S, Di), 0.1 * np.logaddexp(n(Bt, S, Di), 0),
            -np.abs(n(Di, N)), 0.3 * n(Bt, S, N), 0.3 * n(Bt, S, N),
            0.1 * n(Di))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_plain_scan_matches_ref_jnp_and_pallas(shape):
    args = _scan_inputs(*shape)
    y, h = mk.mamba_scan_torch(*map(torch.from_numpy, args))
    assert y.dtype == torch.float32 and h.shape == (shape[0], shape[2],
                                                    shape[3])
    jargs = tuple(map(jnp.asarray, args))
    for want_y, want_h in (
            ref_scan(*jargs),
            jax_ops._mamba_scan_jnp(*jargs),
            jax_mamba.mamba_scan(*jargs, interpret=True, block_d=16)):
        np.testing.assert_allclose(y.numpy(), np.asarray(want_y), rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_allclose(h.numpy(), np.asarray(want_h), rtol=1e-4,
                                   atol=1e-5)


def _lanes_and_states(N):
    """csrc/mamba_scan.cu's launch_n: the lanes a channel and the states a
    lane for N states."""
    if N <= 16:
        return 4, 1 << (-(-N // 4) - 1).bit_length()
    return 8, 1 << (-(-N // 8) - 1).bit_length()


def _kernel_order_scan(u, dt, A, B, C, D):
    """The CUDA kernel's arithmetic in PyTorch, fp32: the decay as
    ``exp(dt * A)`` of the rounded product, the input as ``(dt * u) * B``,
    and h . C summed as the kernel sums it: lanes of neighbouring states
    (a power of two a lane, padded with zeros), each lane's states in
    order, then the lanes pairwise, halves first (with 4 lanes: l with
    l + 2, then + 1). Not bitwise the kernel: the CPU's exp is not CUDA's
    expf, and its products and sums are not FFMA."""
    Bt, S, Di = u.shape
    N = A.shape[-1]
    lanes, per = _lanes_and_states(N)
    h = torch.zeros((Bt, Di, N), dtype=torch.float32)
    ys = []
    for t in range(S):
        dtu = dt[:, t] * u[:, t]
        h = (torch.exp(dt[:, t, :, None] * A) * h
             + dtu[..., None] * B[:, t, None, :])
        prod = torch.nn.functional.pad(h * C[:, t, None, :],
                                       (0, lanes * per - N))
        prod = prod.reshape(Bt, Di, lanes, per)
        part = prod[..., 0]
        for p in range(1, per):
            part = part + prod[..., p]
        while part.shape[-1] > 1:
            half = part.shape[-1] // 2
            part = part[..., :half] + part[..., half:]
        ys.append(part[..., 0] + D * u[:, t])
    return torch.stack(ys, dim=1), h


@pytest.mark.parametrize("shape", [(1, 256, 24, 16), (2, 45, 12, 13),
                                   (1, 33, 8, 64)], ids=str)
def test_kernel_arithmetic_matches_reference_jnp(shape):
    """The kernel's reordered arithmetic (h . C summed in its lane order,
    the input as (dt * u) * B) stays within the scan's stated tolerance of
    ``ops._mamba_scan_jnp`` (rtol 1e-4, atol 1e-5 on y and h): at N 16
    and S 256 (Jamba's state at a whole number of chunks), an odd N whose
    states pad the lanes, and N 64 (8 lanes of 8 states)."""
    args = _scan_inputs(*shape, seed=5)
    y, h = _kernel_order_scan(*map(torch.from_numpy, args))
    want_y, want_h = jax_ops._mamba_scan_jnp(*map(jnp.asarray, args))
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(h.numpy(), np.asarray(want_h), rtol=1e-4,
                               atol=1e-5)


def test_plain_scan_keeps_bf16_u_dtype():
    args = list(map(torch.from_numpy, _scan_inputs(1, 5, 8, 4)))
    u32 = args[0]
    args[0] = u32.to(torch.bfloat16)
    y, h = mk.mamba_scan_torch(*args)
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32
    y32, _ = mk.mamba_scan_torch(args[0].float(), *args[1:])
    assert torch.equal(y, y32.to(torch.bfloat16))  # rounded once, at the end


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16], ids=str)
@pytest.mark.parametrize("with_state", [False, True])
def test_mamba_conv_bit_exact_with_state(with_state, dtype):
    rng = np.random.default_rng(1)
    B, S, Di, Kc = 2, 7, 12, 4
    u = rng.standard_normal((B, S, Di)).astype(np.float32)
    w = rng.standard_normal((Kc, Di)).astype(np.float32)
    b = rng.standard_normal((Di,)).astype(np.float32)
    st = (rng.standard_normal((B, Kc - 1, Di)).astype(np.float32)
          if with_state else None)
    jd = jnp.dtype(dtype)
    td = torch.float32 if jd == jnp.float32 else torch.bfloat16
    ja = lambda a: None if a is None else jnp.asarray(a).astype(jd)  # noqa
    ta = lambda a: None if a is None else torch.from_numpy(a).to(td)  # noqa
    want, wstate = jax_layers._mamba_conv(ja(u), ja(w), ja(b), ja(st))
    got, state = L._mamba_conv(ta(u), ta(w), ta(b), ta(st))
    assert got.dtype == td and state.shape == (B, Kc - 1, Di)
    f = lambda a: np.asarray(jnp.asarray(a).astype(jnp.float32))  # noqa
    np.testing.assert_array_equal(got.float().numpy(), f(want))
    np.testing.assert_array_equal(state.float().numpy(), f(wstate))
    # the new state is the last Kc - 1 pre-conv inputs
    src = u if st is None else np.concatenate([st, u], 1)
    np.testing.assert_array_equal(state.float().numpy(),
                                  f(ja(src[:, -(Kc - 1):])))


def test_softplus_is_logaddexp_where_dt_is_used():
    x = np.concatenate([np.linspace(-30, 30, 601),
                        [-88.0, 19.99, 20.0, 20.01, 50.0]]).astype(np.float32)
    got = L._softplus(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax.nn.softplus(x)),
                               rtol=1e-6, atol=1e-7)


@pytest.fixture(scope="module")
def mixer():
    """One reduced jamba Mamba mixer's reference weights (fp32) and the
    port's copy through the bridge's leaf rule."""
    ref_cfg = dataclasses.replace(jax_get_config(ARCH).reduced(), **FP32)
    cfg = dataclasses.replace(get_config(ARCH).reduced(), **FP32)
    vals, _ = split_tree(jax_layers.init_mamba(ref_cfg,
                                               jax.random.PRNGKey(3)))
    vals = jax.tree_util.tree_map(np.asarray, vals)
    params = {k: torch.from_numpy(np.array(v)) for k, v in vals.items()}
    x = np.random.default_rng(2).standard_normal(
        (2, 6, cfg.d_model)).astype(np.float32)
    return ref_cfg, vals, cfg, params, x


def test_apply_mamba_matches_reference(mixer):
    ref_cfg, vals, cfg, params, x = mixer
    want, wcache = ref_apply_mamba(vals, jnp.asarray(x), ref_cfg)
    got, cache = L.apply_mamba(params, torch.from_numpy(x), cfg)
    scale = np.abs(np.asarray(want)).max()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5 * scale)
    # the conv state holds x @ wx, whose sum order differs from XLA's
    np.testing.assert_allclose(cache["conv"].numpy(),
                               np.asarray(wcache["conv"]), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(cache["ssm"].numpy(),
                               np.asarray(wcache["ssm"]), rtol=1e-4,
                               atol=1e-5)


def test_apply_mamba_step_matches_reference_and_scan(mixer):
    ref_cfg, vals, cfg, params, x = mixer
    B, S, _ = x.shape
    full, fcache = L.apply_mamba(params, torch.from_numpy(x), cfg)
    wcache = jax_layers.init_mamba_cache(ref_cfg, B)
    cache = L.init_mamba_cache(cfg, B, device="cpu")
    for t in range(S):
        xt = x[:, t:t + 1]
        want, wcache = ref_mamba_step(vals, jnp.asarray(xt), ref_cfg,
                                      wcache)
        got, cache = L.apply_mamba_step(params, torch.from_numpy(xt), cfg,
                                        cache)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-5)
        torch.testing.assert_close(got[:, 0], full[:, t], rtol=1e-4,
                                   atol=1e-5)
    np.testing.assert_allclose(cache["ssm"].numpy(),
                               np.asarray(wcache["ssm"]), rtol=1e-4,
                               atol=1e-5)
    torch.testing.assert_close(cache["ssm"], fcache["ssm"], rtol=1e-4,
                               atol=1e-5)
    torch.testing.assert_close(cache["conv"], fcache["conv"], rtol=1e-5,
                               atol=1e-6)


def test_ops_routes_cpu_to_plain_with_strided_b_and_c(mixer, monkeypatch):
    """``apply_mamba`` hands the scan B and C as column slices of one
    projection (row stride R + 2N, last axis contiguous), the layout the
    CUDA wrapper takes without a copy; CPU tensors reach the plain scan."""
    _, _, cfg, params, x = mixer
    seen = []
    real = mk.mamba_scan_torch

    def spy(u, dt, A, B, C, D):
        seen.append((B.stride(), C.stride(), B.is_contiguous()))
        return real(u, dt, A, B, C, D)

    monkeypatch.setattr(mk, "mamba_scan_torch", spy)
    L.apply_mamba(params, torch.from_numpy(x), cfg)
    m, di, R = L._mamba_dims(cfg)
    row = R + 2 * m.d_state
    assert seen == [((x.shape[1] * row, row, 1),) * 2 + (False,)]


def test_cuda_wrapper_refuses_what_it_does_not_take():
    args = list(map(torch.from_numpy, _scan_inputs(1, 4, 8, 4)))
    before = mk.mamba_scan_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        mk.mamba_scan_cuda(*args)
    assert mk.mamba_scan_cuda.launches == before
    # ops routes CPU tensors to the plain version
    y, h = ops.mamba_scan(*args)
    want_y, want_h = mk.mamba_scan_torch(*args)
    assert torch.equal(y, want_y) and torch.equal(h, want_h)


# --------------------------------------------------------------------------- #
# On the card (skipped without one).
# --------------------------------------------------------------------------- #
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


# chip_smoke.py's cases: Jamba's prefill shape, an odd one, S = 1, N = 64
# and an odd N (S no whole number of 32-step chunks).
CUDA_CASES = [(1, 256, 16384, 16), (2, 17, 33, 4), (3, 1, 100, 16),
              (2, 70, 1000, 64), (2, 77, 300, 13)]


@pytest.mark.cuda
@pytest.mark.parametrize("u_dtype", [torch.float32, torch.bfloat16],
                         ids=str)
@pytest.mark.parametrize("shape", CUDA_CASES, ids=str)
def test_cuda_kernel_matches_plain(cuda_device, shape, u_dtype):
    """y and h against the plain version on the same inputs (B and C as
    strided views): rtol 1e-4, atol 1e-5 with fp32 u, one bf16 ulp of y
    beyond that with bf16 u; one launch a call; a rerun bitwise equal."""
    Bt, S, Di, N = shape
    u, dt, A, B, C, D = (torch.from_numpy(a).to(cuda_device)
                         for a in _scan_inputs(*shape, seed=4))
    u = u.to(u_dtype)
    bc = torch.cat([B, C, B], dim=-1)  # B and C as views, row stride 3N
    B, C = bc[..., :N], bc[..., N:2 * N]
    want_y, want_h = mk.mamba_scan_torch(u, dt, A, B, C, D)
    before = mk.mamba_scan_cuda.launches
    outs = [mk.mamba_scan_cuda(u, dt, A, B, C, D) for _ in range(2)]
    torch.cuda.synchronize()
    assert mk.mamba_scan_cuda.launches - before == 2
    assert all(torch.equal(a, b) for a, b in zip(*outs))
    y, h = outs[0]
    torch.testing.assert_close(h, want_h, rtol=1e-4, atol=1e-5)
    if u_dtype == torch.float32:
        torch.testing.assert_close(y, want_y, rtol=1e-4, atol=1e-5)
    else:  # both round an fp32 y held to that tolerance to bf16 once
        want = want_y.float()
        _, e = torch.frexp(want)
        ulp = torch.ldexp(torch.ones_like(want), e - 8)
        assert ((y.float() - want).abs()
                <= ulp + 1e-5 + 1e-4 * want.abs()).all()
