"""The port's flash attention against the JAX reference: the plain
version's forward against the Pallas kernel (interpret mode) and
``ref.attention``, its gradients against ``jax.grad`` of the jnp path
``ops._chunked_attention`` (the reference has no backward kernel), the
routing of ``ops.attention``, and, on a card only (marked ``cuda``),
the CUDA forward and backward kernels against the plain version."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import flash_attention as jax_fa  # noqa: E402
from repro.kernels import ops as jax_ops  # noqa: E402
from repro.kernels import ref as jax_ref  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

# (B, Sq, Sk, H, K, D, causal, window, q_offset, k_offset): the cases of
# tests/test_kernels.py's flash tests, plus Sq != Sk and offsets.
CASES = [
    (2, 128, 128, 4, 4, 64, True, None, 0, 0),
    (1, 100, 100, 4, 2, 32, True, None, 0, 0),     # ragged + GQA
    (2, 64, 64, 8, 1, 128, False, None, 0, 0),     # MQA, bidirectional
    (1, 256, 256, 4, 4, 64, True, 64, 0, 0),       # sliding window
    (2, 1, 160, 4, 2, 64, True, None, 159, 0),     # decode-like
    (1, 96, 96, 2, 2, 64, True, 32, 0, 0),
    (1, 32, 48, 2, 2, 32, True, 16, 0, -16),       # keys at negative pos
    (1, 40, 70, 4, 2, 64, True, None, 30, 0),      # Sq != Sk, prefix
    (1, 48, 80, 2, 1, 64, False, 24, 0, -37),      # window, no causal
]


def _inputs(case, seed=0):
    B, Sq, Sk, H, K, D = case[:6]
    rng = np.random.RandomState(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, Sq, H, D), (B, Sk, K, D), (B, Sk, K, D),
                      (B, Sq, H, D))]


def _opts(case):
    causal, window, q_offset, k_offset = case[6:]
    return dict(causal=causal, window=window, q_offset=q_offset,
                k_offset=k_offset)


def _rows(case):
    """Query rows with at least one visible key (the others are
    garbage by contract)."""
    Sq, Sk = case[1], case[2]
    return fa.visible_mask(Sq, Sk, **_opts(case)).any(1).numpy()


@pytest.mark.parametrize("case", CASES, ids=str)
def test_plain_forward_matches_pallas_kernel_and_ref(case):
    q, k, v, _ = _inputs(case)
    opts = _opts(case)
    got = fa.flash_attention_torch(*map(torch.from_numpy, (q, k, v)),
                                   **opts).numpy()
    want_ref = np.asarray(jax_ref.attention(q, k, v, **opts))
    want_pallas = np.asarray(jax_fa.flash_attention(
        q, k, v, **opts, interpret=True, block_q=64, block_k=64))
    rows = _rows(case)
    assert rows.any()
    for want in (want_ref, want_pallas):
        np.testing.assert_allclose(got[:, rows], want[:, rows], rtol=1e-5,
                                   atol=1e-5)
    assert (got[:, ~rows] == 0).all()  # the kernel's choice: 0, not NaN


@pytest.mark.parametrize("case", CASES, ids=str)
def test_plain_gradients_match_jax_grad_of_chunked_path(case):
    q, k, v, do = _inputs(case, seed=1)
    opts = _opts(case)
    do[:, ~_rows(case)] = 0.0  # no cotangent on garbage rows

    def f(q, k, v):
        out = jax_ops._chunked_attention(q, k, v, scale=None, chunk=128,
                                         **opts)
        return jnp.sum(out * do)

    want = jax.grad(f, argnums=(0, 1, 2))(q, k, v)
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    fa.flash_attention_torch(qt, kt, vt, **opts).backward(
        torch.from_numpy(do))
    for name, g, w in zip("qkv", (qt.grad, kt.grad, vt.grad), want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-5, err_msg=f"d{name}")


def test_ops_attention_routes_cpu_to_plain_and_needs_static_offsets():
    q, k, v, _ = _inputs(CASES[1])
    t = [torch.from_numpy(a) for a in (q, k, v)]
    before = fa.flash_attention_fwd_cuda.launches
    out = ops.attention(*t, causal=True)
    np.testing.assert_array_equal(
        out.numpy(), fa.flash_attention_torch(*t, causal=True).numpy())
    assert fa.flash_attention_fwd_cuda.launches == before
    with pytest.raises(ValueError, match="Python int"):
        ops.attention(*t, q_offset=torch.tensor(3))


def test_cuda_wrappers_refuse_cpu_tensors_and_bad_shapes():
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(CASES[0]))
    with pytest.raises(ValueError, match="CUDA tensor"):
        fa.flash_attention_fwd_cuda(q, k, v)
    lse = torch.zeros(q.shape[0], q.shape[2], q.shape[1])
    with pytest.raises(ValueError, match="CUDA tensor"):
        fa.flash_attention_bwd_cuda(q, k, v, q, lse, do)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention_fwd_cuda(q[..., :48], k[..., :48], v[..., :48])
    with pytest.raises(ValueError, match="Python int"):
        fa.flash_attention_fwd_cuda(q, k, v, k_offset=1.0)


# --------------------------------------------------------------------------- #
# On the card (skipped without one).
# --------------------------------------------------------------------------- #
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


CUDA_CASES = [
    (2, 256, 256, 4, 4, 256, True, None, 0, 0),
    (1, 300, 437, 4, 4, 128, True, None, 137, 0),  # ragged, Sq != Sk
    (1, 256, 256, 8, 2, 64, True, 64, 0, 0),       # GQA + window
    (1, 96, 133, 2, 2, 64, True, 40, 0, -37),      # negative positions
    (1, 100, 120, 2, 1, 64, False, None, 0, 0),    # bidirectional MQA
    # Edges of the bf16 forward's tiles (128 query rows a block, 64 keys
    # a stage, 64-column TMA boxes): Sq and Sk off the tiles with B >= 2
    # (a box past S must read zeros, not the next batch), jamba's GQA
    # 64/8 at D 128, and rows left with no visible key by the causal
    # edge, the window or negative key positions.
    (2, 200, 333, 4, 4, 128, True, None, 133, 0),
    (3, 77, 77, 2, 2, 64, False, None, 0, 0),
    (2, 17, 17, 64, 8, 128, True, None, 0, 0),
    (1, 128, 128, 64, 8, 128, True, None, 0, 0),
    (2, 96, 96, 2, 2, 256, True, 16, 0, 50),       # rows 0-49: no key
    (2, 64, 40, 2, 2, 64, True, 8, 30, -10),       # rows 8-63: no key
    (2, 130, 190, 4, 2, 256, True, 70, 60, -5),
    # Edges of the bf16 backward's tiles (64 keys a dK/dV block, 64 query
    # rows a dQ block and a streamed tile) at D 256 with B >= 2: Sq and Sk
    # one below and above a tile; GQA 16/2, so dK/dV sum over 8 query
    # heads; key tiles that no query sees (causal keys past the last
    # query, and a window).
    (2, 63, 63, 2, 2, 256, True, None, 0, 0),
    (2, 65, 65, 2, 2, 256, True, None, 0, 0),
    (2, 127, 129, 2, 2, 256, True, None, 2, 0),
    (2, 129, 127, 2, 1, 256, False, None, 0, 0),
    (2, 128, 128, 16, 2, 256, True, None, 0, 0),
    (2, 64, 256, 2, 2, 256, True, None, 0, 0),     # key tiles 1-3: no query
    (2, 200, 200, 2, 2, 256, True, 20, 0, 90),     # tiles 2-3 unseen
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("case", CUDA_CASES, ids=str)
def test_cuda_kernels_match_plain(cuda_device, case, dtype):
    """Forward and backward kernels against the plain version's output
    and autograd on the same inputs: bf16 within 2e-2 (P and dS are
    rounded to bf16 for the second products), fp32 within 1e-4."""
    dt = getattr(torch, dtype)
    tol = 2e-2 if dt == torch.bfloat16 else 1e-4
    q, k, v, do = (torch.from_numpy(a).to(cuda_device, dt)
                   for a in _inputs(case, seed=2))
    opts = _opts(case)
    before = (fa.flash_attention_fwd_cuda.launches,
              fa.flash_attention_bwd_cuda.launches)
    qt, kt, vt = (t.clone().requires_grad_() for t in (q, k, v))
    out = ops.attention(qt, kt, vt, **opts)
    out.backward(do)
    torch.cuda.synchronize()
    assert (fa.flash_attention_fwd_cuda.launches,
            fa.flash_attention_bwd_cuda.launches) == (before[0] + 1,
                                                      before[1] + 1)
    qp, kp, vp = (t.clone().requires_grad_() for t in (q, k, v))
    want = fa.flash_attention_torch(qp, kp, vp, **opts)
    want.backward(do)
    rows = torch.from_numpy(_rows(case)).to(cuda_device)
    pairs = [(out[:, rows], want[:, rows]), (qt.grad[:, rows],
                                             qp.grad[:, rows]),
             (kt.grad, kp.grad), (vt.grad, vp.grad)]
    for got, ref in pairs:
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got.float(), ref.float(), rtol=tol,
                                   atol=tol)
    assert (out[:, ~rows] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize(
    "case", [CUDA_CASES[i] for i in (2, 5, 7, 10, 16, 17)], ids=str)
def test_cuda_kernels_are_deterministic(cuda_device, case):
    q, k, v, do = (torch.from_numpy(a).to(cuda_device, torch.bfloat16)
                   for a in _inputs(case, seed=3))
    opts = _opts(case)
    runs = []
    for _ in range(2):
        out, lse = fa.flash_attention_fwd_cuda(q, k, v, **opts)
        runs.append((out, lse, *fa.flash_attention_bwd_cuda(
            q, k, v, out, lse, do, **opts)))
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("case", CUDA_CASES, ids=str)
def test_cuda_bf16_forward_lse(cuda_device, case):
    """The log-sum-exp the backward reads: within 2e-2 of the fp32
    logsumexp of the masked, scaled scores where a row sees a key, and
    at least 1e30 where it sees none."""
    q, k, v, _ = (torch.from_numpy(a).to(cuda_device, torch.bfloat16)
                  for a in _inputs(case, seed=4))
    opts = _opts(case)
    _, lse = fa.flash_attention_fwd_cuda(q, k, v, **opts)
    B, Sq, H, D = q.shape
    Sk, K = k.shape[1], k.shape[2]
    kf = k.float().repeat_interleave(H // K, dim=2)
    logits = torch.einsum("bqhd,bshd->bhqs", q.float(), kf) * D ** -0.5
    mask = fa.visible_mask(Sq, Sk, device=cuda_device, **opts)
    want = torch.logsumexp(logits.masked_fill(~mask, float("-inf")), -1)
    rows = torch.from_numpy(_rows(case)).to(cuda_device)
    torch.testing.assert_close(lse[:, :, rows], want[:, :, rows], rtol=2e-2,
                               atol=2e-2)
    assert (lse[:, :, ~rows] >= 1e30).all()

