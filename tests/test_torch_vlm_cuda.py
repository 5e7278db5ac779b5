"""The flash kernels at qwen2-vl-7b's grouped-query ratio, G 7 (28
query heads over 4 KV heads of 128), on the card only (marked ``cuda``,
skipped without one): causal forward and backward against the plain
version and its autograd on the same inputs, bf16 within 2e-2 and fp32
within 1e-4, one launch each, the backward rerun bitwise. This file
imports no JAX, so it runs on a card where JAX is missing."""
import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


# (B, S, H, K, D): qwen2-vl's 28/4 heads of 128 (G 7) over a media
# prefix and text, off the tiles; G 7 at D 64 and 256.
G7_CASES = [(1, 1040, 28, 4, 128), (2, 200, 28, 4, 128), (1, 77, 7, 1, 64),
            (2, 129, 14, 2, 256)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("case", G7_CASES, ids=str)
def test_cuda_flash_kernels_at_gqa_7(cuda_device, case, dtype):
    """Causal forward and backward kernels at G 7 against the plain
    version and its autograd on the same inputs (bf16 within 2e-2, fp32
    within 1e-4), one launch each; the backward rerun bitwise."""
    B, S, H, K, D = case
    dt = getattr(torch, dtype)
    tol = 2e-2 if dt == torch.bfloat16 else 1e-4
    gen = torch.Generator().manual_seed(S)
    q, k, v, do = (torch.randn(s, generator=gen).to(cuda_device, dt)
                   for s in ((B, S, H, D), (B, S, K, D), (B, S, K, D),
                             (B, S, H, D)))
    before = (fa.flash_attention_fwd_cuda.launches,
              fa.flash_attention_bwd_cuda.launches)
    qt, kt, vt = (t.clone().requires_grad_() for t in (q, k, v))
    out = ops.attention(qt, kt, vt, causal=True)
    out.backward(do)
    torch.cuda.synchronize()
    assert (fa.flash_attention_fwd_cuda.launches,
            fa.flash_attention_bwd_cuda.launches) == (before[0] + 1,
                                                      before[1] + 1)
    qp, kp, vp = (t.clone().requires_grad_() for t in (q, k, v))
    want = fa.flash_attention_torch(qp, kp, vp, causal=True)
    want.backward(do)
    for got, ref in ((out, want), (qt.grad, qp.grad), (kt.grad, kp.grad),
                     (vt.grad, vp.grad)):
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got.float(), ref.float(), rtol=tol,
                                   atol=tol)
    o, lse = fa.flash_attention_fwd_cuda(q, k, v, causal=True)
    again = [fa.flash_attention_bwd_cuda(q, k, v, o, lse, do, causal=True)
             for _ in range(2)]
    assert all(torch.equal(a, b) for a, b in zip(*again))
