"""The MLPerf Transformer, SSD and Mask R-CNN on the card only (marked
``cuda``, skipped without one): the flash kernels at the Transformer's
shapes (16/16 heads of 64: the encoder non-causal, the decoder causal,
the cross-attention with fewer keys than queries) against the plain
version and its autograd, bf16 within 2e-2 and fp32 within 1e-4, the
backward rerun bitwise; each tiny model in fp32 on the card against the
CPU's plain path from the same weights (cuDNN and cuBLAS without TF32):
the loss within rtol 1e-5 and every gradient within 1e-3 of its leaf's
largest entry, the Transformer's attention through the kernels (6
forward and 6 backward launches: 2 encoder layers, 2 decoder layers of a
self- and a cross-attention; no remat); and two bf16 steps' losses and
weights bitwise equal on the card (no float atomics in any backward). This file imports no JAX, so
it runs on a card where JAX is missing."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.launch import mlperf as cli
from repro_torch.utils import tree_leaves, tree_map


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.fixture
def no_tf32():
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    (torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = saved


# (B, Sq, Sk, causal): the encoder and decoder at the paper's 97, the
# cross-attention over a shorter source, and at 256
SHAPES = [(2, 97, 97, False), (2, 97, 97, True), (2, 97, 71, False),
          (1, 256, 256, True), (1, 256, 200, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_cuda_flash_at_transformer_shapes(cuda_device, shape, dtype):
    B, Sq, Sk, causal = shape
    H, D = 16, 64
    dt = getattr(torch, dtype)
    tol = 2e-2 if dt == torch.bfloat16 else 1e-4
    gen = torch.Generator().manual_seed(Sq + Sk)
    q, k, v, do = (torch.randn(s, generator=gen).to(cuda_device, dt)
                   for s in ((B, Sq, H, D), (B, Sk, H, D), (B, Sk, H, D),
                             (B, Sq, H, D)))
    before = (fa.flash_attention_fwd_cuda.launches,
              fa.flash_attention_bwd_cuda.launches)
    qt, kt, vt = (t.clone().requires_grad_() for t in (q, k, v))
    out = ops.attention(qt, kt, vt, causal=causal)
    out.backward(do)
    torch.cuda.synchronize()
    assert (fa.flash_attention_fwd_cuda.launches,
            fa.flash_attention_bwd_cuda.launches) == (before[0] + 1,
                                                      before[1] + 1)
    qp, kp, vp = (t.clone().requires_grad_() for t in (q, k, v))
    want = fa.flash_attention_torch(qp, kp, vp, causal=causal)
    want.backward(do)
    for got, ref in ((out, want), (qt.grad, qp.grad), (kt.grad, kp.grad),
                     (vt.grad, vp.grad)):
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got.float(), ref.float(), rtol=tol,
                                   atol=tol)
    o, lse = fa.flash_attention_fwd_cuda(q, k, v, causal=causal)
    a, b = (fa.flash_attention_bwd_cuda(q, k, v, o, lse, do, causal=causal)
            for _ in range(2))
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def fp32(model, cfg):
    if model == "transformer":
        return dataclasses.replace(cfg, dtype="float32")
    return dataclasses.replace(cfg, dtype="float32", backbone=dataclasses.
                               replace(cfg.backbone, dtype="float32"))


def loss_and_grads(model, cfg, params, batch):
    leaves = tree_leaves(params)
    for w in leaves:
        w.requires_grad_(True)
    loss, _ = cli.loss_of(model, cfg)(params, batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss.item(), [torch.zeros_like(w) if g is None else g
                         for w, g in zip(leaves, grads)]


@pytest.mark.cuda
@pytest.mark.parametrize("model", cli.MODELS)
def test_cuda_tiny_models_match_cpu(cuda_device, no_tf32, model):
    cfg = fp32(model, cli.configs(model))
    init = cli.init_params(model, cfg, 3, device="cpu")
    batch = cli.synthetic_batch(model, cfg, 2, np.random.default_rng(3),
                                seq=40)
    out = {}
    fa.reset_launches()
    for dev in ("cpu", "cuda"):
        params = tree_map(lambda w: w.to(dev, copy=True), init)
        loss, grads = loss_and_grads(model, cfg, params,
                                     cli.to_device(batch, dev))
        out[dev] = (loss, [g.cpu() for g in grads])
    (lc, gc), (lg, gg) = out["cpu"], out["cuda"]
    assert abs(lc - lg) <= 1e-5 * abs(lc)
    for a, b in zip(gc, gg):
        scale = a.abs().max().item() + 1e-12
        assert (a - b).abs().max().item() <= 1e-3 * scale
    n = 2 * cfg.n_layers + cfg.n_enc_layers if model == "transformer" else 0
    assert (fa.flash_attention_fwd_cuda.launches,
            fa.flash_attention_bwd_cuda.launches) == (n, n)


@pytest.mark.cuda
@pytest.mark.parametrize("model", cli.MODELS)
def test_cuda_bf16_steps_repeat_bitwise(cuda_device, model):
    cfg = cli.configs(model)
    batch = cli.to_device(cli.synthetic_batch(
        model, cfg, 2, np.random.default_rng(4)), "cuda")
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        runs = []
        for _ in range(2):
            params = cli.init_params(model, cfg, 4, device="cuda")
            hist = cli.train(cli.loss_of(model, cfg), params, batch, steps=2,
                             device="cuda", log=lambda _: None)
            runs.append(([r["loss"] for r in hist],
                         [w.detach().clone() for w in tree_leaves(params)]))
    finally:
        torch.backends.cudnn.deterministic = det
    assert runs[0][0] == runs[1][0] and all(np.isfinite(runs[0][0]))
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))
