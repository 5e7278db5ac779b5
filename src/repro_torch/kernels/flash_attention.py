"""Flash attention, forward and backward: the CUDA kernels' wrappers,
their autograd function and the plain PyTorch version.

The kernels (``csrc/flash_attention.cu``) replace the TPU kernel
``repro/kernels/flash_attention.py:flash_attention`` (``pallas_call`` at
line 102). The reference has no backward kernel; its train step
differentiates the jnp path ``ops._chunked_attention``. Here the
gradient is a backward kernel of the FlashAttention-2 scheme, which
recomputes P from q, k and the log-sum-exp the forward saved.

What bounds them on an H100 at the train shape (B 4, S 2048, 16 heads
of 256, causal, bf16) is tensor-core arithmetic: 4 * B * H * D flops per
visible query-key pair forward (0.139 ms at 989 TFLOP/s), 2.5 times that
backward, against 0.080 ms to move q, k, v and the output once. Each
block keeps a query (or key) tile on chip and walks only the tiles its
causal/window band reaches, so the masked half above the diagonal costs
nothing and no (S, S) score matrix ever reaches device memory.

:func:`flash_attention_fwd_cuda` / :func:`flash_attention_bwd_cuda`
launch the kernels on CUDA tensors and raise on anything they do not
take; :class:`FlashAttention` binds them to autograd;
:func:`flash_attention_torch` is the plain version, which the CPU path
and the on-card comparison use.
"""
from __future__ import annotations

import collections
import ctypes

import torch

_DTYPES = (torch.bfloat16, torch.float32)
_HEAD_DIMS = (64, 128, 256)


def visible_mask(Sq, Sk, *, causal, window, q_offset, k_offset,
                 device=None):
    """(Sq, Sk) bool: key j is visible to query i (absolute positions
    ``q_offset + i`` and ``k_offset + j``; keys at negative positions
    never are)."""
    qpos = q_offset + torch.arange(Sq, device=device)[:, None]
    kpos = k_offset + torch.arange(Sk, device=device)[None, :]
    mask = (kpos >= 0).expand(Sq, Sk)
    if causal:
        mask = mask & (kpos <= qpos)
    if window is not None:
        mask = mask & (kpos > qpos - window)
    return mask


def flash_attention_torch(q, k, v, *, causal=True, window=None, q_offset=0,
                          k_offset=0, scale=None):
    """Masked (B, H, Sq, Sk) fp32 scores, softmax, sum over V
    (``repro.kernels.ref.attention``); autograd gives its backward.

    q: (B, Sq, H, D); k, v: (B, Sk, K, D) with H % K == 0. Scale is
    applied to the fp32 scores; masking is a finite -1e30. A query with
    no visible key returns 0 (the kernel's choice; such rows are
    garbage by contract). Returns (B, Sq, H, D) in q's dtype.
    """
    B, Sq, H, D = q.shape
    _, Sk, K, _ = k.shape
    G = H // K
    scale = scale if scale is not None else D ** -0.5
    qf = q.float().reshape(B, Sq, K, G, D)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qf, k.float()) * scale
    mask = visible_mask(Sq, Sk, causal=causal, window=window,
                        q_offset=q_offset, k_offset=k_offset,
                        device=q.device)
    logits = logits.masked_fill(~mask, -1e30)
    probs = torch.softmax(logits, dim=-1) * mask
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v.float())
    return out.reshape(B, Sq, H, D).to(q.dtype)


def _check(name, tensors, q):
    """Device, dtype, contiguity and 16-byte alignment of the inputs;
    returns them contiguous and aligned (a copy where needed)."""
    out = []
    for label, t in tensors:
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(
                f"{name}: {label} is on {t.device}; every input must be a "
                f"CUDA tensor on {q.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name}: {label} is {t.dtype}, q is {q.dtype}")
        t = t.contiguous()
        if t.data_ptr() % 16:
            t = t.clone()
        out.append(t)
    return out


def _shapes(name, q, k, v):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(
            f"{name}: q (B, Sq, H, D) and k, v (B, Sk, K, D) expected, got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, Sq, H, D = q.shape
    Bk, Sk, K, Dk = k.shape
    if q.dtype not in _DTYPES:
        raise TypeError(f"{name}: {q.dtype}; the kernels take bf16 or fp32")
    if D not in _HEAD_DIMS or Dk != D or Bk != B:
        raise ValueError(
            f"{name}: head_dim {D} (k {Dk}), batch {B} (k {Bk}); the kernels "
            f"take head_dim {_HEAD_DIMS} and one batch")
    if K == 0 or H % K:
        raise ValueError(f"{name}: {H} heads over {K} kv heads")
    return B, Sq, Sk, H, K, D


def _offsets(name, window, q_offset, k_offset):
    for label, x in (("q_offset", q_offset), ("k_offset", k_offset)):
        if not isinstance(x, int):
            raise ValueError(
                f"{name}: {label} must be a Python int (static), as the "
                f"TPU kernel requires")
    if window is not None and window < 1:
        raise ValueError(f"{name}: window {window} < 1")


def flash_attention_fwd_cuda(q, k, v, *, causal=True, window=None,
                             q_offset=0, k_offset=0, scale=None):
    """Launch the forward kernel. Returns (out (B, Sq, H, D) in q's
    dtype, lse (B, H, Sq) fp32), with the contract of
    :func:`flash_attention_torch`; a row with no visible key has LSE
    +1e30.

    Takes CUDA tensors on one device, all bf16 or all fp32, head_dim 64,
    128 or 256; copies inputs that are not contiguous. Launches on the
    current stream, does not synchronise, and counts each launch in
    ``flash_attention_fwd_cuda.launches`` and, by (B, Sq, Sk, H, K, D,
    causal), in ``flash_attention_fwd_cuda.launches_by_shape``.
    """
    name = "flash_attention_fwd_cuda"
    B, Sq, Sk, H, K, D = _shapes(name, q, k, v)
    _offsets(name, window, q_offset, k_offset)
    q, k, v = _check(name, (("q", q), ("k", k), ("v", v)), q)
    out = torch.empty_like(q)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out, lse
    lib = _lib()
    err = lib.flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), B, Sq, Sk, H, K, D, int(causal), window or 0,
        q_offset, k_offset, float(scale if scale is not None else D ** -0.5),
        int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention_fwd: CUDA error {err}")
    flash_attention_fwd_cuda.launches += 1
    flash_attention_fwd_cuda.launches_by_shape[
        (B, Sq, Sk, H, K, D, bool(causal))] += 1
    return out, lse


def flash_attention_bwd_cuda(q, k, v, out, lse, dout, *, causal=True,
                             window=None, q_offset=0, k_offset=0, scale=None):
    """Launch the backward kernels (delta, then dK/dV, then dQ) for the
    forward that returned ``out`` and ``lse`` from q, k, v. ``dout`` is
    the gradient of ``out``. Returns (dq, dk, dv) in the inputs' dtype.

    Same inputs as :func:`flash_attention_fwd_cuda`; counts each launch
    in ``flash_attention_bwd_cuda.launches`` and ``.launches_by_shape``.
    """
    name = "flash_attention_bwd_cuda"
    B, Sq, Sk, H, K, D = _shapes(name, q, k, v)
    _offsets(name, window, q_offset, k_offset)
    if out.shape != q.shape or dout.shape != q.shape:
        raise ValueError(f"{name}: out {tuple(out.shape)} and dout "
                         f"{tuple(dout.shape)} must be shaped like q")
    if (lse.dtype != torch.float32 or tuple(lse.shape) != (B, H, Sq)
            or lse.device != q.device):
        raise ValueError(f"{name}: lse must be fp32 (B, H, Sq) on {q.device}")
    q, k, v, out, dout = _check(
        name, (("q", q), ("k", k), ("v", v), ("out", out), ("dout", dout)),
        q)
    lse = lse.contiguous()
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if q.numel() == 0 or k.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    delta = torch.empty_like(lse)
    err = _lib().flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), B, Sq, Sk, H, K, D, int(causal),
        window or 0, q_offset, k_offset,
        float(scale if scale is not None else D ** -0.5),
        int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention_bwd: CUDA error {err}")
    flash_attention_bwd_cuda.launches += 1
    flash_attention_bwd_cuda.launches_by_shape[
        (B, Sq, Sk, H, K, D, bool(causal))] += 1
    return dq, dk, dv


def reset_launches() -> None:
    """Zero both wrappers' launch counts, in total and by shape."""
    for fn in (flash_attention_fwd_cuda, flash_attention_bwd_cuda):
        fn.launches = 0
        fn.launches_by_shape = collections.Counter()


reset_launches()


class FlashAttention(torch.autograd.Function):
    """Attention through the forward kernel, with the backward kernels
    as its gradient. Works under ``torch.utils.checkpoint`` (the forward
    then runs again in the backward pass) and under ``torch.no_grad``."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset, k_offset, scale):
        out, lse = flash_attention_fwd_cuda(
            q, k, v, causal=causal, window=window, q_offset=q_offset,
            k_offset=k_offset, scale=scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.opts = dict(causal=causal, window=window, q_offset=q_offset,
                        k_offset=k_offset, scale=scale)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd_cuda(q, k, v, out, lse, dout,
                                              **ctx.opts)
        return dq, dk, dv, None, None, None, None, None


def flash_attention_cuda(q, k, v, *, causal=True, window=None, q_offset=0,
                         k_offset=0, scale=None):
    """Differentiable attention through the CUDA kernels."""
    return FlashAttention.apply(q, k, v, causal, window, q_offset, k_offset,
                                scale)


def _lib() -> ctypes.CDLL:
    from repro_torch.kernels import build

    lib = build.load("flash_attention")
    if lib.flash_attention_fwd.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.flash_attention_fwd.argtypes = (
            [p] * 5 + [i] * 10 + [ctypes.c_float, i, p])
        lib.flash_attention_fwd.restype = i
        lib.flash_attention_bwd.argtypes = (
            [p] * 10 + [i] * 10 + [ctypes.c_float, i, p])
        lib.flash_attention_bwd.restype = i
    return lib
