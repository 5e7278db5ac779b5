"""Ragged paged attention: the CUDA kernel's wrapper and its plain
PyTorch version.

The kernel (``csrc/paged_attention.cu``) replaces the TPU kernel
``repro/kernels/paged_attention.py:_kernel``. It runs online-softmax
attention for the C new tokens of each batch row against only the
pages that row maps, causal on absolute positions, with an optional
window and GQA. What bounds it on an H100 is the bytes of the occupied
K/V pages, read once, at 3.35 TB/s: one block per (row, head, 4
queries) walks just the key range its valid queries can see, so a
ragged batch pays for the tokens it holds, not for ``max_pages``.

:func:`paged_attention_cuda` launches the kernel on CUDA tensors and
raises on anything it does not take; :func:`paged_attention_torch` is
the plain version, which the CPU path and the on-card comparison use.
"""
from __future__ import annotations

import ctypes

import torch

_DTYPES = (torch.bfloat16, torch.float32)
_HEAD_DIMS = (64, 128, 256)


def paged_attention_torch(q, kp, vp, page_table, *, pos, n_valid,
                          window=None, scale=None):
    """Gather the mapped pages, mask, fp32 softmax
    (``repro.kernels.ops._paged_attention_jnp``).

    q: (B, C, H, D); kp/vp: (P, page, K, D); page_table: (B, max_pages)
    physical page ids (-1 unmapped); pos, n_valid: (B,). Returns
    (B, C, H, D) in q's dtype. Queries past ``n_valid`` are garbage by
    contract; a row with nothing to attend returns the mean of V.
    """
    B, C, H, D = q.shape
    P, page, K, _ = kp.shape
    G = H // K
    scale = scale if scale is not None else D ** -0.5
    npg = page_table.shape[1]
    dev = q.device
    pt = page_table.to(dev, torch.long)
    safe = pt.clamp(0, P - 1)
    kf = kp[safe].float().reshape(B, npg * page, K, D)
    vf = vp[safe].float().reshape(B, npg * page, K, D)
    qf = (q.float() * scale).reshape(B, C, K, G, D)
    logits = torch.einsum("bckgd,blkd->bckgl", qf, kf)
    kpos = torch.arange(npg * page, device=dev)
    posv = pos.to(dev, torch.long).reshape(B)
    qpos = posv[:, None] + torch.arange(C, device=dev)[None, :]
    lim = posv + n_valid.to(dev, torch.long).reshape(B)
    mapped = (pt >= 0).repeat_interleave(page, dim=1)  # (B, L)
    valid = mapped[:, None, :] & (kpos[None, None, :] < lim[:, None, None])
    valid = valid & (kpos[None, None, :] <= qpos[:, :, None])
    if window is not None:
        valid = valid & (kpos[None, None, :] > qpos[:, :, None] - window)
    logits = logits.masked_fill(~valid[:, :, None, None, :], -1e30)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bckgl,blkd->bckgd", probs, vf)
    return out.reshape(B, C, H, D).to(q.dtype)


def paged_attention_cuda(q, kp, vp, page_table, *, pos, n_valid,
                         window=None, scale=None):
    """Launch the CUDA kernel; same contract as
    :func:`paged_attention_torch`, except that queries past ``n_valid``
    come out as 0.

    Takes CUDA tensors on one device: q in bf16 or fp32, the pools in
    bf16 or fp32, head_dim 64, 128 or 256, int32 page table, pos and
    n_valid, all contiguous. Launches on the current stream, does not
    synchronise, and counts each launch in ``paged_attention_cuda.launches``.
    """
    B, C, H, D = q.shape
    P, page, K, hd = kp.shape
    tensors = dict(q=q, kp=kp, vp=vp, page_table=page_table, pos=pos,
                   n_valid=n_valid)
    for name, t in tensors.items():
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(
                f"paged_attention_cuda: {name} is on {t.device}; every "
                f"input must be a CUDA tensor on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"paged_attention_cuda: {name} is not contiguous")
    if q.dtype not in _DTYPES or kp.dtype not in _DTYPES or vp.dtype != kp.dtype:
        raise TypeError(
            f"paged_attention_cuda: q {q.dtype}, pools {kp.dtype}/{vp.dtype}; "
            f"the kernel takes bf16 or fp32 (one dtype for both pools)")
    if D not in _HEAD_DIMS or hd != D or vp.shape != kp.shape:
        raise ValueError(
            f"paged_attention_cuda: head_dim {D} (pool {hd}); the kernel "
            f"takes {_HEAD_DIMS} with matching K and V pools")
    if H % K:
        raise ValueError(f"paged_attention_cuda: {H} heads over {K} kv heads")
    npg = page_table.shape[-1]
    for name, t, shape in (("page_table", page_table, (B, npg)),
                           ("pos", pos, (B,)), ("n_valid", n_valid, (B,))):
        if t.dtype != torch.int32 or tuple(t.shape) != shape:
            raise ValueError(
                f"paged_attention_cuda: {name} must be int32 {shape}, got "
                f"{t.dtype} {tuple(t.shape)}")
    if window is not None and window < 1:
        raise ValueError(f"paged_attention_cuda: window {window} < 1")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    from repro_torch.kernels import build

    lib = _bind(build.load("paged_attention"))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.paged_attention_launch(
        q.data_ptr(), kp.data_ptr(), vp.data_ptr(), page_table.data_ptr(),
        pos.data_ptr(), n_valid.data_ptr(), out.data_ptr(), B, C, H, K, D, P,
        page, npg, window or 0,
        float(scale if scale is not None else D ** -0.5),
        int(q.dtype == torch.bfloat16), int(kp.dtype == torch.bfloat16),
        stream)
    if err:
        raise RuntimeError(f"paged_attention_launch: CUDA error {err}")
    paged_attention_cuda.launches += 1
    return out


paged_attention_cuda.launches = 0


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    fn = lib.paged_attention_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 7 + [i] * 9 + [ctypes.c_float, i, i, p]
        fn.restype = i
    return lib
