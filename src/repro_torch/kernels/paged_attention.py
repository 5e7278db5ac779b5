"""Ragged paged attention: the CUDA kernel's wrapper and its plain
PyTorch version.

The kernel (``csrc/paged_attention.cu``) replaces the TPU kernel
``repro/kernels/paged_attention.py:_kernel``, for bf16/fp32 pools and
for its quantized branches: int8 pools, and int4 pools packed two
values a byte over ``head_dim // 2``, each with fp32 per-(token,
kv-head) scales. It runs softmax attention for the C new tokens of each
batch row against only the pages that row maps, causal on absolute
positions, with an optional window and GQA. What bounds it on an H100
is the bytes of the K/V rows some valid query sees, read once, at 3.35
TB/s, a few microseconds at serving shapes; so it splits each row's
keys into blocks of :data:`SPLIT_KEYS` (flash-decoding): a block per
(key split, kv head, row) stages its split once for all the kv head's
query rows, and a second launch merges the splits in a fixed order.

:func:`paged_attention_cuda` launches the kernel on CUDA tensors and
raises on anything it does not take; :func:`paged_attention_torch` is
the plain version, which the CPU path and the on-card comparison use.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import quant

_DTYPES = (torch.bfloat16, torch.float32)
_HEAD_DIMS = (64, 128, 256)
SPLIT_KEYS = 64  # keys a split: ``kSplit`` in csrc/paged_attention.cu


def key_splits(page: int, max_pages: int) -> int:
    """Key splits (blocks per row and kv head) of a launch over a page
    table of ``max_pages`` pages of ``page`` tokens: static shapes only,
    so the host never reads the table, ``pos`` or ``n_valid``."""
    return -(-(page * max_pages) // SPLIT_KEYS)


def scratch_floats(B: int, C: int, H: int, D: int, page: int,
                   max_pages: int) -> int:
    """fp32 scratch of a launch: per (row, head, query, split) the
    split's unnormalised sum over D and its (max, sum) pair."""
    return B * C * H * key_splits(page, max_pages) * (D + 2)


def pool_kind(kp, kp_scale, head_dim: int) -> str:
    """The pool branch a call takes: 'bfloat16' or 'float32' for a plain
    pool, 'int8' or 'int4' (trailing axis ``head_dim // 2``) for a
    quantized one."""
    if kp_scale is None:
        return str(kp.dtype).replace("torch.", "")
    return "int8" if kp.shape[-1] == head_dim else "int4"


def check_scales(kp, vp, kp_scale, vp_scale, head_dim: int) -> None:
    """Raise unless the scales come as a pair and the pools' trailing
    axis is ``head_dim`` (plain, int8) or ``head_dim // 2`` (int4)."""
    if (kp_scale is None) != (vp_scale is None):
        raise ValueError("kp_scale and vp_scale must be passed together")
    hd = kp.shape[-1]
    if kp_scale is None:
        if hd != head_dim:
            raise ValueError(f"head_dim mismatch: q {head_dim} vs pool {hd}")
    elif hd not in (head_dim, head_dim // 2) or (hd != head_dim and head_dim % 2):
        raise ValueError(
            f"quantized pool trailing dim {hd} matches neither head_dim "
            f"{head_dim} (int8) nor head_dim//2 {head_dim // 2} (int4-packed)")
    if vp.shape != kp.shape:
        raise ValueError(f"K pool {tuple(kp.shape)} != V pool {tuple(vp.shape)}")


def paged_attention_torch(q, kp, vp, page_table, *, pos, n_valid,
                          window=None, scale=None, kp_scale=None,
                          vp_scale=None):
    """Gather the mapped pages, dequantize (``quant.dequantize``) if the
    pool is int8/int4, mask, fp32 softmax
    (``repro.kernels.ops._paged_attention_jnp``).

    q: (B, C, H, D); kp/vp: (P, page, K, D), or int4-packed
    (P, page, K, D // 2); kp_scale/vp_scale: (P, page, K) fp32 for a
    quantized pool; page_table: (B, max_pages) physical page ids (-1
    unmapped); pos, n_valid: (B,). Returns (B, C, H, D) in q's dtype.
    Queries past ``n_valid`` are garbage by contract; a row with nothing
    to attend returns the mean of V.
    """
    B, C, H, D = q.shape
    P, page, K, _ = kp.shape
    check_scales(kp, vp, kp_scale, vp_scale, D)
    G = H // K
    scale = scale if scale is not None else D ** -0.5
    npg = page_table.shape[1]
    dev = q.device
    pt = page_table.to(dev, torch.long)
    safe = pt.clamp(0, P - 1)
    if kp_scale is not None:
        kf = quant.dequantize(kp[safe], kp_scale[safe], D)
        vf = quant.dequantize(vp[safe], vp_scale[safe], D)
    else:
        kf = kp[safe].float()  # (B, npg, page, K, D)
        vf = vp[safe].float()
    kf = kf.reshape(B, npg * page, K, D)
    vf = vf.reshape(B, npg * page, K, D)
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
                         window=None, scale=None, kp_scale=None,
                         vp_scale=None):
    """Launch the CUDA kernel; same contract as
    :func:`paged_attention_torch`, except that queries past ``n_valid``
    come out as 0.

    Takes CUDA tensors on one device: q in bf16 or fp32; the pools in
    bf16 or fp32, or int8 with fp32 ``kp_scale``/``vp_scale`` of shape
    (P, page, K) (an int4 pool's trailing axis is ``D // 2``); head_dim
    64, 128 or 256; int32 page table, pos and n_valid; all contiguous,
    q and the pools 16-byte aligned. Allocates its scratch with
    ``torch.empty``, launches the split kernel and the merge on the
    current stream, does not synchronise, and counts each call in
    ``paged_attention_cuda.launches`` and, by pool kind ('bfloat16',
    'float32', 'int8', 'int4'), in ``paged_attention_cuda.launches_by_kind``.
    """
    B, C, H, D = q.shape
    P, page, K, _ = kp.shape
    check_scales(kp, vp, kp_scale, vp_scale, D)
    kind = pool_kind(kp, kp_scale, D)
    quantized = kp_scale is not None
    tensors = dict(q=q, kp=kp, vp=vp, page_table=page_table, pos=pos,
                   n_valid=n_valid)
    if quantized:
        tensors.update(kp_scale=kp_scale, vp_scale=vp_scale)
    for name, t in tensors.items():
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(
                f"paged_attention_cuda: {name} is on {t.device}; every "
                f"input must be a CUDA tensor on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"paged_attention_cuda: {name} is not contiguous")
    pool_ok = (kp.dtype == torch.int8 if quantized else kp.dtype in _DTYPES)
    if q.dtype not in _DTYPES or not pool_ok or vp.dtype != kp.dtype:
        raise TypeError(
            f"paged_attention_cuda: q {q.dtype}, pools {kp.dtype}/{vp.dtype}"
            f"{' with scales' if quantized else ''}; the kernel takes q in "
            f"bf16 or fp32 and bf16/fp32 pools, or int8 pools with scales "
            f"(one dtype for both pools)")
    if D not in _HEAD_DIMS:
        raise ValueError(
            f"paged_attention_cuda: head_dim {D}; the kernel takes "
            f"{_HEAD_DIMS}")
    if quantized:
        for name in ("kp_scale", "vp_scale"):
            t = tensors[name]
            if t.dtype != torch.float32 or tuple(t.shape) != (P, page, K):
                raise ValueError(
                    f"paged_attention_cuda: {name} must be float32 "
                    f"{(P, page, K)}, got {t.dtype} {tuple(t.shape)}")
    for name in ("q", "kp", "vp"):
        if tensors[name].data_ptr() % 16:
            raise ValueError(f"paged_attention_cuda: {name} is not 16-byte "
                             f"aligned")
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
    n_scratch = scratch_floats(B, C, H, D, page, npg)
    scratch = torch.empty(n_scratch, dtype=torch.float32, device=q.device)
    shape_args = (scratch.data_ptr(), n_scratch, B, C, H, K, D, P, page,
                  npg, window or 0,
                  float(scale if scale is not None else D ** -0.5),
                  int(q.dtype == torch.bfloat16))
    if quantized:
        err = lib.paged_attention_quant_launch(
            q.data_ptr(), kp.data_ptr(), vp.data_ptr(), kp_scale.data_ptr(),
            vp_scale.data_ptr(), page_table.data_ptr(), pos.data_ptr(),
            n_valid.data_ptr(), out.data_ptr(), *shape_args,
            int(kind == "int4"), stream)
    else:
        err = lib.paged_attention_launch(
            q.data_ptr(), kp.data_ptr(), vp.data_ptr(), page_table.data_ptr(),
            pos.data_ptr(), n_valid.data_ptr(), out.data_ptr(), *shape_args,
            int(kp.dtype == torch.bfloat16), stream)
    if err:
        raise RuntimeError(f"paged_attention launch ({kind} pool): CUDA "
                           f"error {err}")
    paged_attention_cuda.launches += 1
    paged_attention_cuda.launches_by_kind[kind] += 1
    return out


def reset_launches() -> None:
    """Zero :func:`paged_attention_cuda`'s launch counts."""
    paged_attention_cuda.launches = 0
    paged_attention_cuda.launches_by_kind = dict.fromkeys(
        ("bfloat16", "float32", "int8", "int4"), 0)


reset_launches()


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    n = ctypes.c_longlong
    fn = lib.paged_attention_launch
    if fn.argtypes is None:
        fn.argtypes = [p] * 8 + [n] + [i] * 9 + [f, i, i, p]
        fn.restype = i
    fn = lib.paged_attention_quant_launch
    if fn.argtypes is None:
        fn.argtypes = [p] * 10 + [n] + [i] * 9 + [f, i, i, p]
        fn.restype = i
    return lib
