"""Public kernel ops of the port, routed by the device of the tensors.

CUDA tensors go to the hand-written kernel, which launches or raises;
CPU tensors take its plain PyTorch version. There is no switch that
sends CUDA tensors down the plain path.
"""
from __future__ import annotations

from repro_torch.kernels import paged_attention as _pa


def paged_attention(q, kp, vp, page_table, *, pos, n_valid, window=None,
                    scale=None, kp_scale=None, vp_scale=None):
    """Ragged attention of C new tokens per row against a paged KV pool
    (``repro.kernels.ops.paged_attention``).

    q: (B, C, H, D); kp/vp: (P, page, K, D) bf16 or fp32 pools, the new
    tokens' K/V already written into their pages; page_table:
    (B, max_pages) int32 physical page ids (-1 unmapped); pos: (B,)
    absolute position of each row's first token; n_valid: (B,) real
    tokens per row. Returns (B, C, H, D) in q's dtype; queries past
    ``n_valid`` are garbage the caller masks.
    """
    if kp_scale is not None or vp_scale is not None:
        raise NotImplementedError(
            "quantized (int8/int4) paged pools are the next serving slice "
            "of the port")
    impl = (_pa.paged_attention_cuda if q.device.type == "cuda"
            else _pa.paged_attention_torch)
    return impl(q, kp, vp, page_table, pos=pos, n_valid=n_valid,
                window=window, scale=scale)
