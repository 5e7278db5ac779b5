"""Public kernel ops of the port, routed by the device of the tensors.

CUDA tensors go to the hand-written kernel, which launches or raises;
CPU tensors take its plain PyTorch version. There is no switch that
sends CUDA tensors down the plain path; the one size rule is the
reference's own (``lars_update`` below 1024 elements).
"""
from __future__ import annotations

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import lars as _lars
from repro_torch.kernels import lstm_cell as _lstm
from repro_torch.kernels import paged_attention as _pa

# ``repro.kernels.ops``' ``min_size`` for lars_update (ops.py:383): smaller
# leaves take the plain op, where a launch costs more than it saves.
LARS_MIN_SIZE = 1024


def attention(q, k, v, *, causal=True, window=None, q_offset=0, k_offset=0,
              scale=None):
    """Multi-head (GQA) full-sequence attention
    (``repro.kernels.ops.attention``), differentiable.

    q: (B, Sq, H, D); k, v: (B, Sk, K, D). Softmax accumulators in
    fp32; returns (B, Sq, H, D) in q's dtype. Offsets are the absolute
    positions of q[0] and k[0] and must be Python ints, as the TPU
    kernel requires; keys at negative positions are masked. CUDA
    tensors go through the flash-attention kernels (forward and
    backward), CPU tensors through their plain version.
    """
    for name, x in (("q_offset", q_offset), ("k_offset", k_offset)):
        if not isinstance(x, int):
            raise ValueError(f"attention: {name} must be a Python int")
    impl = (_fa.flash_attention_cuda if q.device.type == "cuda"
            else _fa.flash_attention_torch)
    return impl(q, k, v, causal=causal, window=window, q_offset=q_offset,
                k_offset=k_offset, scale=scale)


def paged_attention(q, kp, vp, page_table, *, pos, n_valid, window=None,
                    scale=None, kp_scale=None, vp_scale=None):
    """Ragged attention of C new tokens per row against a paged KV pool
    (``repro.kernels.ops.paged_attention``).

    q: (B, C, H, D); kp/vp: (P, page, K, hd) pools, the new tokens' K/V
    already written into their pages: bf16 or fp32 (hd == D), or int8
    (hd == D) and int4-packed (hd == D // 2) with fp32 per-row scales
    ``kp_scale``/``vp_scale`` of shape (P, page, K). page_table:
    (B, max_pages) int32 physical page ids (-1 unmapped); pos: (B,)
    absolute position of each row's first token; n_valid: (B,) real
    tokens per row. Returns (B, C, H, D) in q's dtype; queries past
    ``n_valid`` are garbage the caller masks. CUDA tensors go through
    the kernel's branch for the pool's kind, CPU tensors through its
    plain version.
    """
    impl = (_pa.paged_attention_cuda if q.device.type == "cuda"
            else _pa.paged_attention_torch)
    return impl(q, kp, vp, page_table, pos=pos, n_valid=n_valid,
                window=window, scale=scale, kp_scale=kp_scale,
                vp_scale=vp_scale)


def lstm_cell(x_proj, h_prev, c_prev, w_h, b):
    """Fused LSTM cell with the input projection pre-hoisted
    (``repro.kernels.ops.lstm_cell``, GNMT's C9), differentiable.

    x_proj: (B, 4F) this step's input projection; h_prev, c_prev: (B, F);
    w_h: (F, 4F); b: (4F,); gate order i, f, g, o. Returns (h in
    x_proj's dtype, c in fp32). CUDA tensors go through the forward and
    backward kernels, CPU tensors through the plain version.
    """
    impl = (_lstm.lstm_cell_cuda if x_proj.device.type == "cuda"
            else _lstm.lstm_cell_torch)
    return impl(x_proj, h_prev, c_prev, w_h, b)


def _is_cuda(t) -> bool:
    return t.device.type == "cuda"


def lars_update(w, g, m, *, lr, weight_decay, momentum, eta, eps=1e-9,
                scaled_momentum=True):
    """Fused LARS update of one leaf (``repro.kernels.ops.lars_update``,
    paper Fig. 5 ``scaled_momentum=True`` or Fig. 6), all math in fp32.

    w, g, m: one shape; ``lr`` a float or an fp32 0-d tensor. Returns
    (w', m'). CUDA tensors of at least ``LARS_MIN_SIZE`` (1024) elements
    go through the two CUDA kernels, which write w' and m' into w and m
    (contiguous fp32) and return them; smaller CUDA tensors and CPU
    tensors take the plain version, which returns new tensors. The size
    rule is the reference's own ``min_size`` (``ops.py:276-278``, ``:383``),
    not a fallback: every ResNet-50 leaf that reaches here is larger.
    """
    kw = dict(lr=lr, weight_decay=weight_decay, momentum=momentum, eta=eta,
              eps=eps, scaled_momentum=scaled_momentum)
    if _is_cuda(w) and w.numel() >= LARS_MIN_SIZE:
        return _lars.lars_update_cuda(w, g, m, **kw)
    return _lars.lars_update_torch(w, g, m, **kw)
