"""Public kernel ops of the port, routed by the device of the tensors.

CUDA tensors go to the hand-written kernel, which launches or raises;
CPU tensors take its plain PyTorch version. There is no switch that
sends CUDA tensors down the plain path; the one size rule is the
reference's own (``lars_update`` below 1024 elements). The ops that
have no Pallas kernel in the reference (``decode_attention``,
``moe_gating``, ``mamba_step``) are plain PyTorch on both devices.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import lars as _lars
from repro_torch.kernels import lstm_cell as _lstm
from repro_torch.kernels import mamba as _mamba
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


def lars_update_leaves(ws, gs, ms, *, lr, weight_decay, momentum, eta,
                       eps=1e-9, scaled_momentum=True):
    """:func:`lars_update` over many leaves, each with its own trust: a
    list of (w', m'), one pair a leaf, in order. The CUDA leaves of at
    least ``LARS_MIN_SIZE`` elements share one norms launch and one update
    launch (one of each for every ``MAX_LEAVES`` of them), which writes w'
    and m' into w and m; the other leaves take the plain version per leaf,
    as :func:`lars_update` routes them."""
    kw = dict(lr=lr, weight_decay=weight_decay, momentum=momentum, eta=eta,
              eps=eps, scaled_momentum=scaled_momentum)
    out = [None] * len(ws)
    big = [i for i, w in enumerate(ws)
           if _is_cuda(w) and w.numel() >= LARS_MIN_SIZE]
    if big:
        bw, bg, bm = ([x[i] for i in big] for x in (ws, gs, ms))
        _, parts = _lars.lars_norms_multi_cuda(bw, bg)
        _lars.lars_apply_multi_cuda(bw, bg, bm, parts, **kw)
        for i in big:
            out[i] = (ws[i], ms[i])
    for i, o in enumerate(out):
        if o is None:
            out[i] = _lars.lars_update_torch(ws[i], gs[i], ms[i], **kw)
    return out


def mamba_scan(u, dt, A, B, C, D, *, state_every=_mamba.STATE_EVERY):
    """Mamba S6 selective scan from h = 0 (``repro.kernels.ops.mamba_scan``),
    differentiable.

    u, dt: (Bt, S, Di); A: (Di, N); B, C: (Bt, S, N); D: (Di,). Returns
    (y (Bt, S, Di) in u's dtype, final h (Bt, Di, N) fp32). Where
    autograd records, through ``MambaScan``: the forward saves the state
    every ``state_every`` steps and the backward rebuilds each chunk from
    it; otherwise (serving) the forward alone. CUDA tensors go through
    the ``mamba_scan`` kernels, CPU tensors through their plain versions.
    """
    args = (u, dt, A, B, C, D)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return _mamba.MambaScan.apply(*args, state_every)
    if u.device.type == "cuda":
        return _mamba.mamba_scan_cuda(*args)
    return _mamba.mamba_scan_torch(*args)


def mamba_step(h, u_t, dt_t, A, B_t, C_t, D):
    """One decode step of the selective scan (``repro.kernels.ops.
    mamba_step``, ``ops.py:341-352``), plain PyTorch on both devices: the
    reference has no Pallas kernel for it. h: (Bt, Di, N) fp32; u_t,
    dt_t: (Bt, Di); B_t, C_t: (Bt, N). Returns (h', y (Bt, Di) in u_t's
    dtype)."""
    dt32, u32 = dt_t.float(), u_t.float()
    da = torch.exp(dt32[..., None] * A.float())
    h = da * h + dt32[..., None] * B_t.float()[:, None, :] * u32[..., None]
    y = torch.einsum("bdn,bn->bd", h, C_t.float()) + D.float() * u32
    return h, y.to(u_t.dtype)


def moe_gating(x, router_w, *, top_k, capacity):
    """Top-k gating with capacity dispatch (``repro.kernels.ref.
    moe_gating``, ``ref.py:143-180``), plain PyTorch on both devices: the
    reference has no Pallas kernel for it.

    x: (G, S, d); router_w: (d, E). Each of ``top_k`` rounds sends every
    token to its best remaining expert (ties to the lowest index), at
    the next free position of that expert's ``capacity`` slots in the
    group, or nowhere once they are full. Returns (dispatch (G, S, E,
    capacity) fp32 0/1, combine (same) fp32 gate weights, aux scalar: the
    Switch load-balance loss ``E * sum_e f_e * p_e``)."""
    G, S, _ = x.shape
    E = router_w.shape[-1]
    gates = torch.softmax(x.float() @ router_w.float(), dim=-1)  # (G, S, E)
    dispatch = torch.zeros((G, S, E, capacity), dtype=torch.float32,
                           device=x.device)
    combine = torch.zeros_like(dispatch)
    slots = torch.arange(capacity, device=x.device)
    fill = torch.zeros((G, E), dtype=torch.int64, device=x.device)
    remaining = gates
    for _ in range(top_k):
        idx = torch.argmax(remaining, dim=-1)                    # (G, S)
        gate = torch.gather(remaining, -1, idx[..., None])[..., 0]
        onehot = F.one_hot(idx, E).float()                       # (G, S, E)
        pos = torch.cumsum(onehot, dim=1) - onehot + fill[:, None, :]
        pos_tok = torch.gather(pos, -1, idx[..., None])[..., 0].long()
        keep = pos_tok < capacity
        poh = (pos_tok[..., None] == slots).float()              # (G, S, C)
        d_k = (onehot[..., None] * poh[:, :, None, :]
               * keep[..., None, None])
        dispatch = dispatch + d_k
        combine = combine + d_k * gate[..., None, None]
        fill = fill + (onehot * keep[..., None]).sum(1).long()
        remaining = remaining * (1.0 - onehot)
    top1 = F.one_hot(torch.argmax(gates, dim=-1), E).float()
    aux = E * torch.sum(top1.mean(dim=(0, 1)) * gates.mean(dim=(0, 1)))
    return dispatch, combine, aux


def decode_attention(q, k_cache, v_cache, slot_pos, *, pos, window=None,
                     scale=None, k_scale=None, v_scale=None):
    """One-token attention against a slab KV cache (``repro.kernels.ops.
    decode_attention``, ``_decode_attention_jnp`` at ``ops.py:167``),
    plain PyTorch on both devices: the reference has no Pallas kernel
    for it.

    q: (B, 1, H, D); k_cache/v_cache: (B, L, K, D), float or int8 with
    fp32 ``k_scale``/``v_scale`` (B, L, K); slot_pos: (B, L) int32, the
    position in each slot (-1 empty); pos: an int or (B,) per-row
    positions. A slot is visible when 0 <= slot_pos <= pos (and within
    ``window``); masking is a finite -1e30. Returns (B, 1, H, D) in q's
    dtype."""
    B, _, H, D = q.shape
    K = k_cache.shape[2]
    scale = scale if scale is not None else D ** -0.5
    kf, vf = k_cache.float(), v_cache.float()
    if k_scale is not None:
        kf = kf * k_scale[..., None].float()
    if v_scale is not None:
        vf = vf * v_scale[..., None].float()
    qf = (q.float() * scale).reshape(B, K, H // K, D)
    logits = torch.einsum("bkgd,blkd->bkgl", qf, kf)
    posb = torch.as_tensor(pos, device=q.device).long().reshape(-1, 1)
    valid = (slot_pos >= 0) & (slot_pos <= posb)
    if window is not None:
        valid &= slot_pos > posb - window
    logits = logits.masked_fill(~valid[:, None, None, :], -1e30)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgl,blkd->bkgd", probs, vf)
    return out.reshape(B, 1, H, D).to(q.dtype)
