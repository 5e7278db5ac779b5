"""Mamba S6 selective scan: the CUDA kernels' wrappers, their autograd
function and the plain PyTorch versions.

The forward kernel (``csrc/mamba_scan.cu``) replaces the TPU kernel
``repro/kernels/mamba.py:mamba_scan`` (``pallas_call`` at line 58, body
``_kernel`` at :22). From h = 0 it runs, for every batch row and channel,

    h_t = exp(dt_t * A) * h_{t-1} + (dt_t * u_t) * B_t
    y_t = h_t . C_t + D * u_t

with the (channel, N) state in registers for the whole time loop (4
threads a channel, N / 4 states each, for N up to 16) and time streamed
through shared memory, the next 16 steps loaded while the current ones
run, so no (S, Di, N) tensor ever reaches device memory. The decay is
CUDA's ``expf`` of the rounded ``dt * A``, bitwise what ``torch.exp``
gives on the card, so the scan holds the reference's tolerance at S 2048
(an ``ex2.approx`` decay drifted past it), and h . C is summed over a
channel's lanes once every 4 steps, in a fixed order
(``tests/test_torch_mamba.py`` writes that arithmetic out in PyTorch).
What bounds it on an H100 at Jamba's prefill shape (Bt 1, S 256, Di
16384, N 16) is the S * Di * N exponentials on the special-function units
(about 0.016 ms) more than its 35.7 MB of traffic (0.0107 ms). For
training it also writes the state at every K-th step (the boundaries of
K-step chunks, K = ``STATE_EVERY`` = 16 on the train path).

The backward kernel is the port's own: the reference differentiates its
scan with ``jax.grad`` of the chunked, checkpointed ``lax.scan``
(``repro/kernels/ops.py:_mamba_scan_jnp``). It walks the chunks from last
to first, rebuilds each 16-step tile's states from its boundary state in
registers with the forward's decay (bitwise the forward's states), keeps
the decays in shared memory for the reverse recurrence
(:func:`mamba_scan_bwd_torch` writes it out) and stages the next tile
while one runs, so the (S, Di, N) history that autograd through the plain
scan would keep (2.1 GB a layer at S 2048) never exists. dB and dC are
sums over every channel (one partial a block of 64 channels, summed in
block order by a second launch) and dA and dD over every row, all in a
fixed order without atomics. At Jamba's train shape (Bt 1, S 2048) it
moves ~607 MB (0.181 ms at 3.35 TB/s) against 0.128 ms of exponentials;
:func:`bwd_kernel_info` reports its registers, blocks an SM and waves.

:func:`mamba_scan_cuda` and :func:`mamba_scan_bwd_cuda` launch the
kernels on CUDA tensors and raise on anything they do not take;
:func:`mamba_scan_torch` and :func:`mamba_scan_bwd_torch` are the plain
versions (the forward in the operation order of
``repro.kernels.ops._mamba_scan_jnp``), which the CPU path and the
on-card comparison use; :class:`MambaScan` binds a pair to autograd
(``ops.mamba_scan`` routes by device and by whether autograd records).
"""
from __future__ import annotations

import ctypes

import torch

_U_DTYPES = (torch.bfloat16, torch.float32)
MAX_STATE = 64  # csrc/mamba_scan.cu kMaxN
TIME_TILE = 16  # csrc/mamba_scan.cu kT: state_every is a multiple of it
# The training path's chunk: one boundary state saved every 16 steps, so
# the backward kernel rebuilds a chunk without walking earlier tiles.
STATE_EVERY = 16


def n_saved_states(S: int, K: int) -> int:
    """Boundary states a scan of S steps saves with ``state_every`` K: one
    at each K-step chunk boundary inside the sequence, (S - 1) // K."""
    return max(0, (S - 1) // K)


def mamba_scan_torch(u, dt, A, B, C, D, *, state_every=None):
    """Sequential selective scan in fp32, step by step as
    ``_mamba_scan_jnp`` (``repro/kernels/ops.py:308-338``) orders it:
    ``h = exp(dt*A)*h + dt*B*u``, ``y = einsum(h, C) + D*u``.

    u, dt: (Bt, S, Di); A: (Di, N); B, C: (Bt, S, N); D: (Di,). Returns
    (y (Bt, S, Di) in u's dtype, final h (Bt, Di, N) fp32); with
    ``state_every`` K also the boundary states (Bt, (S - 1) // K, Di, N)
    fp32: h after steps K - 1, 2K - 1, ..., the state entering each K-step
    chunk but the first (:func:`mamba_scan_bwd_torch` starts from them)."""
    u32, dt32, B32, C32 = (t.float() for t in (u, dt, B, C))
    A32, D32 = A.float(), D.float()
    Bt, S, Di = u.shape
    h = torch.zeros((Bt, Di, A.shape[-1]), dtype=torch.float32,
                    device=u.device)
    ys, hs = [], []
    for t in range(S):
        u_t, dt_t = u32[:, t], dt32[:, t]
        da = torch.exp(dt_t[..., None] * A32[None])
        h = da * h + dt_t[..., None] * B32[:, t, None, :] * u_t[..., None]
        ys.append(torch.einsum("bdn,bn->bd", h, C32[:, t]) + D32 * u_t)
        if state_every and (t + 1) % state_every == 0 and t + 1 < S:
            hs.append(h)
    y = (torch.stack(ys, dim=1) if ys
         else torch.zeros_like(u32))
    if not state_every:
        return y.to(u.dtype), h
    hs = (torch.stack(hs, dim=1) if hs
          else h.new_zeros((Bt, 0) + tuple(h.shape[1:])))
    return y.to(u.dtype), h, hs


def mamba_scan_bwd_torch(u, dt, A, B, C, D, hs, dy, dh=None, *,
                         state_every):
    """The scan's backward from its boundary states ``hs`` (what
    :func:`mamba_scan_torch` saves with the same ``state_every`` K), step
    by step in fp32: for each K-step chunk from last to first, its states
    rebuilt from the chunk's boundary state (zero for the first), then the
    reverse recurrence with g = dL/dh, from ``dh`` (the final state's
    cotangent; zero when None):

        g += C_t dy_t;                 a = exp(dt_t A)
        du_t = D dy_t + dt_t sum_n g B_t
        ddt_t = sum_n g (A a h_{t-1} + B_t u_t)
        dA += g dt_t a h_{t-1};        dD += dy_t u_t
        dB_t = sum_d g dt_t u_t;       dC_t = sum_d h_t dy_t
        g *= a

    dy: (Bt, S, Di). Returns (du in u's dtype, ddt (Bt, S, Di), dA (Di,
    N), dB, dC (Bt, S, N), dD (Di,)), all but du fp32."""
    K = state_every
    u32, dt32, B32, C32, dy32 = (t.float() for t in (u, dt, B, C, dy))
    A32, D32 = A.float(), D.float()
    Bt, S, Di = u.shape
    N = A.shape[-1]
    dev = u.device
    g = (dh.float() if dh is not None
         else torch.zeros((Bt, Di, N), dtype=torch.float32, device=dev))
    du = torch.zeros((Bt, S, Di), dtype=torch.float32, device=dev)
    ddt = torch.zeros_like(du)
    dB = torch.zeros((Bt, S, N), dtype=torch.float32, device=dev)
    dC = torch.zeros_like(dB)
    dA = torch.zeros((Di, N), dtype=torch.float32, device=dev)
    dD = torch.zeros((Di,), dtype=torch.float32, device=dev)
    for j in reversed(range(-(-S // K))):
        t0, t1 = j * K, min(S, (j + 1) * K)
        h = hs[:, j - 1].float() if j else torch.zeros_like(g)
        hist = [h]
        for t in range(t0, t1):  # the forward's arithmetic, states kept
            u_t, dt_t = u32[:, t], dt32[:, t]
            da = torch.exp(dt_t[..., None] * A32[None])
            h = da * h + dt_t[..., None] * B32[:, t, None, :] * u_t[..., None]
            hist.append(h)
        for t in reversed(range(t0, t1)):
            u_t, dt_t, dy_t = u32[:, t], dt32[:, t], dy32[:, t]
            h_prev, h_t = hist[t - t0], hist[t - t0 + 1]
            g = g + C32[:, t, None, :] * dy_t[..., None]
            dC[:, t] = torch.einsum("bdn,bd->bn", h_t, dy_t)
            da = torch.exp(dt_t[..., None] * A32[None])
            ah = da * h_prev
            du[:, t] = D32 * dy_t + dt_t * torch.einsum("bdn,bn->bd", g,
                                                        B32[:, t])
            ddt[:, t] = (g * (A32[None] * ah + B32[:, t, None, :]
                              * u_t[..., None])).sum(-1)
            gdt = g * dt_t[..., None]
            dA += (gdt * ah).sum(0)
            dB[:, t] = torch.einsum("bdn,bd->bn", gdt, u_t)
            dD += (dy_t * u_t).sum(0)
            g = g * da
    return du.to(u.dtype), ddt, dA, dB, dC, dD


def _check(name, label, t, dev, dtypes, shape):
    if t.device != dev:
        raise ValueError(f"{name}: {label} is on {t.device}; every input must "
                         f"be a CUDA tensor on {dev}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: {label} is {t.dtype}; the kernel takes "
                        f"{' or '.join(map(str, dtypes))}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name}: {label} has shape {tuple(t.shape)}, "
                         f"expected {shape}")


def _check_scan(name, u, dt, A, B, C, D):
    """The checks both kernels make on the forward's inputs; returns (Bt,
    S, Di, N)."""
    dev = u.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: u is on {dev}; the kernel takes CUDA "
                         f"tensors (the plain version is "
                         f"{name.replace('cuda', 'torch')})")
    if u.dim() != 3 or A.dim() != 2:
        raise ValueError(f"{name}: u must be (Bt, S, Di) and A (Di, N), got "
                         f"{tuple(u.shape)} and {tuple(A.shape)}")
    Bt, S, Di = u.shape
    N = A.shape[1]
    f32 = (torch.float32,)
    _check(name, "u", u, dev, _U_DTYPES, (Bt, S, Di))
    _check(name, "dt", dt, dev, f32, (Bt, S, Di))
    _check(name, "A", A, dev, f32, (Di, N))
    _check(name, "B", B, dev, f32, (Bt, S, N))
    _check(name, "C", C, dev, f32, (Bt, S, N))
    _check(name, "D", D, dev, f32, (Di,))
    if not 1 <= N <= MAX_STATE or Bt < 1 or Bt > 65535 or Di < 1:
        raise ValueError(f"{name}: needs 1 <= N <= {MAX_STATE}, 1 <= Bt <= "
                         f"65535 and Di >= 1, got N {N}, Bt {Bt}, Di {Di}")
    for label, t in (("B", B), ("C", C)):
        if N > 1 and t.stride(2) != 1:
            raise ValueError(f"{name}: {label}'s last axis must be "
                             f"contiguous, strides {t.stride()}")
    return Bt, S, Di, N


def _check_every(name, K):
    if K <= 0 or K % TIME_TILE:
        raise ValueError(f"{name}: state_every must be a positive multiple "
                         f"of {TIME_TILE} (the kernel's time tile), got {K}")


def mamba_scan_cuda(u, dt, A, B, C, D, *, state_every=None):
    """:func:`mamba_scan_torch` through the CUDA kernel: u bf16 or fp32,
    dt, A, B, C and D fp32, all on one CUDA device; B and C may be views
    whose last axis is contiguous (the model's column slices of one
    projection), the others are made contiguous. N at most 64. Returns
    (y in u's dtype, h fp32), and with ``state_every`` K (a multiple of
    16) also the boundary states (Bt, (S - 1) // K, Di, N) fp32 of
    :func:`mamba_scan_torch`; y and h are bitwise the same either way.
    Launches on the current stream, does not synchronise, and counts each
    launch in ``mamba_scan_cuda.launches``."""
    name = "mamba_scan_cuda"
    Bt, S, Di, N = _check_scan(name, u, dt, A, B, C, D)
    if state_every is not None:
        _check_every(name, state_every)
    dev = u.device
    u, dt, A, D = (t.contiguous() for t in (u, dt, A, D))
    y = torch.empty_like(u)
    h = torch.empty((Bt, Di, N), dtype=torch.float32, device=dev)
    hs = (None if state_every is None else torch.empty(
        (Bt, n_saved_states(S, state_every), Di, N), dtype=torch.float32,
        device=dev))
    err = _lib().mamba_scan(
        u.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
        C.data_ptr(), D.data_ptr(), y.data_ptr(), h.data_ptr(),
        None if hs is None else hs.data_ptr(), Bt, S, Di, N,
        state_every or 0, B.stride(0), B.stride(1), C.stride(0),
        C.stride(1), int(u.dtype == torch.bfloat16),
        torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"mamba_scan: CUDA error {err}")
    mamba_scan_cuda.launches += 1
    return (y, h) if hs is None else (y, h, hs)


mamba_scan_cuda.launches = 0


def mamba_scan_bwd_cuda(u, dt, A, B, C, D, hs, dy, dh=None, *,
                        state_every):
    """:func:`mamba_scan_bwd_torch` through the CUDA backward kernel: the
    forward's inputs as :func:`mamba_scan_cuda` takes them, ``hs`` the
    boundary states it saved with the same ``state_every`` (fp32), dy in
    u's dtype, dh None or (Bt, Di, N) fp32. Returns (du in u's dtype,
    ddt, dA, dB, dC, dD fp32; dB and dC contiguous). Two launches (the
    scan, then the sum of its per-block dB and dC partials, in block
    order: no atomics; the partials' count comes from the library),
    counted once in ``mamba_scan_bwd_cuda.launches``."""
    name = "mamba_scan_bwd_cuda"
    Bt, S, Di, N = _check_scan(name, u, dt, A, B, C, D)
    _check_every(name, state_every)
    dev = u.device
    _check(name, "hs", hs, dev, (torch.float32,),
           (Bt, n_saved_states(S, state_every), Di, N))
    _check(name, "dy", dy, dev, (u.dtype,), (Bt, S, Di))
    if dh is not None:
        _check(name, "dh", dh, dev, (torch.float32,), (Bt, Di, N))
        dh = dh.contiguous()
    u, dt, A, D, hs, dy = (t.contiguous() for t in (u, dt, A, D, hs, dy))
    lib = _lib()
    n_blk = lib.mamba_scan_bwd_partials(Di, N)
    du = torch.empty_like(u)
    ddt = torch.empty((Bt, S, Di), dtype=torch.float32, device=dev)
    dA = torch.empty((Di, N), dtype=torch.float32, device=dev)
    dD = torch.empty((Di,), dtype=torch.float32, device=dev)
    dBC = torch.empty((2, Bt, S, N), dtype=torch.float32, device=dev)
    part = torch.empty((2, n_blk, Bt, S, N), dtype=torch.float32,
                       device=dev)
    err = lib.mamba_scan_bwd(
        u.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
        C.data_ptr(), D.data_ptr(), hs.data_ptr(), dy.data_ptr(),
        None if dh is None else dh.data_ptr(), du.data_ptr(),
        ddt.data_ptr(), dA.data_ptr(), dBC.data_ptr(), dD.data_ptr(),
        part.data_ptr(), Bt, S, Di, N, state_every, B.stride(0),
        B.stride(1), C.stride(0), C.stride(1),
        int(u.dtype == torch.bfloat16),
        torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"mamba_scan_bwd: CUDA error {err}")
    mamba_scan_bwd_cuda.launches += 1
    return du, ddt, dA, dBC[0], dBC[1], dD


mamba_scan_bwd_cuda.launches = 0


class MambaScan(torch.autograd.Function):
    """The scan with its backward, on either device: CUDA tensors through
    the two kernels, CPU tensors through their plain versions, the same
    chunking on both. The forward saves the state at every ``state_every``
    K-th step (the chunk boundaries), not the (S, Di, N) history; the
    backward rebuilds each chunk's states from its boundary state. Works
    under ``torch.utils.checkpoint`` (the forward then runs again in the
    backward pass). Gradients: du in u's dtype, the others fp32."""

    @staticmethod
    def forward(ctx, u, dt, A, B, C, D, state_every):
        fwd = mamba_scan_cuda if u.device.type == "cuda" else mamba_scan_torch
        y, h, hs = fwd(u, dt, A, B, C, D, state_every=state_every)
        ctx.save_for_backward(u, dt, A, B, C, D, hs)
        ctx.state_every = state_every
        ctx.set_materialize_grads(False)
        return y, h

    @staticmethod
    def backward(ctx, dy, dh):
        u, dt, A, B, C, D, hs = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(u)
        bwd = (mamba_scan_bwd_cuda if u.device.type == "cuda"
               else mamba_scan_bwd_torch)
        grads = bwd(u, dt, A, B, C, D, hs, dy.to(u.dtype), dh,
                    state_every=ctx.state_every)
        return tuple(g if need else None for g, need in
                     zip(grads, ctx.needs_input_grad)) + (None,)


def bwd_kernel_info(Di: int, N: int, u_dtype=torch.bfloat16) -> dict:
    """What sets the backward kernel's waves on the current card at Di
    channels of N states: its registers a thread, resident blocks an SM,
    threads and shared bytes a block, its blocks (one dB/dC partial each)
    and the waves they take, ceil(blocks / (blocks an SM x SMs))."""
    lib = _lib()
    vals = [ctypes.c_int() for _ in range(4)]
    err = lib.mamba_scan_bwd_info(N, int(u_dtype == torch.bfloat16),
                                  *(ctypes.byref(v) for v in vals))
    if err:
        raise RuntimeError(f"mamba_scan_bwd_info: CUDA error {err}")
    info = dict(zip(("regs", "blocks_per_sm", "threads", "smem_bytes"),
                    (v.value for v in vals)))
    info["blocks"] = lib.mamba_scan_bwd_partials(Di, N)
    sms = torch.cuda.get_device_properties(
        torch.cuda.current_device()).multi_processor_count
    info["waves"] = -(-info["blocks"] // max(1, info["blocks_per_sm"] * sms))
    return info


def reset_launches() -> None:
    mamba_scan_cuda.launches = 0
    mamba_scan_bwd_cuda.launches = 0


def _lib() -> ctypes.CDLL:
    from repro_torch.kernels import build

    lib = build.load("mamba_scan")
    if lib.mamba_scan.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.mamba_scan.argtypes = [p] * 9 + [i] * 5 + [ll] * 4 + [i, p]
        lib.mamba_scan.restype = i
        lib.mamba_scan_bwd_partials.argtypes = [i, i]
        lib.mamba_scan_bwd_partials.restype = i
        lib.mamba_scan_bwd_info.argtypes = [i, i] + [p] * 4
        lib.mamba_scan_bwd_info.restype = i
        lib.mamba_scan_bwd.argtypes = [p] * 15 + [i] * 5 + [ll] * 4 + [i, p]
        lib.mamba_scan_bwd.restype = i
    return lib
