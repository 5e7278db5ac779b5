"""Mamba S6 selective scan: the CUDA kernel's wrapper and the plain
PyTorch version.

The kernel (``csrc/mamba_scan.cu``) replaces the TPU kernel
``repro/kernels/mamba.py:mamba_scan`` (``pallas_call`` at line 58, body
``_kernel`` at :22). From h = 0 it runs, for every batch row and channel,

    h_t = exp(dt_t * A) * h_{t-1} + (dt_t * u_t) * B_t
    y_t = h_t . C_t + D * u_t

with the (channel, N) state in registers for the whole time loop (4
threads a channel, N / 4 states each, for N up to 16) and time streamed
through shared memory, the next 16 steps loaded while the current ones
run, so no (S, Di, N) tensor ever reaches device memory. The decay is
``exp2(dt * (A * log2 e))`` on the special-function units, and h . C is
summed over a channel's lanes once every 4 steps, in a fixed order
(``tests/test_torch_mamba.py`` writes that arithmetic out in PyTorch).
What bounds it on an H100 at Jamba's prefill shape (Bt 1, S 256, Di
16384, N 16) is the S * Di * N exponentials on the special-function units
(about 0.016 ms) more than its 35.7 MB of traffic (0.0107 ms).

:func:`mamba_scan_cuda` launches the kernel on CUDA tensors and raises on
anything it does not take; :func:`mamba_scan_torch` is the plain version
(the operation order of ``repro.kernels.ops._mamba_scan_jnp``), which the
CPU path and the on-card comparison use. The reference has no backward
kernel; this forward serves prefill.
"""
from __future__ import annotations

import ctypes

import torch

_U_DTYPES = (torch.bfloat16, torch.float32)
MAX_STATE = 64  # csrc/mamba_scan.cu kMaxN


def mamba_scan_torch(u, dt, A, B, C, D):
    """Sequential selective scan in fp32, step by step as
    ``_mamba_scan_jnp`` (``repro/kernels/ops.py:308-338``) orders it:
    ``h = exp(dt*A)*h + dt*B*u``, ``y = einsum(h, C) + D*u``.

    u, dt: (Bt, S, Di); A: (Di, N); B, C: (Bt, S, N); D: (Di,). Returns
    (y (Bt, S, Di) in u's dtype, final h (Bt, Di, N) fp32)."""
    u32, dt32, B32, C32 = (t.float() for t in (u, dt, B, C))
    A32, D32 = A.float(), D.float()
    Bt, S, Di = u.shape
    h = torch.zeros((Bt, Di, A.shape[-1]), dtype=torch.float32,
                    device=u.device)
    ys = []
    for t in range(S):
        u_t, dt_t = u32[:, t], dt32[:, t]
        da = torch.exp(dt_t[..., None] * A32[None])
        h = da * h + dt_t[..., None] * B32[:, t, None, :] * u_t[..., None]
        ys.append(torch.einsum("bdn,bn->bd", h, C32[:, t]) + D32 * u_t)
    y = (torch.stack(ys, dim=1) if ys
         else torch.zeros_like(u32))
    return y.to(u.dtype), h


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


def mamba_scan_cuda(u, dt, A, B, C, D):
    """:func:`mamba_scan_torch` through the CUDA kernel: u bf16 or fp32,
    dt, A, B, C and D fp32, all on one CUDA device; B and C may be views
    whose last axis is contiguous (the model's column slices of one
    projection), the others are made contiguous. N at most 64. Returns
    (y in u's dtype, h fp32). Launches on the current stream, does not
    synchronise, and counts each launch in ``mamba_scan_cuda.launches``."""
    name = "mamba_scan_cuda"
    dev = u.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: u is on {dev}; the kernel takes CUDA "
                         f"tensors (the plain version is mamba_scan_torch)")
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
    u, dt, A, D = (t.contiguous() for t in (u, dt, A, D))
    y = torch.empty_like(u)
    h = torch.empty((Bt, Di, N), dtype=torch.float32, device=dev)
    err = _lib().mamba_scan(
        u.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
        C.data_ptr(), D.data_ptr(), y.data_ptr(), h.data_ptr(), Bt, S, Di,
        N, B.stride(0), B.stride(1), C.stride(0), C.stride(1),
        int(u.dtype == torch.bfloat16),
        torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"mamba_scan: CUDA error {err}")
    mamba_scan_cuda.launches += 1
    return y, h


mamba_scan_cuda.launches = 0


def reset_launches() -> None:
    mamba_scan_cuda.launches = 0


def _lib() -> ctypes.CDLL:
    from repro_torch.kernels import build

    lib = build.load("mamba_scan")
    if lib.mamba_scan.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.mamba_scan.argtypes = [p] * 8 + [i] * 4 + [ll] * 4 + [i, p]
        lib.mamba_scan.restype = i
    return lib
