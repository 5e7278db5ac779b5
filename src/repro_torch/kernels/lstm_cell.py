"""Fused LSTM cell, forward and backward: the CUDA kernels' wrappers, their
autograd function and the plain PyTorch versions.

The kernels (``csrc/lstm_cell.cu``) replace the TPU kernel
``repro/kernels/lstm_cell.py:_kernel`` (``pallas_call`` at line 51): with
GNMT's input projection hoisted out of the time loop (C9), the cell
``gates = x_proj + h . W_h + b`` (gate order i, f, g, o) with its
nonlinearities and state update is the whole loop body. The reference has
no backward kernel; GNMT trains through ``jax.grad`` of
``repro/kernels/ref.py:lstm_cell``. Here the backward kernel is the cell's
elementwise part, from the activated gates the forward saved, in one pass
that also writes the gradients of x_proj and b; the products that follow
from its ``dgates`` stay ``torch.matmul``, as the reference left them to
XLA.

What bounds the forward on an H100 at GNMT's shape (B 128, F 1024, bf16)
is bytes: re-reading W_h (8 MiB) at every time step, 0.0033 ms at
3.35 TB/s against 0.0011 ms of tensor-core arithmetic. A block owns 8
hidden units and all the batch rows, so each W_h element is read from
device memory once a call, streamed through a TMA ring of k tiles; each
unit's four gates land in one thread, so the gate pre-activations never
reach device memory.

:func:`lstm_cell_fwd_cuda` / :func:`lstm_cell_bwd_cuda` launch the
kernels on CUDA tensors and raise on anything they do not take;
:class:`LSTMCell` binds them to autograd; :func:`lstm_cell_torch` and
:func:`lstm_cell_bwd_torch` are the plain versions, which the CPU path and
the on-card comparison use.
"""
from __future__ import annotations

import ctypes

import torch

_DTYPES = (torch.bfloat16, torch.float32)


def lstm_cell_torch(x_proj, h_prev, c_prev, w_h, b):
    """``repro.kernels.ref.lstm_cell``: x_proj (B, 4F), h_prev and c_prev
    (B, F), w_h (F, 4F), b (4F,); every operand widened to fp32, gate
    order i, f, g, o. Returns (h in x_proj's dtype, c in fp32); autograd
    gives its backward."""
    gates = x_proj.float() + h_prev.float() @ w_h.float() + b.float()
    i, f, g, o = gates.chunk(4, dim=-1)
    c = torch.sigmoid(f) * c_prev.float() + torch.sigmoid(i) * torch.tanh(g)
    h = torch.sigmoid(o) * torch.tanh(c)
    return h.to(x_proj.dtype), c


def lstm_cell_bwd_torch(gates, c_prev, c_new, dh, dc):
    """The cell-local backward: from the activated gates (B, 4F) in the
    order i, f, g, o, c_prev and c_new (B, F), and the gradients dh of
    h_new and dc of c_new, returns (dgates (B, 4F), the gradient of the
    gate pre-activations, and dc_prev (B, F), both fp32; dx, dgates in
    dh's dtype, which is x_proj's, the gradient of x_proj; db (4F,) fp32,
    dgates summed over the rows, the gradient of b)."""
    i, f, g, o = gates.float().chunk(4, dim=-1)
    tc = torch.tanh(c_new.float())
    dh32 = dh.float()
    dc_tot = dc.float() + dh32 * o * (1 - tc * tc)
    dgates = torch.cat([dc_tot * g * (i * (1 - i)),
                        dc_tot * c_prev.float() * (f * (1 - f)),
                        dc_tot * i * (1 - g * g),
                        dh32 * tc * (o * (1 - o))], dim=-1)
    return dgates, dc_tot * f, dgates.to(dh.dtype), dgates.sum(0)


def _check(name, tensors, dev):
    """Device, contiguity and 16-byte alignment of the inputs; returns
    them contiguous and aligned (a copy where needed)."""
    out = []
    for label, t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(
                f"{name}: {label} is on {t.device}; every input must be a "
                f"CUDA tensor on {dev}")
        t = t.contiguous()
        if t.data_ptr() % 16:
            t = t.clone()
        out.append(t)
    return out


def _dtype(name, label, t, allowed):
    if t.dtype not in allowed:
        raise TypeError(f"{name}: {label} is {t.dtype}; the kernel takes "
                        f"{allowed}")


def _shape(name, label, t, shape):
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: {label} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")


def lstm_cell_fwd_cuda(x_proj, h_prev, c_prev, w_h, b, *, save_gates=False):
    """Launch the forward kernel. Returns (h (B, F) in x_proj's dtype,
    c (B, F) fp32, the activated gates (B, 4F) fp32 or None), with the
    contract of :func:`lstm_cell_torch`.

    x_proj, h_prev and w_h: one dtype, bf16 or fp32; c_prev and b fp32;
    F a multiple of 8. Copies inputs that are not contiguous. Launches
    on the current stream, does not synchronise, and counts each launch
    in ``lstm_cell_fwd_cuda.launches``.
    """
    name = "lstm_cell_fwd_cuda"
    if h_prev.dim() != 2:
        raise ValueError(f"{name}: h_prev must be (B, F), got "
                         f"{tuple(h_prev.shape)}")
    B, F = h_prev.shape
    if F % 8:
        raise ValueError(f"{name}: F = {F}; the kernel takes a multiple of 8")
    for label, t, shape in (("x_proj", x_proj, (B, 4 * F)),
                            ("c_prev", c_prev, (B, F)),
                            ("w_h", w_h, (F, 4 * F)), ("b", b, (4 * F,))):
        _shape(name, label, t, shape)
    _dtype(name, "x_proj", x_proj, _DTYPES)
    for label, t in (("h_prev", h_prev), ("w_h", w_h)):
        _dtype(name, label, t, (x_proj.dtype,))
    for label, t in (("c_prev", c_prev), ("b", b)):
        _dtype(name, label, t, (torch.float32,))
    dev = x_proj.device
    x_proj, h_prev, c_prev, w_h, b = _check(
        name, (("x_proj", x_proj), ("h_prev", h_prev), ("c_prev", c_prev),
               ("w_h", w_h), ("b", b)), dev)
    h = torch.empty((B, F), dtype=x_proj.dtype, device=dev)
    c = torch.empty((B, F), dtype=torch.float32, device=dev)
    gates = (torch.empty((B, 4 * F), dtype=torch.float32, device=dev)
             if save_gates else None)
    if B == 0 or F == 0:
        return h, c, gates
    err = _lib().lstm_cell_fwd(
        x_proj.data_ptr(), h_prev.data_ptr(), c_prev.data_ptr(),
        w_h.data_ptr(), b.data_ptr(), h.data_ptr(), c.data_ptr(),
        gates.data_ptr() if gates is not None else None, B, F,
        int(x_proj.dtype == torch.bfloat16),
        torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"lstm_cell_fwd: CUDA error {err}")
    lstm_cell_fwd_cuda.launches += 1
    return h, c, gates


lstm_cell_fwd_cuda.launches = 0


def lstm_cell_bwd_cuda(gates, c_prev, c_new, dh, dc):
    """Launch the backward kernel: :func:`lstm_cell_bwd_torch` on CUDA
    tensors. gates (B, 4F), c_prev, c_new and dc fp32; dh bf16 or fp32;
    F a multiple of 8. Returns (dgates (B, 4F), dc_prev (B, F), dx (B, 4F)
    in dh's dtype, db (4F,)); for fp32 dh, dx is dgates itself. Counts
    each launch in ``lstm_cell_bwd_cuda.launches``."""
    name = "lstm_cell_bwd_cuda"
    if c_prev.dim() != 2:
        raise ValueError(f"{name}: c_prev must be (B, F), got "
                         f"{tuple(c_prev.shape)}")
    B, F = c_prev.shape
    if F % 8:
        raise ValueError(f"{name}: F = {F}; the kernel takes a multiple of 8")
    _shape(name, "gates", gates, (B, 4 * F))
    _dtype(name, "dh", dh, _DTYPES)
    named = [("gates", gates), ("c_prev", c_prev), ("c_new", c_new),
             ("dc", dc)]
    for label, t in named:
        _dtype(name, label, t, (torch.float32,))
    for label, t in named[1:] + [("dh", dh)]:
        _shape(name, label, t, (B, F))
    gates, c_prev, c_new, dc, dh = _check(name, named + [("dh", dh)],
                                          c_prev.device)
    dev = c_prev.device
    dgates = torch.empty((B, 4 * F), dtype=torch.float32, device=dev)
    dc_prev = torch.empty((B, F), dtype=torch.float32, device=dev)
    bf16 = dh.dtype == torch.bfloat16
    dx = (torch.empty((B, 4 * F), dtype=dh.dtype, device=dev) if bf16
          else dgates)
    db = torch.empty((4 * F,), dtype=torch.float32, device=dev)
    if B == 0 or F == 0:
        return dgates, dc_prev, dx, db.zero_()
    err = _lib().lstm_cell_bwd(
        gates.data_ptr(), c_prev.data_ptr(), c_new.data_ptr(), dh.data_ptr(),
        dc.data_ptr(), dgates.data_ptr(), dc_prev.data_ptr(),
        dx.data_ptr() if bf16 else None, db.data_ptr(), B, F, int(bf16),
        torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"lstm_cell_bwd: CUDA error {err}")
    lstm_cell_bwd_cuda.launches += 1
    return dgates, dc_prev, dx, db


lstm_cell_bwd_cuda.launches = 0


class LSTMCell(torch.autograd.Function):
    """The cell through the forward kernel, with the backward kernel as
    its gradient. The forward has the kernel write the activated gates
    and saves them; the backward kernel writes dgates, dc_prev, dx_proj
    (dgates in x_proj's dtype) and db (dgates summed over rows), and then

        dh_prev = dgates . W_h^T;             dW_h = h_prev^T . dgates

    The two products run as ``torch.matmul`` in full fp32 (h_prev and W_h
    widened, TF32 off unless the caller turns it on), the precision of
    ``jax.grad`` of the reference's fp32 product, and are then cast to
    h_prev's and W_h's dtype. Works under ``torch.utils.checkpoint`` (the
    forward then runs again in the backward pass)."""

    @staticmethod
    def forward(ctx, x_proj, h_prev, c_prev, w_h, b):
        h, c, gates = lstm_cell_fwd_cuda(x_proj, h_prev, c_prev, w_h, b,
                                         save_gates=True)
        ctx.save_for_backward(h_prev, c_prev, w_h, gates, c)
        ctx.xp_dtype = x_proj.dtype
        return h, c

    @staticmethod
    def backward(ctx, dh, dc):
        h_prev, c_prev, w_h, gates, c = ctx.saved_tensors
        dgates, dc_prev, dx, db = lstm_cell_bwd_cuda(gates, c_prev, c,
                                                     dh.to(ctx.xp_dtype), dc)
        need = ctx.needs_input_grad
        dh_prev = ((dgates @ w_h.float().t()).to(h_prev.dtype)
                   if need[1] else None)
        dw = ((h_prev.float().t() @ dgates).to(w_h.dtype)
              if need[3] else None)
        return (dx if need[0] else None, dh_prev,
                dc_prev if need[2] else None, dw, db if need[4] else None)


def lstm_cell_cuda(x_proj, h_prev, c_prev, w_h, b):
    """The cell through the CUDA kernels: (h, c), differentiable through
    :class:`LSTMCell` where autograd records; otherwise (under
    ``torch.no_grad``, or when no input needs a gradient) the forward
    kernel alone, without the gates."""
    args = (x_proj, h_prev, c_prev, w_h, b)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return LSTMCell.apply(*args)
    h, c, _ = lstm_cell_fwd_cuda(*args)
    return h, c


def _lib() -> ctypes.CDLL:
    from repro_torch.kernels import build

    lib = build.load("lstm_cell")
    if lib.lstm_cell_fwd.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.lstm_cell_fwd.argtypes = [p] * 8 + [i] * 3 + [p]
        lib.lstm_cell_fwd.restype = i
        lib.lstm_cell_bwd.argtypes = [p] * 9 + [i] * 3 + [p]
        lib.lstm_cell_bwd.restype = i
    return lib
