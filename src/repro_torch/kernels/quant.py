"""KV-cache quantization (``repro.kernels.quant``), bit-exact with the
reference.

Symmetric per-row scales over the trailing (head) dimension:

  * **int8**: ``scale = max(amax, 1e-6) / 127``, values
    ``round(x / scale)`` clipped to [-127, 127];
  * **int4**: ``scale = max(amax, 1e-6) / 7``, values in [-7, 7],
    packed two per byte in the halves layout: byte ``j`` holds dim ``j``
    in the low nibble and dim ``j + head_dim // 2`` in the high nibble,
    so an int4 pool's trailing axis is ``head_dim // 2``.

Everything runs in fp32 with a true division (not a multiply by the
reciprocal) and ``torch.round``, which rounds half to even as
``jnp.round`` does, so values and scales equal the reference's bit for
bit. The nibble unpack widens to int32 and sign-extends with
``((x & 0xF) ^ 8) - 8``, as the CUDA kernel's int4 branch does.
"""
from __future__ import annotations

import torch


def quantize_int8(x):
    """x: (..., hd) -> (int8 values (..., hd), fp32 scale (...,))."""
    x32 = x.float()
    scale = x32.abs().amax(dim=-1).clamp_min(1e-6) / 127.0
    q = torch.round(x32 / scale[..., None])
    return q.clamp(-127, 127).to(torch.int8), scale


def pack_int4(q):
    """q: integer values in [-8, 7], (..., hd) with hd even -> int8
    (..., hd // 2) packed nibbles."""
    if q.shape[-1] % 2:
        raise ValueError(f"int4 packing needs an even trailing dim, "
                         f"got {q.shape[-1]}")
    h = q.shape[-1] // 2
    lo = q[..., :h].to(torch.int32)
    hi = q[..., h:].to(torch.int32)
    # (hi << 4) | lo nibble, then the low 8 bits as a signed byte (the
    # reference's int32 -> int8 cast wraps the same way).
    byte = ((hi << 4) | (lo & 0xF)) & 0xFF
    return torch.where(byte > 127, byte - 256, byte).to(torch.int8)


def unpack_int4(packed):
    """int8 (..., hd // 2) packed nibbles -> int8 (..., hd)."""
    p = packed.to(torch.int32)
    lo = ((p & 0xF) ^ 8) - 8
    hi = (((p >> 4) & 0xF) ^ 8) - 8
    return torch.cat([lo, hi], dim=-1).to(torch.int8)


def quantize_int4(x):
    """x: (..., hd), hd even -> (packed int8 (..., hd // 2), fp32 scale)."""
    x32 = x.float()
    scale = x32.abs().amax(dim=-1).clamp_min(1e-6) / 7.0
    q = torch.round(x32 / scale[..., None]).clamp(-7, 7)
    return pack_int4(q.to(torch.int32)), scale


def dequantize(pool, scale, head_dim: int):
    """Quantized pool (..., hd) int8 or (..., hd // 2) int4-packed, plus
    per-row scale (...,) -> fp32 (..., hd). The int4 case is inferred
    from the trailing-axis size."""
    vals = pool if pool.shape[-1] == head_dim else unpack_int4(pool)
    return vals.float() * scale[..., None].float()
