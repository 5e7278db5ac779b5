"""Counter-based random numbers, bit for bit those of ``jax.random``
(threefry2x32 keys, JAX's "partitionable" bit layout), in torch integer
ops.

The serving engine draws each token from its own key,
``fold_in(fold_in(prng_key(seed), request_id), position)``, as the
reference's ``Engine._sample`` does, and samples by Gumbel-max
(``jax.random.categorical``). Keys are int64 tensors of shape
``(..., 2)`` holding two uint32 words; every function is batched over
the leading dims, so one call serves a whole decode batch, on whatever
device the key lies.

torch has no add or shift for ``torch.uint32``, so the words live in
int64 and every sum and left shift is masked back to 32 bits.

What ``jax.random`` does, and this module copies:
- ``PRNGKey(s)`` is ``[s >> 32, s & 0xFFFFFFFF]``, ``[0, s]`` for a
  32-bit seed; ``fold_in(key, d)`` is ``threefry2x32(key, (0, d))``.
- ``random_bits`` hashes the 64-bit flat index of each element, split
  into (hi, lo) words, and returns ``bits1 ^ bits2``, truncated to the
  draw's width (8 bits for bf16, whose 7 mantissa bits need fewer
  than 8).
- ``uniform`` ORs the top mantissa bits into 1.0, subtracts 1, scales,
  shifts and clamps at ``minval``, all in the target dtype.
- ``gumbel`` (mode "low") is ``-log(-log(uniform(tiny, 1)))`` in the
  target dtype; ``categorical`` is the first argmax of
  ``logits + gumbel``.
"""
from __future__ import annotations

import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
# Explicit mantissa widths (torch.finfo has none) and the bits of 1.0.
_MANT = {torch.float32: 23, torch.bfloat16: 7, torch.float16: 10}
_ONE = {torch.float32: 0x3F800000, torch.bfloat16: 0x3F80,
        torch.float16: 0x3C00}
_INT_OF = {32: torch.int32, 16: torch.int16}


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & MASK) | (x >> (32 - r))


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 with 20 rounds over broadcastable int64 tensors of
    uint32 values: key words ``k0, k1``, counter words ``x0, x1``.
    Returns the two output words."""
    k2 = k0 ^ k1 ^ _PARITY
    ks = (k0, k1, k2)
    x0 = (x0 + k0) & MASK
    x1 = (x1 + k1) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x0, x1


def prng_key(seed: int, device="cpu") -> torch.Tensor:
    """``jax.random.key_data(jax.random.PRNGKey(seed))`` as an int64
    tensor of shape (2,); a seed in [-2**31, 2**32) gives ``[0, seed &
    0xFFFFFFFF]``, as JAX does without x64."""
    seed = int(seed)
    hi = 0 if -2**31 <= seed < 2**32 else (seed >> 32) & MASK
    return torch.tensor([hi, seed & MASK], dtype=torch.int64, device=device)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in`` batched: keys (..., 2) (or one (2,) key)
    and data (...) broadcast; returns keys of the broadcast shape + (2,).
    ``data`` is taken as uint32 (its low 32 bits)."""
    data = torch.as_tensor(data, device=key.device).to(torch.int64) & MASK
    y0, y1 = threefry2x32(key[..., 0], key[..., 1],
                          torch.zeros_like(data), data)
    return torch.stack(torch.broadcast_tensors(y0, y1), dim=-1)


def random_bits(key: torch.Tensor, bit_width: int, shape) -> torch.Tensor:
    """``jax.random.bits`` of width 8, 16 or 32 under keys (..., 2):
    returns int64 of shape ``key.shape[:-1] + shape``, each row drawn
    from its own key."""
    if bit_width not in (8, 16, 32):
        raise ValueError(f"bit_width must be 8, 16 or 32, got {bit_width}")
    shape = tuple(shape)
    n = 1
    for d in shape:
        n *= d
    idx = torch.arange(n, dtype=torch.int64, device=key.device).reshape(shape)
    lead = key.shape[:-1]
    k0 = key[..., 0].reshape(*lead, *(1,) * len(shape))
    k1 = key[..., 1].reshape(*lead, *(1,) * len(shape))
    b0, b1 = threefry2x32(k0, k1, idx >> 32, idx & MASK)
    bits = b0 ^ b1
    if bit_width < 32:
        bits = bits & ((1 << bit_width) - 1)
    return bits


def uniform(key: torch.Tensor, shape, dtype=torch.float32, minval=0.0,
            maxval=1.0) -> torch.Tensor:
    """``jax.random.uniform`` in [minval, maxval) in ``dtype`` (fp32,
    bf16 or fp16), batched over the keys' leading dims."""
    if dtype not in _MANT:
        raise ValueError(f"uniform takes float32, bfloat16 or float16, got "
                         f"{dtype}")
    nbits = torch.finfo(dtype).bits
    nmant = _MANT[dtype]
    rng_bits = nbits if nmant >= 8 else 8
    bits = random_bits(key, rng_bits, shape)
    fbits = (bits >> (rng_bits - nmant)) | _ONE[dtype]
    floats = fbits.to(_INT_OF[nbits]).view(dtype)
    one = torch.ones((), dtype=dtype, device=key.device)
    lo = torch.tensor(minval, dtype=dtype, device=key.device)
    hi = torch.tensor(maxval, dtype=dtype, device=key.device)
    floats = (floats - one) * (hi - lo) + lo
    return torch.maximum(lo, floats)


def gumbel(key: torch.Tensor, shape, dtype=torch.float32) -> torch.Tensor:
    """``jax.random.gumbel`` (mode "low"), batched over the keys."""
    u = uniform(key, shape, dtype, minval=torch.finfo(dtype).tiny,
                maxval=1.0)
    return -torch.log(-torch.log(u))


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical`` over the last axis, row by row: keys
    (..., 2), logits (..., V); returns int64 ids (...): the first index
    of the largest ``logits + gumbel``, in the logits' dtype."""
    g = gumbel(key, logits.shape[-1:], logits.dtype)
    return torch.argmax(g + logits, dim=-1)


def sample(key: torch.Tensor, logits: torch.Tensor,
           temperature: float) -> torch.Tensor:
    """The reference engine's draw, ``categorical(key, logits / t)``.
    ``t`` is rounded to the logits' dtype first, as JAX rounds a Python
    scalar to the array's dtype."""
    t = torch.tensor(temperature, dtype=logits.dtype, device=logits.device)
    return categorical(key, logits / t)
