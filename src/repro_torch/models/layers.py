"""Layers of the paged serving path and the train step
(``repro.models.layers``): RMSNorm, half-split RoPE, GQA projections,
the GeGLU FFN, full-sequence attention and paged-KV attention.

Norms, RoPE and softmax run in fp32 and cast back, as the reference
does; projections run in the config's compute dtype. Parameters arrive
already in that dtype (see ``lm.init_lm``). Parameter layouts are the
reference's: ``wq`` (d, H, hd), ``wk``/``wv`` (d, K, hd), ``wo``
(H, hd, d), ``wu``/``wg`` (d, f), ``wd`` (f, d).
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops, quant

# jax.nn.gelu defaults to the tanh approximation; torch's default is erf.
_ACT = {
    "gelu": functools.partial(F.gelu, approximate="tanh"),
    "silu": F.silu,
}

# int8 and int4 name quantized paged pools: int8 bytes (int4 packs two
# values a byte) beside fp32 per-row scales.
_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "int8": torch.int8, "int4": torch.int8}
QUANTIZED = ("int8", "int4")


def dtype_of(name: str) -> torch.dtype:
    if name not in _DTYPES:
        raise ValueError(f"unknown dtype {name!r}; known: {sorted(_DTYPES)}")
    return _DTYPES[name]


def apply_norm(params, x, eps: float = 1e-6):
    """RMSNorm ``x * rsqrt(mean(x^2) + eps) * scale`` in fp32 (no
    ``1 + scale``)."""
    x32 = x.float()
    var = x32.pow(2).mean(-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps) * params["scale"].float()
    return y.to(x.dtype)


def apply_rope(x, positions, *, theta: float):
    """Half-split rotary embedding. x: (B, S, H, D); positions: (B, S)."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions.float()[..., None] * freqs           # (B, S, half)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x32 = x.float()
    x1, x2 = x32[..., :half], x32[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def _qkv(params, x, which: str):
    """x: (B, S, d) @ w (d, heads, hd) -> (B, S, heads, hd)."""
    w = params["w" + which]
    d, nh, hd = w.shape
    return (x @ w.reshape(d, nh * hd)).reshape(*x.shape[:-1], nh, hd)


def apply_ffn(params, x, cfg: ModelConfig):
    h = x @ params["wu"]
    if cfg.glu:
        h = _ACT[cfg.activation](x @ params["wg"]) * h
    else:
        h = _ACT[cfg.activation](h)
    return h @ params["wd"]


def gather_last(x, last_pos):
    """Per-row slice x (B, S, d) at ``last_pos`` (B,) -> (B, 1, d)."""
    rows = torch.arange(x.shape[0], device=x.device)
    return x[rows, last_pos.to(x.device, torch.long)][:, None, :]


# ---- paged KV cache -------------------------------------------------------- #
def init_paged_kv_cache(cfg: ModelConfig, n_pages: int, page: int, *,
                        n_layers: int = 1, device):
    """Physical page pools ``(n_layers, n_pages + 1, page, K, hd)``.

    The trailing page (index ``n_pages``) is the trash page that absorbs
    masked writes, so the scatter in :func:`paged_cache_insert` needs no
    conditional. An int8 pool holds int8 values, an int4 pool packed
    nibbles over ``hd // 2``; both add fp32 ``kp_scale``/``vp_scale``
    of shape ``(n_layers, n_pages + 1, page, K)``, trash page included.
    """
    K, hd = cfg.n_kv_heads, cfg.head_dim
    store_hd = hd
    if cfg.kv_cache_dtype == "int4":
        if hd % 2:
            raise ValueError(
                f"int4 KV packs two dims per byte; head_dim {hd} is odd")
        store_hd = hd // 2
    dt = dtype_of(cfg.kv_cache_dtype)
    shape = (n_layers, n_pages + 1, page, K, store_hd)
    cache = {"kp": torch.zeros(shape, dtype=dt, device=device),
             "vp": torch.zeros(shape, dtype=dt, device=device)}
    if cfg.kv_cache_dtype in QUANTIZED:
        for name in ("kp_scale", "vp_scale"):
            cache[name] = torch.zeros(shape[:-1], dtype=torch.float32,
                                      device=device)
    return cache


def _check_insert_dtype(pool_dtype, new_dtype, where: str) -> None:
    """Writes into an integer pool must come through the quantizer: a
    cast of float K/V into an int8/int4 pool whose scale entries are
    missing would store truncated values, with no error."""
    if not pool_dtype.is_floating_point and new_dtype.is_floating_point:
        raise TypeError(
            f"{where}: writing {new_dtype} values into a {pool_dtype} pool "
            "without quantization scales; quantized caches must carry "
            "kp_scale/vp_scale entries")


def paged_cache_insert(cache, k_new, v_new, page_table, pos, n_valid):
    """Scatter C new tokens' K/V into their rows' pages, in place.

    k_new/v_new: (B, C, K, hd); cache: one layer's ``kp``/``vp`` pools
    (P1, page, K, hd), plus ``kp_scale``/``vp_scale`` (P1, page, K) for
    a quantized pool, whose new rows are quantized first (int4 when the
    pool's trailing axis is ``hd // 2``). Token i of row b lands at
    logical position ``pos[b] + i``; tokens at i >= n_valid[b], and
    positions whose page is unmapped, go to the trash page, values and
    scales alike. Unlike the reference, which returns new arrays, the
    pools are updated in place (``index_copy_``) and the same dict is
    returned. Float K/V into an integer pool without scales raise
    ``TypeError`` before anything is written.
    """
    if "kp_scale" not in cache:
        for name, new in (("kp", k_new), ("vp", v_new)):
            _check_insert_dtype(cache[name].dtype, new.dtype,
                                "paged_cache_insert")
    P1, page = cache["kp"].shape[:2]
    B, C = k_new.shape[:2]
    npg = page_table.shape[1]
    dev = k_new.device
    ar = torch.arange(C, device=dev)
    logical = pos.to(dev, torch.long).reshape(B, 1) + ar[None, :]
    pg, off = logical // page, logical % page
    phys = torch.gather(page_table.to(dev, torch.long), 1,
                        pg.clamp(0, npg - 1))
    ok = ar[None, :] < n_valid.to(dev, torch.long).reshape(B, 1)
    ok &= (phys >= 0) & (pg < npg)
    row = torch.where(ok, phys, P1 - 1)
    idx = (row * page + off).reshape(B * C)
    news = {"kp": k_new, "vp": v_new}
    if "kp_scale" in cache:
        hd = k_new.shape[-1]
        qz = (quant.quantize_int4 if cache["kp"].shape[-1] != hd
              else quant.quantize_int8)
        news["kp"], news["kp_scale"] = qz(k_new)
        news["vp"], news["vp_scale"] = qz(v_new)
    for name, new in news.items():
        pool = cache[name]
        flat = pool.view(P1 * page, *pool.shape[2:])
        flat.index_copy_(0, idx, new.reshape(B * C, *new.shape[2:])
                         .to(pool.dtype))
    return cache


def paged_copy_pages(cache, src, dst):
    """Copy pool pages ``src[i] -> dst[i]`` in place (the device half of
    a copy-on-write), values and any dequant scales alike; pools may be
    per-layer or layer-stacked."""
    axis = 1 if cache["kp"].dim() == 5 else 0
    for pool in cache.values():
        s = torch.as_tensor(src, dtype=torch.long, device=pool.device)
        d = torch.as_tensor(dst, dtype=torch.long, device=pool.device)
        pool.index_copy_(axis, d, pool.index_select(axis, s))
    return cache


def attention_full(params, x, cfg: ModelConfig, *, positions, window=None,
                   causal=True):
    """Full-sequence self-attention (train / prefill).

    x: (B, S, d); positions: (B, S) RoPE positions. Returns (out (B, S,
    d), (k, v)), k/v (B, S, K, hd) in the compute dtype, as the
    reference returns them for cache construction.
    """
    B, S, _ = x.shape
    q = apply_rope(_qkv(params, x, "q"), positions, theta=cfg.rope_theta)
    k = apply_rope(_qkv(params, x, "k"), positions, theta=cfg.rope_theta)
    v = _qkv(params, x, "v")
    out = ops.attention(q, k, v, causal=causal, window=window)
    wo = params["wo"]
    H, hd, d = wo.shape
    return out.reshape(B, S, H * hd) @ wo.reshape(H * hd, d), (k, v)


def attention_decode_paged(params, x, cfg: ModelConfig, cache, page_table,
                           pos, n_valid, *, window=None):
    """C-token attention against one layer's paged pool.

    x: (B, C, d), the chunk program's mixed batch (decode rows feed one
    real token, chunked-prefill rows up to C). The new K/V go into the
    rows' pages first, then every query attends causally over exactly
    its row's occupied pages. Returns (B, C, d).
    """
    B, C, _ = x.shape
    q = _qkv(params, x, "q")
    k_new = _qkv(params, x, "k")
    v_new = _qkv(params, x, "v")
    posm = (pos.to(x.device, torch.long).reshape(B, 1)
            + torch.arange(C, device=x.device)[None, :])
    q = apply_rope(q, posm, theta=cfg.rope_theta)
    k_new = apply_rope(k_new, posm, theta=cfg.rope_theta)
    paged_cache_insert(cache, k_new, v_new, page_table, pos, n_valid)
    out = ops.paged_attention(q, cache["kp"], cache["vp"], page_table,
                              pos=pos, n_valid=n_valid, window=window,
                              kp_scale=cache.get("kp_scale"),
                              vp_scale=cache.get("vp_scale"))
    wo = params["wo"]
    H, hd, d = wo.shape
    return out.reshape(B, C, H * hd) @ wo.reshape(H * hd, d)
