"""Layers of the port's serving and training paths
(``repro.models.layers``): RMSNorm and LayerNorm, half-split RoPE and
M-RoPE, GQA projections (with optional q/k/v biases), the dense GLU
FFN, the MoE FFN, the Mamba (S6) mixer, the RWKV-6 time mix,
full-sequence attention (self and cross), slab-KV decode attention
(self and cross), paged-KV attention and the chunk program's
cross-attention.

Norms, RoPE, softmax and the SSM recurrences run in fp32 and cast back,
as the reference does; projections run in the config's compute dtype.
Parameters arrive already in that dtype (see ``lm.init_lm``), except
the leaves the reference uses in fp32 (:data:`FP32_LEAVES`: the norms'
``scale`` and ``bias``, Mamba's ``x_proj``, ``dt_w``, ``dt_bias``,
``A_log`` and ``D``, and the MoE ``router``; and every leaf of an
RWKV-6 time mix, which runs wholly in fp32), which stay fp32.
Parameter layouts are the reference's: norm ``scale`` (and LayerNorm
``bias``) (d,), ``wq`` (d, H, hd), ``bq`` (H, hd), ``wk``/``wv`` (d, K,
hd), ``bk``/``bv`` (K, hd), ``wo`` (H, hd, d),
``wu``/``wg`` (d, f), ``wd`` (f, d); MoE ``router`` (d, E), ``wu``/``wg``
(E, d, f), ``wd`` (E, f, d); Mamba ``wx``/``wz`` (d, Di), ``conv_w``
(d_conv, Di), ``conv_b`` (Di,), ``x_proj`` (Di, R + 2N), ``dt_w`` (R,
Di), ``dt_bias``/``D`` (Di,), ``A_log`` (Di, N), ``out_proj`` (Di, d);
RWKV-6 ``wr``/``wk``/``wv``/``wg``/``wo`` (d, d), ``w0``/``u``/
``ln_scale`` (d,), ``w1`` (d, Dw), ``w2`` (Dw, d), ``mu`` (5, d).
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MambaConfig, ModelConfig, RWKV6Config
from repro_torch.dist.tagging import Axes
from repro_torch.kernels import ops, quant
from repro_torch.models.scan_utils import chunked_scan

# jax.nn.gelu defaults to the tanh approximation; torch's default is erf.
_ACT = {
    "gelu": functools.partial(F.gelu, approximate="tanh"),
    "silu": F.silu,
    "relu": F.relu,
    "relu2": lambda x: torch.square(F.relu(x)),
}

# int8 and int4 name quantized paged pools: int8 bytes (int4 packs two
# values a byte) beside fp32 per-row scales.
_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "int8": torch.int8, "int4": torch.int8}
QUANTIZED = ("int8", "int4")
# Leaves the reference reads in fp32 whatever the compute dtype (the
# norms' ``scale`` and ``bias``, ``layers.py:31-48``; Mamba's and the
# router, ``layers.py:655-664``, ``ref.py:151``); they are stored in fp32.
FP32_LEAVES = ("scale", "bias", "x_proj", "dt_w", "dt_bias", "A_log", "D",
               "router")
# Mixers whose every leaf the reference reads in fp32 (the RWKV-6 time
# mix, ``layers.py:752-811``). Their ``wk``, ``wv`` and ``wo`` share
# attention's names, so the rule goes by the mixer, not the name.
FP32_MIXERS = ("rwkv6",)


def stored_dtype(name: str, dtype: torch.dtype,
                 mixer: str = "") -> torch.dtype:
    """The dtype the leaf ``name`` (of a ``mixer`` layer's mixer, when
    given) is kept in when the others are in ``dtype``: fp32 for
    :data:`FP32_LEAVES` and for every leaf of a :data:`FP32_MIXERS`
    mixer."""
    if name in FP32_LEAVES or mixer in FP32_MIXERS:
        return torch.float32
    return dtype


def dtype_of(name: str) -> torch.dtype:
    if name not in _DTYPES:
        raise ValueError(f"unknown dtype {name!r}; known: {sorted(_DTYPES)}")
    return _DTYPES[name]


def init_norm(cfg: ModelConfig, *, device):
    """``layers.init_norm``: fp32 ``scale`` ones of width d_model, and
    fp32 ``bias`` zeros for a LayerNorm."""
    d = cfg.d_model
    prm = {"scale": torch.ones(d, dtype=torch.float32, device=device)}
    if cfg.norm == "layernorm":
        prm["bias"] = torch.zeros(d, dtype=torch.float32, device=device)
    return prm


def apply_norm(params, x, eps: float = 1e-6):
    """In fp32, cast back to x's dtype: LayerNorm ``(x - mu) * rsqrt(var
    + eps) * scale + bias`` (biased variance) when ``params`` holds a
    ``bias``, as the reference decides; else RMSNorm ``x * rsqrt(mean(
    x^2) + eps) * scale`` (no ``1 + scale``)."""
    x32 = x.float()
    if "bias" in params:
        mu = x32.mean(-1, keepdim=True)
        var = (x32 - mu).pow(2).mean(-1, keepdim=True)
        y = (x32 - mu) * torch.rsqrt(var + eps)
        y = y * params["scale"].float() + params["bias"].float()
    else:
        var = x32.pow(2).mean(-1, keepdim=True)
        y = x32 * torch.rsqrt(var + eps) * params["scale"].float()
    return y.to(x.dtype)


def mrope_sections(half: int, device=None):
    """(half,) stream index of each rotary frequency for M-RoPE: the
    first ``half // 4`` frequencies read the temporal position (0), the
    next ``(half - half // 4) // 2`` the height (1), the rest the width
    (2) (``layers.py:55-75``)."""
    s1 = half // 4
    s2 = (half - s1) // 2
    j = torch.arange(half, device=device)
    return (j >= s1).long() + (j >= s1 + s2).long()


@functools.lru_cache(maxsize=None)
def _rope_tables(half: int, theta: float, device: torch.device):
    """(frequencies (half,) fp32, M-RoPE stream indices (half,)) on
    ``device``, made once a shape (normal tensors even when first asked
    for under ``inference_mode``). The frequencies ``theta ** (-j /
    half)`` are XLA's correctly rounded fp32 power: formed in fp64 and
    rounded (``torch.pow`` in fp32 is an ulp off in some entries, which
    moves an angle of thousands of radians by ~1e-4)."""
    with torch.inference_mode(False):
        expo = -torch.arange(half, dtype=torch.float32, device=device) / half
        freqs = torch.pow(float(theta), expo.double()).float()
        return freqs, mrope_sections(half, device)


def rope_angles(positions, half: int, theta: float, *, device):
    """Angles (B, S, half) fp32 of positions (B, S), or (B, S, 3) for
    M-RoPE, where frequency j takes the position of its stream
    (:func:`mrope_sections`), gathered in fp32."""
    freqs, sec = _rope_tables(half, float(theta), torch.device(device))
    pos = positions.to(device).float()
    if pos.dim() == 2:
        return pos[..., None] * freqs
    return pos[..., sec] * freqs


def apply_rope(x, positions, *, theta: float):
    """Half-split rotary embedding. x: (B, S, H, D); positions: (B, S),
    or (B, S, 3) (temporal, height, width) for M-RoPE."""
    half = x.shape[-1] // 2
    ang = rope_angles(positions, half, theta, device=x.device)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x32 = x.float()
    x1, x2 = x32[..., :half], x32[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def _proj_in(x, w, place=None):
    """x @ w for a weight whose first dim is the model width (its
    ``fsdp`` dim): on a mesh, ``place.proj_in`` (a weight-stationary rank
    multiplies its slice of x by its block and sums over ``data``)."""
    return x @ w if place is None else place.proj_in(x, w)


def _proj_out(h, w, place=None):
    """h @ w for a weight whose last dim is the model width: on a mesh,
    ``place.proj_out`` (a weight-stationary rank's block of the outputs
    all-gathered over ``data``)."""
    return h @ w if place is None else place.proj_out(h, w)


def _qkv(params, x, which: str, place=None):
    """x: (B, S, d) @ w (d, heads, hd) -> (B, S, heads, hd), plus the
    bias ``b<which>`` (heads, hd) in x's dtype after the product when
    the layer has one (``y + b.astype(dt)``)."""
    w = params["w" + which]
    d, nh, hd = w.shape
    y = _proj_in(x, w.reshape(d, nh * hd), place).reshape(*x.shape[:-1], nh,
                                                          hd)
    b = params.get("b" + which)
    return y if b is None else y + b.to(y.dtype)


def _attn_out(params, out, place=None):
    """The output projection of attention heads out (B, S, H, hd)."""
    wo = params["wo"]
    H, hd, d = wo.shape
    return _proj_out(out.reshape(*out.shape[:2], H * hd),
                     wo.reshape(H * hd, d), place)


def apply_ffn(params, x, cfg: ModelConfig, *, place=None):
    """The dense or GLU FFN. On a mesh (``place``, a
    ``dist.spmd.Placement``) ``wu``/``wg``/``wd`` hold the rank's block of
    the hidden dim when ``model`` splits it: the layer enters and leaves
    the residual stream through ``place``."""
    split = place is not None and params["wu"].shape[1] < cfg.d_ff
    if place is not None:
        x = place.enter(x, split)
    h = _proj_in(x, params["wu"], place)
    if cfg.glu:
        h = _ACT[cfg.activation](_proj_in(x, params["wg"], place)) * h
    else:
        h = _ACT[cfg.activation](h)
    y = _proj_out(h, params["wd"], place)
    return y if place is None else place.exit(y, split)


def gather_last(x, last_pos):
    """Per-row slice x (B, S, d) at ``last_pos`` (B,) -> (B, 1, d);
    ``last_pos`` None takes position S - 1 of every row."""
    if last_pos is None:
        return x[:, -1:, :]
    rows = torch.arange(x.shape[0], device=x.device)
    return x[rows, last_pos.to(x.device, torch.long)][:, None, :]


# ---- paged KV cache -------------------------------------------------------- #
def init_paged_kv_cache(cfg: ModelConfig, n_pages: int, page: int, *,
                        n_layers: int = 1, device, n_kv=None):
    """Physical page pools ``(n_layers, n_pages + 1, page, K, hd)``.

    The trailing page (index ``n_pages``) is the trash page that absorbs
    masked writes, so the scatter in :func:`paged_cache_insert` needs no
    conditional. An int8 pool holds int8 values, an int4 pool packed
    nibbles over ``hd // 2``; both add fp32 ``kp_scale``/``vp_scale``
    of shape ``(n_layers, n_pages + 1, page, K)``, trash page included.
    K is ``n_kv`` when given (a rank's KV heads on a mesh), else the
    config's.
    """
    K, hd = n_kv or cfg.n_kv_heads, cfg.head_dim
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
            "k_scale/v_scale (slab) or kp_scale/vp_scale (paged) entries")


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


def rank_kv_heads(cfg: ModelConfig, Hl: int, index: int):
    """The KV heads that a rank's ``Hl`` query heads read, where
    ``model`` splits the query heads but not the KV heads: query heads
    ``index * Hl ..`` read KV heads ``h // G``; the rank keeps them once
    each (``Hl`` a multiple of G: a run of KV heads, group G; a divisor:
    one head, group ``Hl``; else one a query head, group 1)."""
    G = cfg.n_heads // cfg.n_kv_heads
    kv = [h // G for h in range(index * Hl, (index + 1) * Hl)]
    return kv[::G] if Hl % G == 0 else kv[:1] if G % Hl == 0 else kv


def _rank_kv(params, cfg: ModelConfig, index: int):
    """The KV leaves of :func:`rank_kv_heads`."""
    sel = rank_kv_heads(cfg, params["wq"].shape[1], index)
    idx = torch.tensor(sel, device=params["wk"].device)
    out = dict(params)
    for name, dim in (("wk", 1), ("wv", 1), ("bk", 0), ("bv", 0)):
        if name in params:
            out[name] = params[name].index_select(dim, idx)
    return out


def attention_full(params, x, cfg: ModelConfig, *, positions, window=None,
                   causal=True, kv_x=None, place=None):
    """Full-sequence attention (train / prefill / encoder / cross).

    x: (B, S, d); positions: (B, S) RoPE positions, (B, S, 3) for
    M-RoPE (unused when ``cfg.rope == "none"``); ``kv_x`` (B, T, d), the
    source sequence of a cross-attention (default x), whose keys take no
    RoPE. Returns (out
    (B, S, d), (k, v)), k/v (B, T, K, hd) in the compute dtype, as the
    reference returns them for cache construction.

    On a mesh (``place``, a ``dist.spmd.Placement``) the weights hold the
    rank's query and KV heads when ``model`` splits them (the KV heads
    its queries read when it splits only the queries), and the layer
    enters and leaves the residual stream through ``place``; positions
    are the whole sequence's. A cross-attention's source enters whole
    over its sequence (``place.enter_source``).
    """
    split = place is not None and params["wq"].shape[1] < cfg.n_heads
    sel = None
    if place is not None:
        x = place.enter(x, split)
        if split and params["wk"].shape[1] == cfg.n_kv_heads:
            if place.kv_whole:  # a serving slab keeps every KV head
                sel = rank_kv_heads(cfg, params["wq"].shape[1], place.index)
            else:
                params = _rank_kv(params, cfg, place.index)
    src = x if kv_x is None else kv_x if place is None else \
        place.enter_source(kv_x, split)
    q = _qkv(params, x, "q", place)
    k, v = _qkv(params, src, "k", place), _qkv(params, src, "v", place)
    if cfg.rope != "none" and kv_x is None:
        q = apply_rope(q, positions, theta=cfg.rope_theta)
        k = apply_rope(k, positions, theta=cfg.rope_theta)
    ka, va = k, v
    if sel is not None:
        idx = torch.tensor(sel, device=k.device)
        ka, va = k.index_select(2, idx), v.index_select(2, idx)
    out = ops.attention(q, ka, va, causal=causal, window=window)
    y = _attn_out(params, out, place)
    return (y if place is None else place.exit(y, split)), (k, v)


def attention_decode_paged(params, x, cfg: ModelConfig, cache, page_table,
                           pos, n_valid, *, window=None, place=None,
                           ins=None):
    """C-token attention against one layer's paged pool.

    x: (B, C, d), the chunk program's mixed batch (decode rows feed one
    real token, chunked-prefill rows up to C). The new K/V go into the
    rows' pages first, then every query attends causally over exactly
    its row's occupied pages. Returns (B, C, d).

    On a mesh (``place``, a ``dist.serving`` placement) the weights and
    the pool hold the rank's heads (the KV heads its queries read where
    ``model`` does not divide the KV heads), and the layer enters and
    leaves the residual stream through ``place``. When the rank computes
    only its rows of the batch, ``ins`` holds every row's (page_table,
    pos, n_valid): the new K/V of every row are gathered over the batch
    axes and written, so each rank's pool holds every row's pages.
    """
    B, C, _ = x.shape
    split = place is not None and params["wq"].shape[1] < cfg.n_heads
    if place is not None:
        x = place.enter(x, split)
        if split and params["wk"].shape[1] == cfg.n_kv_heads:
            params = _rank_kv(params, cfg, place.index)
    q = _qkv(params, x, "q", place)
    k_new = _qkv(params, x, "k", place)
    v_new = _qkv(params, x, "v", place)
    if cfg.rope != "none":
        posm = (pos.to(x.device, torch.long).reshape(B, 1)
                + torch.arange(C, device=x.device)[None, :])
        q = apply_rope(q, posm, theta=cfg.rope_theta)
        k_new = apply_rope(k_new, posm, theta=cfg.rope_theta)
    if ins is None:
        paged_cache_insert(cache, k_new, v_new, page_table, pos, n_valid)
    else:
        paged_cache_insert(cache, place.all_rows(k_new),
                           place.all_rows(v_new), *ins)
    out = ops.paged_attention(q, cache["kp"], cache["vp"], page_table,
                              pos=pos, n_valid=n_valid, window=window,
                              kp_scale=cache.get("kp_scale"),
                              vp_scale=cache.get("vp_scale"))
    y = _attn_out(params, out, place)
    return y if place is None else place.exit(y, split)


# ---- slab KV cache (``repro.models.layers``, ``layers.py:155-320``) ------- #
def init_kv_cache(cfg: ModelConfig, B: int, length: int, *, device,
                  n_kv=None):
    """One attention layer's slab cache: ``k``/``v`` (B, length, K, hd)
    in the compute dtype (int8 with fp32 ``k_scale``/``v_scale`` (B,
    length, K) when ``kv_cache_dtype`` is int8) and ``slot_pos`` (B,
    length) int32, the absolute position held in each slot (-1 empty);
    K is ``n_kv`` when given, else the config's. An int4 slab raises
    ``ValueError``: int4 packs pool pages."""
    K, hd = n_kv or cfg.n_kv_heads, cfg.head_dim
    if cfg.kv_cache_dtype == "int4":
        raise ValueError(
            "int4 KV is only supported by the paged layout "
            "(kv_cache_dtype='int4' with a slab cache)")
    int8 = cfg.kv_cache_dtype == "int8"
    dt = torch.int8 if int8 else dtype_of(cfg.dtype)
    cache = {
        "k": torch.zeros((B, length, K, hd), dtype=dt, device=device),
        "v": torch.zeros((B, length, K, hd), dtype=dt, device=device),
        "slot_pos": torch.full((B, length), -1, dtype=torch.int32,
                               device=device),
    }
    if int8:
        for name in ("k_scale", "v_scale"):
            cache[name] = torch.zeros((B, length, K), dtype=torch.float32,
                                      device=device)
    return cache


def cache_insert(cache, k_new, v_new, pos):
    """Insert one token's K/V per row at ring slot ``pos % L``, in place.
    k_new/v_new: (B, K, hd); ``pos`` an int, a 0-d tensor, or (B,) per-row
    positions (continuous batching). Returns the same dict."""
    B = cache["k"].shape[0]
    posv = torch.as_tensor(pos, device=k_new.device).long().reshape(-1)
    return _cache_insert_per_row(cache, k_new, v_new, posv.expand(B))


def _cache_insert_per_row(cache, k_new, v_new, posv):
    """:func:`cache_insert` with per-row positions posv: (B,). An int8
    slab quantizes the new rows first; float K/V into an integer slab
    without scales raise ``TypeError`` before anything is written."""
    B, L = cache["k"].shape[:2]
    if "k_scale" in cache:
        news = {}
        news["k"], news["k_scale"] = quant.quantize_int8(k_new)
        news["v"], news["v_scale"] = quant.quantize_int8(v_new)
    else:
        _check_insert_dtype(cache["k"].dtype, k_new.dtype, "cache_insert")
        news = {"k": k_new, "v": v_new}
    rows = torch.arange(B, device=k_new.device)
    slot = posv % L
    for name, new in news.items():
        cache[name][rows, slot] = new.to(cache[name].dtype)
    cache["slot_pos"][rows, slot] = posv.to(torch.int32)
    return cache


def cache_from_prefill(cfg: ModelConfig, k, v, length: int):
    """A slab cache of ``length`` slots from prefill K/V (B, S, K, hd),
    S <= length: slots 0..S-1 hold positions 0..S-1 (quantized for an
    int8 slab)."""
    B, S = k.shape[:2]
    cache = init_kv_cache(cfg, B, length, device=k.device, n_kv=k.shape[2])
    if "k_scale" in cache:
        cache["k"][:, :S], cache["k_scale"][:, :S] = quant.quantize_int8(k)
        cache["v"][:, :S], cache["v_scale"][:, :S] = quant.quantize_int8(v)
    else:
        cache["k"][:, :S] = k.to(cache["k"].dtype)
        cache["v"][:, :S] = v.to(cache["v"].dtype)
    cache["slot_pos"][:, :S] = torch.arange(S, dtype=torch.int32,
                                            device=k.device)
    return cache


def attention_decode(params, x, cfg: ModelConfig, cache, *, pos,
                     window=None, cross=False, place=None):
    """One-token attention against one layer's slab cache. x: (B, 1, d);
    ``pos`` an int or (B,) absolute positions (each row decodes at its
    own offset). The new K/V go into the cache first (in place), then
    ``ops.decode_attention`` reads it. A cross-attention (``cross``)
    reads its static encoder cache as it is: no insert, no RoPE.
    Returns (out (B, 1, d), cache).

    On a mesh (``place``, a ``dist.serving`` placement) the slab is the
    rank's block (``train.steps.cache_axes``): its KV heads where
    ``model`` divides them; otherwise every KV head over the rank's
    block of slots (``kv_seq``), which ``place.kv_full`` gathers whole
    for the step and ``place.kv_store`` writes back, the queries reading
    the KV heads of :func:`rank_kv_heads`."""
    B = x.shape[0]
    split = place is not None and params["wq"].shape[1] < cfg.n_heads
    whole = place is not None and place.kv_whole
    if place is not None:
        x = place.enter(x, split)
        if split and not whole and params["wk"].shape[1] == cfg.n_kv_heads:
            params = _rank_kv(params, cfg, place.index)
    block = cache
    if whole:
        cache = place.kv_full(cache, cross)
    q = _qkv(params, x, "q", place)
    if not cross:
        k_new = _qkv(params, x, "k", place)
        v_new = _qkv(params, x, "v", place)
        if cfg.rope != "none":
            posv = torch.as_tensor(pos, device=x.device).long()
            posv = posv.reshape(-1, 1).expand(B, 1)
            if cfg.rope == "mrope":  # the absolute position on all 3 streams
                posv = posv[..., None].expand(B, 1, 3)
            q = apply_rope(q, posv, theta=cfg.rope_theta)
            k_new = apply_rope(k_new, posv, theta=cfg.rope_theta)
        cache_insert(cache, k_new[:, 0], v_new[:, 0], pos)
    kv = cache
    if whole:
        place.kv_store(block, cache)
        if split:
            sel = rank_kv_heads(cfg, params["wq"].shape[1], place.index)
            idx = torch.tensor(sel, device=x.device)
            kv = {n: t.index_select(2, idx) if t.dim() > 2 else t
                  for n, t in cache.items()}
    out = ops.decode_attention(q, kv["k"], kv["v"], kv["slot_pos"],
                               pos=pos, window=window,
                               k_scale=kv.get("k_scale"),
                               v_scale=kv.get("v_scale"))
    y = _attn_out(params, out, place)
    if place is None:
        return y, cache
    return place.exit(y, split), block


def attention_cross_chunk(params, x, cfg: ModelConfig, cache, *,
                          place=None):
    """C-query cross-attention against one layer's static (encoder) slab
    cache (``layers.py:451-476``), plain PyTorch on both devices: the
    reference has no Pallas kernel for it.

    x: (B, C, d); cache: {"k", "v", "slot_pos"} (+ ``k_scale``/
    ``v_scale`` for int8) of the encoder K/V, (B, T, K, hd). Every query
    sees every slot whose ``slot_pos`` is >= 0 (no causality); logits
    and softmax in fp32 with a finite -1e30 mask, so the rows of a slot
    that never admitted (``slot_pos`` -1 throughout) are a uniform mean
    of V, not NaN. Returns (B, C, d).

    On a mesh (``place``, a ``dist.serving`` placement) the query and
    output weights hold the rank's heads and the cache the KV heads they
    read (the paged pool's), over the rank's rows; the layer enters and
    leaves the residual stream through ``place``."""
    B, C, _ = x.shape
    split = place is not None and params["wq"].shape[1] < cfg.n_heads
    if place is not None:
        x = place.enter(x, split)
    q = _qkv(params, x, "q", place)
    H, D = q.shape[2], q.shape[3]
    K = cache["k"].shape[2]
    kf, vf = cache["k"].float(), cache["v"].float()
    if "k_scale" in cache:
        kf = kf * cache["k_scale"][..., None].float()
        vf = vf * cache["v_scale"][..., None].float()
    qf = (q.float() * D ** -0.5).reshape(B, C, K, H // K, D)
    logits = torch.einsum("bckgd,bskd->bckgs", qf, kf)
    valid = cache["slot_pos"] >= 0
    logits = logits.masked_fill(~valid[:, None, None, None, :], -1e30)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bckgs,bskd->bckgd", probs, vf).reshape(B, C, H, D)
    y = _attn_out(params, out.to(x.dtype), place)
    return y if place is None else place.exit(y, split)


# ---- Mixture-of-Experts FFN (``layers.py:544-603``) ----------------------- #
MOE_GROUP = 256  # tokens per dispatch group


def apply_moe(params, x, cfg: ModelConfig, *, place=None):
    """GShard-style top-k capacity dispatch. x: (B, S, d) -> (y (B, S, d)
    in x's dtype, aux loss). Tokens are grouped ``Sg = min(256, S)`` at a
    time, ``B * S // Sg`` groups, each expert taking at most
    ``ceil(Sg * top_k * capacity_factor / E)`` tokens a group (the rest
    are dropped, as in the reference). Dispatch and combine are dense
    einsums, the combine in fp32. A token count that ``Sg`` does not
    divide (a prompt longer than 256 and not a multiple of it) raises
    ``ValueError``, where the reference fails to reshape.

    On a mesh (``place``, a ``dist.spmd.Placement``) the aux loss is
    formed from the global batch's token means (``place.batch_mean``,
    ``ops.moe_gating``), and ``wu``/``wg``/``wd`` hold the rank's block:
    its experts (then the rank reads their slots of the dispatch and the
    combine), or every expert's block of hidden units. The gating runs
    whole on every model rank; the combine's partial sum over the rank's
    experts or units leaves in fp32 through ``place``, the reference's
    fp32 combine, and the aux loss counts once (``place.once``)."""
    E, k = cfg.moe.n_experts, cfg.moe.top_k
    split = place is not None and (params["wu"].shape[0] < E
                                   or params["wu"].shape[2] < cfg.d_ff)
    if place is not None:
        x = place.enter(x, split)
    B, S, d = x.shape
    Sg = min(MOE_GROUP, S)
    if (B * S) % Sg:
        raise ValueError(
            f"apply_moe: {B * S} tokens do not split into groups of {Sg} "
            f"(the reference groups min({MOE_GROUP}, S) tokens and has no "
            f"padding)")
    xg = x.reshape(B * S // Sg, Sg, d)
    cap = max(1, int(math.ceil(Sg * k * cfg.moe.capacity_factor / E)))
    dispatch, combine, aux = ops.moe_gating(
        xg, params["router"], top_k=k, capacity=cap,
        mean=None if place is None else place.batch_mean)
    El = params["wu"].shape[0]
    if El < E:  # the rank's experts' slots
        e0 = place.index * El
        dispatch = dispatch[:, :, e0:e0 + El]
        combine = combine[:, :, e0:e0 + El]
    xin = torch.einsum("gsec,gsd->egcd", dispatch.to(x.dtype), xg)
    h = torch.einsum("egcd,edf->egcf", xin, params["wu"])
    if cfg.glu:
        g = torch.einsum("egcd,edf->egcf", xin, params["wg"])
        h = _ACT[cfg.activation](g) * h
    else:
        h = _ACT[cfg.activation](h)
    out = torch.einsum("egcf,efd->egcd", h, params["wd"])
    y = torch.einsum("gsec,egcd->gsd", combine, out.float()).reshape(B, S, d)
    if place is None:
        return y.to(x.dtype), aux
    return place.exit(y, split).to(x.dtype), place.once(aux, split)


# ---- Mamba (S6 selective scan) mixer (``layers.py:609-712``) -------------- #
def _mamba_dims(cfg: ModelConfig):
    """(MambaConfig, Di = expand * d_model, dt_rank = ceil(d / 16) if 0)."""
    m = cfg.mamba or MambaConfig()
    return m, m.expand * cfg.d_model, m.dt_rank or -(-cfg.d_model // 16)


def _softplus(x):
    """``jax.nn.softplus``, i.e. ``logaddexp(x, 0)``:
    ``max(x, 0) + log1p(exp(-|x|))`` (``F.softplus`` switches to x above
    its threshold of 20 instead). The maximum is ``torch.maximum``, which
    passes half the gradient at x = 0, so the gradient there is
    ``logaddexp``'s 0.5 (``clamp_min`` passes all of it: 1)."""
    return torch.maximum(x, x.new_zeros(())) + torch.log1p(torch.exp(-x.abs()))


def jnp_abs(x):
    """``jnp.abs``, whose gradient at 0 is 1 (``torch.abs``'s is 0)."""
    return torch.where(x >= 0, x, -x)


def jnp_clip(x, lo: float, hi: float):
    """``jnp.clip``: a maximum, then a minimum, each passing half the
    gradient at a tie (``torch.clamp`` passes all of it at a bound)."""
    return torch.minimum(torch.maximum(x, x.new_tensor(lo)), x.new_tensor(hi))


def _mamba_conv(u, conv_w, conv_b, state=None):
    """Causal depthwise conv over time, written out as the reference
    writes it: the ``Kc`` shifted products summed in tap order in u's
    dtype, then ``conv_b`` added. u: (B, S, Di); conv_w: (Kc, Di);
    state: (B, Kc - 1, Di), the previous pre-conv inputs (decode), or
    None (zeros). Returns (out, new state: the last Kc - 1 pre-conv
    inputs)."""
    Kc, S = conv_w.shape[0], u.shape[1]
    if state is None:
        up = F.pad(u, (0, 0, Kc - 1, 0))
    else:
        up = torch.cat([state.to(u.dtype), u], dim=1)
    out = 0
    for i in range(Kc):
        out = out + up[:, i:i + S, :] * conv_w[i][None, None]
    out = out + conv_b[None, None]
    return out, (up[:, -(Kc - 1):, :] if Kc > 1 else None)


def _mamba_ssm_inputs(params, u, cfg: ModelConfig, place=None):
    """(dt, A, B, C, D) of the scan from the post-conv activations u, in
    fp32: ``x_dbl = u @ x_proj`` split into (dt_in, B, C) column slices
    (B and C stay views), ``dt = softplus(dt_in @ dt_w + dt_bias)``,
    ``A = -exp(A_log)`` formed in ``A_log``'s own dtype and then widened,
    as the reference forms it (``layers.py:663``): fp32 when serving, bf16
    under the train step's cast. ``D`` is widened too (the kernel takes
    fp32; the train step's cast makes it bf16). On a mesh whose ``model``
    splits the channels (``place``) u and ``x_proj`` are the rank's
    channels, and ``x_dbl`` their partial sum, summed over ``model``."""
    m, _, R = _mamba_dims(cfg)
    x_dbl = u.float() @ params["x_proj"].float()
    if place is not None:
        x_dbl = place.model_sum(x_dbl)
    dt_in, Bc, Cc = torch.split(x_dbl, [R, m.d_state, m.d_state], dim=-1)
    dt = _softplus(dt_in @ params["dt_w"].float() + params["dt_bias"].float())
    A = -torch.exp(params["A_log"])
    return dt, A.float(), Bc, Cc, params["D"].float()


def _mamba_split(params, cfg: ModelConfig, place):
    """Whether the leaves hold the rank's block of the inner channels."""
    return place is not None and params["wx"].shape[1] < _mamba_dims(cfg)[1]


def apply_mamba(params, x, cfg: ModelConfig, *, cache=None, place=None):
    """Full-sequence Mamba mixer (prefill). x: (B, S, d) in the compute
    dtype; ``cache`` {"conv"} continues from earlier inputs (None: from
    zeros). The scan goes through ``ops.mamba_scan`` (the CUDA kernel on
    the card). Returns (out (B, S, d), {"conv": the last d_conv - 1
    pre-conv inputs, "ssm": the final state (B, Di, N) fp32}).

    On a mesh (``place``, a ``dist.spmd.Placement``) the leaves hold the
    rank's block of the Di channels where ``model`` splits them: the
    scan and the state cover those channels, and ``out_proj``'s partial
    sum leaves through ``place``."""
    split = _mamba_split(params, cfg, place)
    if place is not None:
        x = place.enter(x, split)
    dt_c = x.dtype
    u = x @ params["wx"]
    z = x @ params["wz"]
    u, new_conv = _mamba_conv(u, params["conv_w"], params["conv_b"],
                              None if cache is None else cache["conv"])
    u = F.silu(u)
    dt, A, Bc, Cc, D = _mamba_ssm_inputs(params, u, cfg,
                                         place if split else None)
    y, h = ops.mamba_scan(u, dt, A, Bc, Cc, D)
    y = y * F.silu(z)
    out = y.to(dt_c) @ params["out_proj"]
    if place is not None:
        out = place.exit(out, split)
    return out, {"conv": new_conv.to(dt_c), "ssm": h}


def apply_mamba_step(params, x, cfg: ModelConfig, cache, *, place=None):
    """One-token Mamba decode. x: (B, 1, d); cache {"conv", "ssm"}.
    Returns (out (B, 1, d), new cache). On a mesh (``place``) as
    :func:`apply_mamba`: the cache holds the rank's channels."""
    split = _mamba_split(params, cfg, place)
    if place is not None:
        x = place.enter(x, split)
    dt_c = x.dtype
    u = x @ params["wx"]
    z = x @ params["wz"]
    u, new_conv = _mamba_conv(u, params["conv_w"], params["conv_b"],
                              cache["conv"])
    u = F.silu(u)
    dt, A, Bc, Cc, D = _mamba_ssm_inputs(params, u, cfg,
                                         place if split else None)
    h, y = ops.mamba_step(cache["ssm"], u[:, 0], dt[:, 0], A, Bc[:, 0],
                          Cc[:, 0], D)
    y = y[:, None] * F.silu(z)
    out = y.to(dt_c) @ params["out_proj"]
    if place is not None:
        out = place.exit(out, split)
    return out, {"conv": new_conv.to(cache["conv"].dtype), "ssm": h}


def init_mamba_cache(cfg: ModelConfig, B: int, *, device):
    """Decode state of one Mamba layer: ``conv`` (B, d_conv - 1, Di) in
    the compute dtype and ``ssm`` (B, Di, N) fp32, both zero."""
    m, di, _ = _mamba_dims(cfg)
    return {"conv": torch.zeros((B, m.d_conv - 1, di),
                                dtype=dtype_of(cfg.dtype), device=device),
            "ssm": torch.zeros((B, di, m.d_state), dtype=torch.float32,
                               device=device)}


# ---- parameters ------------------------------------------------------------ #
# Logical axes of each layer's leaves (``dist.tagging.Axes``), one name a
# dimension, as the reference's ``p(...)`` calls tag them at creation
# (``layers.py:34-36,106-115,520-524,562-567,622-632,720-732``); the
# port's layers are unstacked, so no ``layer`` entry leads.
def norm_axes(cfg: ModelConfig):
    ax = {"scale": Axes((None,))}
    if cfg.norm == "layernorm":
        ax["bias"] = Axes((None,))
    return ax


def attention_axes(cfg: ModelConfig):
    ax = {"wq": Axes(("fsdp", "heads", None)),
          "wk": Axes(("fsdp", "kv_heads", None)),
          "wv": Axes(("fsdp", "kv_heads", None)),
          "wo": Axes(("heads", None, "fsdp"))}
    if cfg.qkv_bias:
        ax.update(bq=Axes(("heads", None)), bk=Axes(("kv_heads", None)),
                  bv=Axes(("kv_heads", None)))
    return ax


def ffn_axes(cfg: ModelConfig):
    ax = {"wu": Axes(("fsdp", "mlp")), "wd": Axes(("mlp", "fsdp"))}
    if cfg.glu:
        ax["wg"] = Axes(("fsdp", "mlp"))
    return ax


def moe_axes(cfg: ModelConfig):
    """``wd``'s data shard goes on its contraction dim f when the expert
    dim divides the production model axis of 16, else on d (the
    reference's choice, ``layers.py:550-560``)."""
    E = cfg.moe.n_experts
    wd = (("expert", "fsdp", "mlp") if E % 16 == 0
          else ("expert", "mlp", "fsdp"))
    ax = {"router": Axes((None, None)),
          "wu": Axes(("expert", "fsdp", "mlp")), "wd": Axes(wd)}
    if cfg.glu:
        ax["wg"] = Axes(("expert", "fsdp", "mlp"))
    return ax


def mamba_axes(cfg: ModelConfig):
    return {"wx": Axes(("fsdp", "mlp")), "wz": Axes(("fsdp", "mlp")),
            "conv_w": Axes((None, "mlp")), "conv_b": Axes(("mlp",)),
            "x_proj": Axes(("mlp", None)), "dt_w": Axes((None, "mlp")),
            "dt_bias": Axes(("mlp",)), "A_log": Axes(("mlp", None)),
            "D": Axes(("mlp",)), "out_proj": Axes(("mlp", "fsdp"))}


def rwkv6_axes(cfg: ModelConfig):
    ax = {n: Axes(("fsdp", "mlp")) for n in ("wr", "wk", "wv", "wg")}
    ax.update(wo=Axes(("mlp", "fsdp")), w0=Axes((None,)),
              w1=Axes(("fsdp", None)), w2=Axes((None, "mlp")),
              u=Axes((None,)), mu=Axes((None, None)),
              ln_scale=Axes((None,)))
    return ax


def init_attention(cfg: ModelConfig, normal, zeros):
    """``layers.init_attention``'s shapes and scales; ``normal(shape,
    scale)`` draws N(0, 1) * scale and ``zeros(shape)`` makes the q/k/v
    biases of a ``qkv_bias`` config, both in the stored dtype."""
    d, H, K, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    prm = {"wq": normal((d, H, hd), d ** -0.5),
           "wk": normal((d, K, hd), d ** -0.5),
           "wv": normal((d, K, hd), d ** -0.5),
           "wo": normal((H, hd, d), (H * hd) ** -0.5)}
    if cfg.qkv_bias:
        prm.update(bq=zeros((H, hd)), bk=zeros((K, hd)), bv=zeros((K, hd)))
    return prm


def init_ffn(cfg: ModelConfig, normal):
    """``layers.init_ffn``: ``wu``/``wg`` (d, f) at d^-0.5, ``wd`` (f, d)
    at f^-0.5 (``wg`` only for a GLU)."""
    d, f = cfg.d_model, cfg.d_ff
    prm = {"wu": normal((d, f), d ** -0.5)}
    if cfg.glu:
        prm["wg"] = normal((d, f), d ** -0.5)
    prm["wd"] = normal((f, d), f ** -0.5)
    return prm


def init_moe(cfg: ModelConfig, normal):
    """``layers.init_moe``: fp32 ``router`` (d, E) and per-expert
    ``wu``/``wg`` (E, d, f), ``wd`` (E, f, d)."""
    d, f, E = cfg.d_model, cfg.d_ff, cfg.moe.n_experts
    prm = {"router": normal((d, E), d ** -0.5, torch.float32),
           "wu": normal((E, d, f), d ** -0.5),
           "wd": normal((E, f, d), f ** -0.5)}
    if cfg.glu:
        prm["wg"] = normal((E, d, f), d ** -0.5)
    return prm


def init_mamba(cfg: ModelConfig, normal, *, dtype, device):
    """``layers.init_mamba``'s shapes, scales and constants: ``A_log =
    log(1..N)`` on every channel, ``dt_bias`` -4.6 (softplus ~ 0.01),
    ``D`` ones and ``conv_b`` zeros; ``x_proj``, ``dt_w``, ``dt_bias``,
    ``A_log`` and ``D`` in fp32, the rest in ``dtype``."""
    m, di, R = _mamba_dims(cfg)
    d, N = cfg.d_model, m.d_state
    dev = device
    f32 = torch.float32
    A = torch.arange(1, N + 1, dtype=f32, device=dev)[None].repeat(di, 1)
    return {
        "wx": normal((d, di), d ** -0.5),
        "wz": normal((d, di), d ** -0.5),
        "conv_w": normal((m.d_conv, di), m.d_conv ** -0.5),
        "conv_b": torch.zeros(di, dtype=dtype, device=dev),
        "x_proj": normal((di, R + 2 * N), di ** -0.5, f32),
        "dt_w": normal((R, di), R ** -0.5, f32),
        "dt_bias": torch.full((di,), -4.6, dtype=f32, device=dev),
        "A_log": torch.log(A),
        "D": torch.ones(di, dtype=f32, device=dev),
        "out_proj": normal((di, d), di ** -0.5),
    }


# ---- RWKV-6 ("Finch") time mix (``layers.py:715-835``) -------------------- #
def _rwkv6_dims(cfg: ModelConfig):
    """(heads H = d_model // head_dim, head_dim)."""
    r = cfg.rwkv6 or RWKV6Config()
    return cfg.d_model // r.head_dim, r.head_dim


def init_rwkv6(cfg: ModelConfig, normal, *, device):
    """``layers.init_rwkv6``'s shapes, scales and constants, every leaf
    fp32: ``wr``/``wk``/``wv``/``wg``/``wo`` (d, d) at d^-0.5, ``w1`` (d,
    Dw) at d^-0.5, ``w2`` (Dw, d) at Dw^-0.5, ``u`` (d,) normal x 0.5,
    ``w0`` -5, ``mu`` (5, d) 0.5 and ``ln_scale`` ones."""
    d = cfg.d_model
    Dw = (cfg.rwkv6 or RWKV6Config()).decay_lora_dim
    f32 = torch.float32
    prm = {n: normal((d, d), d ** -0.5, f32)
           for n in ("wr", "wk", "wv", "wg", "wo")}
    prm.update(
        w0=torch.full((d,), -5.0, dtype=f32, device=device),
        w1=normal((d, Dw), d ** -0.5, f32),
        w2=normal((Dw, d), Dw ** -0.5, f32),
        u=normal((d,), 0.5, f32),
        mu=torch.full((5, d), 0.5, dtype=f32, device=device),
        ln_scale=torch.ones(d, dtype=f32, device=device))
    return prm


def _rwkv6_step(u):
    """The wkv recurrence's step over x_t = (r, k, v, w) stacked, each
    (B, H, dh): y_j = sum_i (S + u kv)_ij r_i, S' = w_i S_ij + kv_ij with
    kv = k v^T, all fp32 (``layers.py:745-750``)."""
    def step(S, x_t):
        r_t, k_t, v_t, w_t = x_t
        kv = k_t[..., :, None] * v_t[..., None, :]  # (B, H, dh, dh)
        y = torch.einsum("bhij,bhi->bhj", S + u[None, :, :, None] * kv, r_t)
        return w_t[..., :, None] * S + kv, y
    return step


def _rwkv_wkv_scan(r, k, v, w, u, H: int, dh: int):
    """The wkv recurrence over time from a zero state. r, k, v, w: (B,
    S, d) fp32; u: (d,). Runs through ``scan_utils.chunked_scan`` in
    chunks of 64 steps, each checkpointed, so a backward keeps S / 64
    states of (B, H, dh, dh) instead of S. Plain PyTorch on both
    devices: the reference has no kernel for it. Returns (y (B, S, d),
    the final state (B, H, dh, dh))."""
    B, S, d = r.shape
    xs = torch.stack([a.reshape(B, S, H, dh) for a in (r, k, v, w)])
    xs = xs.permute(2, 0, 1, 3, 4)  # (S, 4, B, H, dh)
    S0 = torch.zeros((B, H, dh, dh), dtype=torch.float32, device=r.device)
    Sf, ys = chunked_scan(_rwkv6_step(u.reshape(H, dh)), S0, xs, chunk=64)
    return ys.permute(1, 0, 2, 3).reshape(B, S, d), Sf


def _rwkv6_streams(params, x32, prev):
    """The token-shifted r, k, v, w (decay) and g streams of the time
    mix, fp32: stream i mixes x with the previous token by ``mu[i]``;
    ``w = exp(-exp(w0 + tanh(x_w w1) w2))``, ``g = silu(x_g wg)``. Each
    weight is widened before its product (the train step's cast makes
    them bf16)."""
    xx = prev - x32
    mu = params["mu"].float()
    xr, xk, xv, xw, xg = (x32 + xx * mu[i] for i in range(5))
    r = xr @ params["wr"].float()
    k = xk @ params["wk"].float()
    v = xv @ params["wv"].float()
    g = F.silu(xg @ params["wg"].float())
    wlog = params["w0"].float() + (torch.tanh(xw @ params["w1"].float())
                                   @ params["w2"].float())
    return r, k, v, torch.exp(-torch.exp(wlog)), g


def _rwkv6_out(params, y, g, H: int, dh: int):
    """Per-head RMS norm of the wkv output (eps 1e-6), ``ln_scale``, the
    gate and ``wo``, fp32."""
    yh = y.reshape(*y.shape[:-1], H, dh)
    yh = yh * torch.rsqrt(yh.square().mean(-1, keepdim=True) + 1e-6)
    y = yh.reshape(y.shape) * params["ln_scale"].float()
    return (y * g) @ params["wo"].float()


def _rwkv6_local(params, cfg: ModelConfig, place):
    """(split: whether the leaves hold the rank's heads, their count)."""
    H, dh = _rwkv6_dims(cfg)
    Hl = params["wr"].shape[1] // dh
    return place is not None and Hl < H, Hl


def _rwkv6_exit(out, x, split: bool, place):
    """The time mix's fp32 output in x's dtype, on a mesh through
    ``place`` (a partial sum over the rank's heads summed in fp32)."""
    if place is not None:
        out = place.exit(out, split)
    return out.to(x.dtype)


def apply_rwkv6(params, x, cfg: ModelConfig, *, cache=None, place=None):
    """Full-sequence RWKV-6 time mix, in fp32 throughout, cast back to
    x's dtype. x: (B, S, d); ``cache`` {"shift"} gives the token before
    x (None: zeros). Returns (out (B, S, d), {"shift": x's last token in
    x's dtype, "wkv": the final state (B, H, dh, dh) fp32}).

    On a mesh (``place``, a ``dist.spmd.Placement``) the leaves hold the
    rank's heads where ``model`` divides them (``wo`` its rows; ``u``,
    ``w0`` and ``ln_scale`` its channels): the state covers those heads,
    and the output's partial sum leaves through ``place``. Where
    ``model`` does not divide the heads the leaves arrive whole and the
    layer runs on every head on every rank."""
    split, Hl = _rwkv6_local(params, cfg, place)
    if place is not None:
        x = place.enter(x, split)
    dh = _rwkv6_dims(cfg)[1]
    x32 = x.float()
    if cache is None:
        prev = F.pad(x32[:, :-1], (0, 0, 1, 0))
    else:
        prev = torch.cat([cache["shift"].float()[:, None], x32[:, :-1]], 1)
    r, k, v, w, g = _rwkv6_streams(params, x32, prev)
    y, Sf = _rwkv_wkv_scan(r, k, v, w, params["u"].float(), Hl, dh)
    out = _rwkv6_out(params, y, g, Hl, dh)
    return (_rwkv6_exit(out, x, split, place),
            {"shift": x[:, -1], "wkv": Sf})


def apply_rwkv6_step(params, x, cfg: ModelConfig, cache, *, place=None):
    """One-token RWKV-6 decode. x: (B, 1, d); cache {"shift" (B, d),
    "wkv" (B, H, dh, dh) fp32}. Returns (out (B, 1, d), new cache). On a
    mesh (``place``, a ``dist.serving`` placement) as
    :func:`apply_rwkv6`; the cache holds every head (the reference's
    slab keeps ``wkv`` whole over ``model``): a rank of split heads reads
    its own, and the new state of every head is gathered over ``model``
    (``place.heads_whole``)."""
    split, Hl = _rwkv6_local(params, cfg, place)
    if place is not None:
        x = place.enter(x, split)
    dh = _rwkv6_dims(cfg)[1]
    B = x.shape[0]
    wkv = cache["wkv"]
    if split:
        wkv = wkv[:, place.index * Hl:(place.index + 1) * Hl]
    x32 = x[:, 0].float()
    r, k, v, w, g = _rwkv6_streams(params, x32, cache["shift"].float())
    S, y = _rwkv6_step(params["u"].float().reshape(Hl, dh))(
        wkv, [a.reshape(B, Hl, dh) for a in (r, k, v, w)])
    out = _rwkv6_out(params, y.reshape(B, Hl * dh), g, Hl, dh)
    if split:
        S = place.heads_whole(S)
    return (_rwkv6_exit(out[:, None], x, split, place),
            {"shift": x[:, 0], "wkv": S})


def init_rwkv6_cache(cfg: ModelConfig, B: int, *, device):
    """Decode state of one RWKV-6 layer: ``shift`` (B, d) in the compute
    dtype and ``wkv`` (B, H, dh, dh) fp32, both zero."""
    H, dh = _rwkv6_dims(cfg)
    return {"shift": torch.zeros((B, cfg.d_model),
                                 dtype=dtype_of(cfg.dtype), device=device),
            "wkv": torch.zeros((B, H, dh, dh), dtype=torch.float32,
                               device=device)}
