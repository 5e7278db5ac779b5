"""Encoder-decoder transformer (``repro.models.encdec``): the Whisper
backbone. The audio frontend is a stub, as in the reference: the encoder
consumes precomputed frame embeddings (B, T, d_model). Positions are
sinusoidal (parameter-free), added to the frames and to the decoder's
token embeddings.

The encoder is pre-norm non-causal self-attention and a dense FFN per
layer; each decoder layer runs causal self-attention, cross-attention
over the encoder output and a dense FFN, each pre-norm and added to the
residual stream. Full-sequence attention (encoder, decoder, cross) goes
through ``kernels/ops.py:attention``, the flash kernels on the card.

Serving keeps two caches a decoder layer: the self-attention K/V (a slab
of ``cache_len`` slots, or pages of the shared pool) and the cross K/V,
a dense per-slot slab of ``enc_source_len`` slots computed once per
request (:func:`encode_cross`) and never written again. The paged chunk
program reads the cross slab through ``layers.attention_cross_chunk``
and slab decode through ``layers.attention_decode(..., cross=True)``,
both plain PyTorch on both devices (the reference has no kernel for
them); the self-attention pages go through the paged kernel.

Parameter tree: ``embed`` (V, d); ``enc_blocks``, one dict a layer
(``norm1``, ``attn``, ``norm2``, ``ffn``); ``enc_norm``; ``dec_blocks``,
one dict a layer (``norm1``, ``self_attn``, ``norm_x``, ``cross_attn``,
``norm2``, ``ffn``); ``dec_norm``; ``head`` (d, V) when untied. Where
the reference stacks a stack's layers along a leading axis and scans,
the port keeps a list and loops, as ``lm`` does; stored dtypes follow
``lm``'s rule (``layers.FP32_LEAVES`` in fp32).
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.dist.tagging import Axes
from repro_torch.models import layers as L
from repro_torch.models import lm
from repro_torch.utils import Stacked, tree_map

# Rows of the decoder's position table (the reference's
# ``sinusoid_table`` ``max_len``): chunk and decode steps take its rows.
MAX_POSITIONS = 65536
_TABLE_BLOCK = 8192  # rows computed at a time
_SIN_TABLES: Dict[Any, torch.Tensor] = {}
# The cross-attention of a slab decode step sees every encoder slot.
_CROSS_POS = 10 ** 9


def _sinusoid_rows(start: int, n: int, d: int, dtype, device):
    """Rows ``start .. start + n - 1`` of the position table: sin over
    the first d/2 columns, cos over the rest, at the fp32 angle
    ``pos / 10000^(2i/d)``, cast to ``dtype``.

    The reference's fp32 ``jnp.power`` is correctly rounded, so the
    denominator is formed in fp64 and rounded to fp32 (bitwise XLA's;
    ``torch.pow`` in fp32 misses it in 1-4 of d/2 entries); the angle is
    the fp32 quotient, as XLA's. ``sin``/``cos`` run in fp64 and round
    to fp32, where XLA's fp32 ones err by up to 3.3e-8, so the fp32
    tables differ by at most one ulp; cast to bf16 they are bitwise
    equal below position 3885 at d 1024 (``tests/test_torch_encdec.py``
    counts the differences)."""
    pos = torch.arange(start, start + n, dtype=torch.float32,
                       device=device)[:, None]
    i = torch.arange(d // 2, dtype=torch.float32, device=device)[None, :]
    base = torch.tensor(10000.0, dtype=torch.float64, device=device)
    den = torch.pow(base, (2 * i / d).double()).float()
    ang = (pos / den).double()
    return torch.cat([torch.sin(ang), torch.cos(ang)], -1).float().to(dtype)


def sinusoid(S: int, d: int, dtype, device=None) -> torch.Tensor:
    """(S, d) sinusoidal positions 0..S-1 (``encdec.sinusoid`` without
    its leading axis); row p equals row p of :func:`sinusoid_table`."""
    return _sinusoid_rows(0, S, d, dtype, device)


def sinusoid_table(cfg: ModelConfig, dtype, device) -> torch.Tensor:
    """(``MAX_POSITIONS``, d) position table, computed once per (d,
    dtype, device) and kept; a block of rows at a time, so that the fp64
    temporaries stay small (the whole table's are 0.5 GB each at d
    1024)."""
    dev = torch.device(device)
    key = (cfg.d_model, dtype, dev)
    if key not in _SIN_TABLES:
        table = torch.empty((MAX_POSITIONS, cfg.d_model), dtype=dtype,
                            device=dev)
        for s in range(0, MAX_POSITIONS, _TABLE_BLOCK):
            table[s:s + _TABLE_BLOCK] = _sinusoid_rows(
                s, _TABLE_BLOCK, cfg.d_model, dtype, dev)
        _SIN_TABLES[key] = table
    return _SIN_TABLES[key]


def _cdtype(cfg: ModelConfig) -> torch.dtype:
    return L.dtype_of(cfg.dtype)


# ---- parameters ------------------------------------------------------------ #
def init_encdec(cfg: ModelConfig, seed: int = 0, *, device="cuda",
                dtype=None) -> Dict[str, Any]:
    """Random weights with the reference's shapes and scales
    (``encdec.init_encdec``, ``layers.init_attention``, ``init_ffn``):
    normal(0, 1) times d^-0.5 for the embedding and the untied head,
    the attention and FFN leaves as ``lm.init_lm`` draws them, norm
    scales ones, LayerNorm and q/k/v biases zeros; made on ``device``
    from a ``torch.Generator`` seeded with ``seed``, in ``dtype``
    (default: the compute dtype) with ``layers.FP32_LEAVES`` in fp32.
    The numbers differ from ``jax.random``'s; parity tests copy JAX
    weights in with :func:`params_from_numpy`."""
    dev = resolve_device(device)
    dt = dtype or _cdtype(cfg)
    gen = torch.Generator(device=dev).manual_seed(seed)
    d = cfg.d_model

    def normal(shape, scale, out_dtype=dt):
        w = torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)
        return w.mul_(scale).to(out_dtype)

    def zeros(shape):
        return torch.zeros(shape, dtype=dt, device=dev)

    def norm():
        return L.init_norm(cfg, device=dev)

    params = {"embed": normal((cfg.vocab, d), d ** -0.5)}
    params["enc_blocks"] = [
        {"norm1": norm(), "attn": L.init_attention(cfg, normal, zeros),
         "norm2": norm(), "ffn": L.init_ffn(cfg, normal)}
        for _ in range(cfg.n_enc_layers)]
    params["enc_norm"] = norm()
    params["dec_blocks"] = [
        {"norm1": norm(), "self_attn": L.init_attention(cfg, normal, zeros),
         "norm_x": norm(), "cross_attn": L.init_attention(cfg, normal, zeros),
         "norm2": norm(), "ffn": L.init_ffn(cfg, normal)}
        for _ in range(cfg.n_layers)]
    params["dec_norm"] = norm()
    if not cfg.tie_embeddings:
        params["head"] = normal((d, cfg.vocab), d ** -0.5)
    return params


def param_axes(cfg: ModelConfig) -> Dict[str, Any]:
    """The logical axes of :func:`init_encdec`'s tree, as the reference
    tags it (``encdec.py:33-82``), each layer of the two lists untagged
    by a ``layer`` entry."""
    def attn():
        return L.attention_axes(cfg)

    axes = {"embed": Axes(("vocab", "fsdp")),
            "enc_blocks": [{"norm1": L.norm_axes(cfg), "attn": attn(),
                            "norm2": L.norm_axes(cfg),
                            "ffn": L.ffn_axes(cfg)}
                           for _ in range(cfg.n_enc_layers)],
            "enc_norm": L.norm_axes(cfg),
            "dec_blocks": [{"norm1": L.norm_axes(cfg), "self_attn": attn(),
                            "norm_x": L.norm_axes(cfg), "cross_attn": attn(),
                            "norm2": L.norm_axes(cfg),
                            "ffn": L.ffn_axes(cfg)}
                           for _ in range(cfg.n_layers)],
            "dec_norm": L.norm_axes(cfg)}
    if not cfg.tie_embeddings:
        axes["head"] = Axes(("fsdp", "vocab"))
    return axes


def params_from_numpy(tree, cfg: ModelConfig, device="cuda",
                      dtype=None) -> Dict[str, Any]:
    """The weight bridge: the reference's enc-dec tree as numpy arrays
    (``split_tree(init_encdec(cfg, key))[0]``), whose ``enc_blocks`` and
    ``dec_blocks`` leaves are stacked over layers, to the port's tree on
    ``device`` in ``dtype`` (default: the compute dtype;
    ``layers.FP32_LEAVES`` stay fp32). Arrays are taken as fp32, then
    cast."""
    dev = resolve_device(device)
    dt = dtype or _cdtype(cfg)

    def conv(a, name=""):
        t = torch.tensor(np.asarray(a, np.float32))
        return t.to(dev, L.stored_dtype(name, dt))

    def named(t, b=None):
        return {k: (named(v, b) if isinstance(v, dict)
                    else conv(v if b is None else np.asarray(v)[b], k))
                for k, v in t.items()}

    params = {"embed": conv(tree["embed"]),
              "enc_blocks": [named(tree["enc_blocks"], i)
                             for i in range(cfg.n_enc_layers)],
              "enc_norm": named(tree["enc_norm"]),
              "dec_blocks": [named(tree["dec_blocks"], i)
                             for i in range(cfg.n_layers)],
              "dec_norm": named(tree["dec_norm"])}
    if not cfg.tie_embeddings:
        params["head"] = conv(tree["head"])
    return params


def reference_tree(params, cfg: ModelConfig) -> Dict[str, Any]:
    """The port's tree (or one of its shape, such as Adam's moments) in
    the reference's names and layouts: ``enc_blocks`` and ``dec_blocks``
    each one tree whose leaves are :class:`~repro_torch.utils.Stacked`
    over the layers. No tensor is copied: checkpoints write and restore
    through it."""
    def stack(blocks):
        return tree_map(lambda *ps: Stacked(ps), *blocks)

    out = {k: v for k, v in params.items()
           if k not in ("enc_blocks", "dec_blocks")}
    out["enc_blocks"] = stack(params["enc_blocks"])
    out["dec_blocks"] = stack(params["dec_blocks"])
    return out


# ---- encoder --------------------------------------------------------------- #
def _positions(B: int, S: int, device):
    return torch.arange(S, device=device).expand(B, S)


def _enc_block(cfg: ModelConfig, bp, x, positions):
    h = L.apply_norm(bp["norm1"], x)
    y, _ = L.attention_full(bp["attn"], h, cfg, positions=positions,
                            causal=False)
    x = x + y
    return x + L.apply_ffn(bp["ffn"], L.apply_norm(bp["norm2"], x), cfg)


def encode(params, cfg: ModelConfig, frames):
    """frames: (B, T, d) precomputed embeddings -> (B, T, d) encoder
    output in the compute dtype. The frames are cast to the compute
    dtype and the positions added there (``encdec.py:93``). With
    ``cfg.remat`` each layer runs under ``torch.utils.checkpoint``."""
    dt = _cdtype(cfg)
    B, T, _ = frames.shape
    x = frames.to(dt) + sinusoid(T, cfg.d_model, dt, frames.device)
    positions = _positions(B, T, x.device)
    for bp in params["enc_blocks"]:
        if cfg.remat:
            x = checkpoint(_enc_block, cfg, bp, x, positions,
                           use_reentrant=False, preserve_rng_state=False)
        else:
            x = _enc_block(cfg, bp, x, positions)
    return L.apply_norm(params["enc_norm"], x)


# ---- decoder: teacher forcing and prefill ---------------------------------- #
def _dec_block_full(cfg: ModelConfig, bp, x, enc_out, positions):
    """One decoder layer over the full target: (x, ((k, v) of the self-
    attention, (k, v) of the cross-attention))."""
    h = L.apply_norm(bp["norm1"], x)
    y, kv_self = L.attention_full(bp["self_attn"], h, cfg,
                                  positions=positions, causal=True)
    x = x + y
    h = L.apply_norm(bp["norm_x"], x)
    y, kv_cross = L.attention_full(bp["cross_attn"], h, cfg,
                                   positions=positions, causal=False,
                                   kv_x=enc_out)
    x = x + y
    x = x + L.apply_ffn(bp["ffn"], L.apply_norm(bp["norm2"], x), cfg)
    return x, (kv_self, kv_cross)


def _dec_layer_out(cfg, bp, x, enc_out, positions):
    return _dec_block_full(cfg, bp, x, enc_out, positions)[0]


def _embed_tokens(params, cfg: ModelConfig, tokens):
    return lm._embed(params, tokens).to(_cdtype(cfg))


def forward(params, cfg: ModelConfig, frames, tokens):
    """Teacher-forced decode of the whole target: logits (B, S, vocab)
    (the reference's ``forward`` also returns an aux loss of 0)."""
    enc_out = encode(params, cfg, frames)
    dt = _cdtype(cfg)
    B, S = tokens.shape
    x = _embed_tokens(params, cfg, tokens)
    x = x + sinusoid(S, cfg.d_model, dt, x.device)
    positions = _positions(B, S, x.device)
    for bp in params["dec_blocks"]:
        if cfg.remat:
            x = checkpoint(_dec_layer_out, cfg, bp, x, enc_out, positions,
                           use_reentrant=False, preserve_rng_state=False)
        else:
            x = _dec_layer_out(cfg, bp, x, enc_out, positions)
    return lm._head(params, L.apply_norm(params["dec_norm"], x))


def per_example_nll(params, cfg: ModelConfig, batch):
    """(mean next-token nll per example (B,), 0.0) from the full fp32
    logits, as the reference computes them (no chunked CE). batch:
    {"media": (B, T, d) frames, "tokens": (B, S)}."""
    tokens = batch["tokens"]
    logits = forward(params, cfg, batch["media"], tokens)
    tgt = tokens[:, 1:].to(logits.device, torch.long)
    lg = logits[:, :-1].float()
    logz = torch.logsumexp(lg, dim=-1)
    gold = torch.gather(lg, -1, tgt[..., None])[..., 0]
    return (logz - gold).mean(-1), 0.0


def loss_fn(params, cfg: ModelConfig, batch):
    """Next-token cross entropy in fp32. Returns (loss, {"nll",
    "aux"})."""
    nll_ex, aux = per_example_nll(params, cfg, batch)
    nll = nll_ex.mean()
    return nll, {"nll": nll, "aux": aux}


# ---- serving caches -------------------------------------------------------- #
def init_cache(cfg: ModelConfig, B: int, seq_len: int, window=None, *,
               device="cuda"):
    """Slab decode caches: {"self": one ``layers.init_kv_cache`` of
    ``min(seq_len, window)`` slots a decoder layer, "cross": one of
    ``enc_source_len`` slots a layer}, batch on axis 0."""
    dev = resolve_device(device)
    Ls = min(seq_len, window) if window else seq_len
    return {"self": [L.init_kv_cache(cfg, B, Ls, device=dev)
                     for _ in range(cfg.n_layers)],
            "cross": [L.init_kv_cache(cfg, B, cfg.enc_source_len, device=dev)
                      for _ in range(cfg.n_layers)]}


def init_paged_cache(cfg: ModelConfig, B: int, n_pages: int, page: int, *,
                     device="cuda"):
    """Paged self-attention pools for every decoder layer
    (``layers.init_paged_kv_cache``, layer-stacked, as ``lm``'s) beside
    a dense per-slot cross slab a layer of ``enc_source_len`` slots
    (``layers.init_kv_cache``): cross K/V never grow, so paging buys
    nothing there. The slab takes the pool's dtype; an int4 pool raises
    ``ValueError`` there, as in the reference."""
    dev = resolve_device(device)
    cross = [L.init_kv_cache(cfg, B, cfg.enc_source_len, device=dev)
             for _ in range(cfg.n_layers)]
    return {"self": L.init_paged_kv_cache(cfg, n_pages, page,
                                          n_layers=cfg.n_layers, device=dev),
            "cross": cross}


def encode_cross(params, cfg: ModelConfig, frames):
    """The encoder and every decoder layer's cross K/V for a request:
    frames (B, T, d) -> one cache of T slots a layer (``cache_from_
    prefill``, quantized for an int8 slab), the only encoder work a
    request needs, done once at admission."""
    enc_out = encode(params, cfg, frames)
    T = enc_out.shape[1]
    return [L.cache_from_prefill(cfg, L._qkv(bp["cross_attn"], enc_out, "k"),
                                 L._qkv(bp["cross_attn"], enc_out, "v"), T)
            for bp in params["dec_blocks"]]


def decode_chunk(params, cfg: ModelConfig, tokens, cache, page_table, pos,
                 n_valid, *, window=None, full_logits=False):
    """C decoder tokens per row against the paged self-attention pools
    and the static cross slab (``lm.decode_chunk``'s batch contract and
    ``full_logits`` variant). Positions are rows of
    :func:`sinusoid_table`. The pools are written in place; the cross
    slab is read only. Returns (logits, cache)."""
    dt = _cdtype(cfg)
    B, C = tokens.shape
    x = _embed_tokens(params, cfg, tokens)
    positions = (pos.to(x.device, torch.long).reshape(B, 1)
                 + torch.arange(C, device=x.device)[None, :])
    x = x + sinusoid_table(cfg, dt, x.device)[positions]
    pools = cache["self"]
    for i, bp in enumerate(params["dec_blocks"]):
        h = L.apply_norm(bp["norm1"], x)
        layer = {name: pool[i] for name, pool in pools.items()}
        x = x + L.attention_decode_paged(bp["self_attn"], h, cfg, layer,
                                         page_table, pos, n_valid,
                                         window=window)
        h = L.apply_norm(bp["norm_x"], x)
        x = x + L.attention_cross_chunk(bp["cross_attn"], h, cfg,
                                        cache["cross"][i])
        x = x + L.apply_ffn(bp["ffn"], L.apply_norm(bp["norm2"], x), cfg)
    x = L.apply_norm(params["dec_norm"], x)
    if full_logits:
        return lm._head(params, x), cache
    return lm._head(params, L.gather_last(x, n_valid - 1))[:, 0], cache


def prefill(params, cfg: ModelConfig, frames, tokens, *, cache_len=None,
            window=None, last_pos=None):
    """Encode, then teacher-force the prompt, building the slab caches.

    frames: (B, T, d); tokens: (B, S). Returns (logits (B, vocab) at
    ``last_pos`` (B,) per row, or at S - 1 when None; {"self": per layer
    the last ``min(cache_len, window)`` prompt positions' K/V, "cross":
    per layer the encoder K/V, T slots})."""
    enc_out = encode(params, cfg, frames)
    dt = _cdtype(cfg)
    B, S = tokens.shape
    T = enc_out.shape[1]
    cache_len = cache_len or S
    Ls = min(cache_len, window) if window else cache_len
    x = _embed_tokens(params, cfg, tokens)
    x = x + sinusoid(S, cfg.d_model, dt, x.device)
    positions = _positions(B, S, x.device)
    caches = {"self": [], "cross": []}
    for bp in params["dec_blocks"]:
        x, ((k, v), (kc, vc)) = _dec_block_full(cfg, bp, x, enc_out,
                                                 positions)
        caches["self"].append(L.cache_from_prefill(cfg, k[:, -Ls:],
                                                   v[:, -Ls:], Ls))
        caches["cross"].append(L.cache_from_prefill(cfg, kc, vc, T))
    x = L.apply_norm(params["dec_norm"], x)
    return lm._head(params, L.gather_last(x, last_pos))[:, 0], caches


def decode_step(params, cfg: ModelConfig, token, cache, pos, *, window=None):
    """One decoder token for every row. token: (B, 1); ``pos`` an int or
    (B,) absolute positions; cache: :func:`init_cache`'s or
    :func:`prefill`'s. The self-attention K/V are written in place; the
    cross caches are read only. Returns (logits (B, vocab), cache)."""
    dt = _cdtype(cfg)
    x = _embed_tokens(params, cfg, token)
    posv = torch.as_tensor(pos, device=x.device).long().reshape(-1)
    x = x + sinusoid_table(cfg, dt, x.device)[posv][:, None]
    for i, bp in enumerate(params["dec_blocks"]):
        h = L.apply_norm(bp["norm1"], x)
        y, cache["self"][i] = L.attention_decode(
            bp["self_attn"], h, cfg, cache["self"][i], pos=pos, window=window)
        x = x + y
        h = L.apply_norm(bp["norm_x"], x)
        y, _ = L.attention_decode(bp["cross_attn"], h, cfg,
                                  cache["cross"][i], pos=_CROSS_POS,
                                  cross=True)
        x = x + y
        x = x + L.apply_ffn(bp["ffn"], L.apply_norm(bp["norm2"], x), cfg)
    x = L.apply_norm(params["dec_norm"], x)
    return lm._head(params, x)[:, 0], cache
