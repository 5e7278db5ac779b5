"""Decoder-only LM (``repro.models.lm``): weights, embedding, the
output head, the full-sequence forward and chunked loss of the train
step, the slab cache with its prefill and decode step, the paged cache
and the serving chunk program.

The stack follows ``cfg.block_pattern``: layer i runs the pattern's
entry ``i % len(pattern)``, an attention, Mamba or RWKV-6 mixer, then a
dense, MoE or no FFN. A vision frontend's media (precomputed patch
embeddings, (B, n_media, d)) are prepended to the token embeddings, with
M-RoPE grid positions (:func:`_positions`). The reference stacks each
pattern position's weights over blocks and scans over them; here
``params["layers"]`` is a list walked by a Python loop, and so are the
caches.

Stored dtype: the reference keeps fp32 master weights and casts them to
the compute dtype (bf16) at every use. Serving never updates weights,
so the port stores them in the compute dtype once; training keeps fp32
masters (``init_lm(dtype=torch.float32)``) and casts them once per step
(``optim.precision.compute_cast``). Either way the layers receive
weights already in the compute dtype, and the values the matrix
products see are the reference's. The leaves the reference reads in
fp32 (``layers.FP32_LEAVES``, and every leaf of an RWKV-6 mixer,
``layers.FP32_MIXERS``) stay fp32 in every case but under the train
step's cast, which rounds them as the reference's does.
"""
from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.dist.tagging import Axes
from repro_torch.models import layers as L
from repro_torch.utils import Stacked, tree_map

_MIXERS = ("attn", "mamba", "rwkv6")
_FFNS = ("dense", "moe", "none")


def _check_supported(cfg: ModelConfig) -> None:
    for s in cfg.block_pattern:
        if s.mixer not in _MIXERS or s.ffn not in _FFNS:
            raise NotImplementedError(
                f"{cfg.name}: a ({s.mixer}, {s.ffn}) layer is not ported; "
                f"the port runs {'/'.join(_MIXERS)} mixers with "
                f"{'/'.join(_FFNS)} FFNs")


def _spec_of(cfg: ModelConfig, i: int) -> LayerSpec:
    """The pattern entry of layer i."""
    return cfg.block_pattern[i % len(cfg.block_pattern)]


def init_lm(cfg: ModelConfig, seed: int = 0, *, device="cuda",
            dtype=None) -> Dict[str, Any]:
    """Random weights with the reference's scales and constants
    (``lm.py:62``, ``layers.py:101``, ``:516``, ``:547``, ``:616``), made
    on ``device`` from a ``torch.Generator`` seeded with ``seed``:
    normal(0, 1) times d^-0.5 for the embedding, the untied head and the
    projections out of d, (H*hd)^-0.5 for ``wo``, the input width^-0.5
    for the others; norm scales are ones, LayerNorm and q/k/v biases
    zeros; Mamba's ``A_log``, ``dt_bias``, ``D`` and ``conv_b`` and
    RWKV-6's ``w0``, ``mu`` and ``ln_scale`` are the reference's
    constants. Leaves are in ``dtype`` (default: the compute dtype),
    ``layers.FP32_LEAVES`` (the norms' among them) and an RWKV-6 mixer's
    in fp32. The numbers differ from ``jax.random``'s; parity tests copy
    JAX weights in with :func:`params_from_numpy` instead."""
    _check_supported(cfg)
    dev = resolve_device(device)
    dt = dtype or L.dtype_of(cfg.dtype)
    gen = torch.Generator(device=dev).manual_seed(seed)
    d = cfg.d_model

    def draw(shape):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.float32)

    def normal(shape, scale, out_dtype=dt):
        if int(np.prod(shape)) < 2 ** 31:
            return draw(shape).mul_(scale).to(out_dtype)
        # one expert at a time: no fp32 copy of a whole >2^31 tensor
        w = torch.empty(shape, dtype=out_dtype, device=dev)
        for i in range(shape[0]):
            w[i] = draw(shape[1:]).mul_(scale)
        return w

    def zeros(shape):
        return torch.zeros(shape, dtype=dt, device=dev)

    def norm():
        return L.init_norm(cfg, device=dev)

    params = {"embed": normal((cfg.vocab, d), d ** -0.5), "layers": []}
    for i in range(cfg.n_layers):
        spec = _spec_of(cfg, i)
        if spec.mixer == "attn":
            mixer = L.init_attention(cfg, normal, zeros)
        elif spec.mixer == "mamba":
            mixer = L.init_mamba(cfg, normal, dtype=dt, device=dev)
        else:
            mixer = L.init_rwkv6(cfg, normal, device=dev)
        layer = {"norm1": norm(), "mixer": mixer}
        if spec.ffn != "none":
            layer["norm2"] = norm()
            layer["ffn"] = (L.init_moe(cfg, normal) if spec.ffn == "moe"
                            else L.init_ffn(cfg, normal))
        params["layers"].append(layer)
    params["final_norm"] = norm()
    if not cfg.tie_embeddings:
        params["head"] = normal((d, cfg.vocab), d ** -0.5)
    return params


def param_axes(cfg: ModelConfig) -> Dict[str, Any]:
    """The logical axes of :func:`init_lm`'s tree, one
    :class:`~repro_torch.dist.tagging.Axes` a leaf, as the reference tags
    its leaves (``lm.py:62-81``; the ``layers.*_axes``): ``embed``
    ("vocab", "fsdp"), ``head`` ("fsdp", "vocab"), and each layer of the
    list untagged by a ``layer`` entry."""
    _check_supported(cfg)
    mixers = {"attn": L.attention_axes, "mamba": L.mamba_axes,
              "rwkv6": L.rwkv6_axes}
    layers = []
    for i in range(cfg.n_layers):
        spec = _spec_of(cfg, i)
        layer = {"norm1": L.norm_axes(cfg), "mixer": mixers[spec.mixer](cfg)}
        if spec.ffn != "none":
            layer["norm2"] = L.norm_axes(cfg)
            layer["ffn"] = (L.moe_axes(cfg) if spec.ffn == "moe"
                            else L.ffn_axes(cfg))
        layers.append(layer)
    axes = {"embed": Axes(("vocab", "fsdp")), "layers": layers,
            "final_norm": L.norm_axes(cfg)}
    if not cfg.tie_embeddings:
        axes["head"] = Axes(("fsdp", "vocab"))
    return axes


def params_from_numpy(tree, cfg: ModelConfig, device="cuda",
                      dtype=None) -> Dict[str, Any]:
    """The weight bridge: the reference's parameter tree, as numpy
    arrays (``split_tree(ModelAPI(cfg).init(cfg, key))[0]``), to the
    port's parameters on ``device`` in ``dtype`` (default: the config's
    compute dtype; ``layers.FP32_LEAVES`` and an RWKV-6 mixer's leaves
    stay fp32).

    The tree keeps the reference's names and layouts: ``embed`` (V, d);
    ``blocks``, one tree per pattern position, each leaf stacked over
    ``n_blocks`` (layer ``b * len(pattern) + j`` is ``blocks[j][b]``),
    with ``norm1``/``norm2`` ``scale`` (and ``bias`` for a LayerNorm),
    the ``mixer`` leaves (q/k/v biases included) and the ``ffn`` leaves
    of ``layers``; ``final_norm``; ``head`` (d, V) when untied. Arrays
    are taken as fp32, then cast.
    """
    _check_supported(cfg)
    dev = resolve_device(device)
    dt = dtype or L.dtype_of(cfg.dtype)

    def conv(a, name="", mixer=""):
        t = torch.tensor(np.asarray(a, np.float32))
        return t.to(dev, L.stored_dtype(name, dt, mixer))

    def named(tree, b=None, mixer=""):
        if isinstance(tree, dict):
            return {k: (named(v, b, mixer if k == "mixer" else "")
                        if isinstance(v, dict)
                        else conv(v if b is None else np.asarray(v)[b], k,
                                  mixer))
                    for k, v in tree.items()}
        return conv(tree if b is None else np.asarray(tree)[b])

    P = len(cfg.block_pattern)
    params = {
        "embed": conv(tree["embed"]),
        "layers": [named(tree["blocks"][i % P], i // P,
                         _spec_of(cfg, i).mixer)
                   for i in range(cfg.n_layers)],
        "final_norm": named(tree["final_norm"]),
    }
    if not cfg.tie_embeddings:
        params["head"] = conv(tree["head"])
    return params


def use_cast(params, cfg: ModelConfig) -> Dict[str, Any]:
    """The values the reference's layers read from fp32 masters outside
    its train step (eval, serving), which casts no tree but each weight
    at use: every fp32 leaf in the compute dtype, ``layers.FP32_LEAVES``
    (norm leaves, the router, Mamba's) and every leaf of an RWKV-6
    mixer (``layers.FP32_MIXERS``, whatever its name) kept fp32, as
    :func:`params_from_numpy` stores them."""
    dt = L.dtype_of(cfg.dtype)

    def walk(tree, mixer=""):
        # ``mixer``: the kind of the mixer whose leaves ``tree`` holds
        return {k: (walk(v, mixer) if isinstance(v, dict)
                    else [layer(x, i) if k == "layers" else walk(x)
                          for i, x in enumerate(v)]
                    if isinstance(v, list)
                    else v if v.dtype != torch.float32
                    else v.to(L.stored_dtype(k, dt, mixer)))
                for k, v in tree.items()}

    def layer(lp, i):
        return {k: walk(v, _spec_of(cfg, i).mixer if k == "mixer" else "")
                for k, v in lp.items()}

    return walk(params)


def reference_tree(params, cfg: ModelConfig) -> Dict[str, Any]:
    """The port's parameter tree (or a tree of its shape, such as Adam's
    moments) in the reference's names and layouts, the inverse of
    :func:`params_from_numpy`: ``blocks[j]`` holds pattern position j,
    each leaf a :class:`~repro_torch.utils.Stacked` of the tensors of
    layers j, j + P, ... No tensor is copied: checkpoints write and
    restore through it."""
    P = len(cfg.block_pattern)
    layers = params["layers"]
    out = {"embed": params["embed"],
           "blocks": tuple(tree_map(lambda *ps: Stacked(ps), *layers[j::P])
                           for j in range(P)),
           "final_norm": params["final_norm"]}
    if "head" in params:
        out["head"] = params["head"]
    return out


def perturb_norms(tree, seed: int):
    """A numpy parameter tree (``params_from_numpy``'s input) with every
    norm ``scale`` drawn as 1 + 0.1 N(0, 1) and every norm ``bias`` and
    q/k/v bias as 0.1 N(0, 1) from numpy's ``default_rng(seed)``, the
    rest as it is: weights for parity checks, where the initial ones
    and zeros would pin nothing."""
    rng = np.random.default_rng(seed)

    def walk(t):
        if isinstance(t, dict):
            out = {}
            for k, v in t.items():
                if k == "scale":
                    out[k] = (1 + 0.1 * rng.standard_normal(np.shape(v))
                              ).astype(np.float32)
                elif k in ("bias", "bq", "bk", "bv"):
                    out[k] = (0.1 * rng.standard_normal(np.shape(v))
                              ).astype(np.float32)
                else:
                    out[k] = walk(v)
            return out
        if isinstance(t, (tuple, list)):
            return type(t)(walk(x) for x in t)
        return np.asarray(t)

    return walk(tree)


def _embed(params, tokens):
    return params["embed"][tokens.to(params["embed"].device, torch.long)]


def _head(params, x):
    """Output projection x (B, S, d) -> (B, S, vocab): ``head`` (d, V)
    when untied, else the embedding's transpose."""
    if "head" in params:
        return x @ params["head"]
    return x @ params["embed"].T


def _positions(cfg: ModelConfig, B: int, S: int, device, n_media: int = 0):
    """RoPE positions 0..S-1 for every row, (B, S); for M-RoPE (B, S, 3)
    (temporal, height, width), where the first ``n_media`` positions,
    the media, take the grid coordinates (0, idx // side, idx % side)
    with ``side = max(1, int(n_media ** 0.5))`` (not exact for a count
    that is not a square), and the text takes its absolute index on all
    three streams, so that decode, which knows only that index, agrees
    with the full forward (``lm.py:113-131``)."""
    idx = torch.arange(S, device=device)
    if cfg.rope != "mrope":
        return idx.expand(B, S)
    if n_media == 0:
        return idx[:, None].expand(B, S, 3)
    side = max(1, int(n_media ** 0.5))
    media = idx < n_media
    p3 = torch.stack([torch.where(media, 0, idx),
                      torch.where(media, idx // side, idx),
                      torch.where(media, idx % side, idx)], dim=-1)
    return p3.expand(B, S, 3)


def _embed_inputs(params, tokens, media, place=None):
    """(the token embeddings with ``media`` (B, n, d), if any, cast to
    the compute dtype and prepended, n); on a serving mesh (``place``)
    the embedding is ``place.embed``'s."""
    x = _embed(params, tokens) if place is None else place.embed(params,
                                                                 tokens)
    if media is None:
        return x, 0
    media = media.to(x.device, x.dtype)
    return torch.cat([media, x], dim=1), media.shape[1]


def _apply_block_full(cfg: ModelConfig, spec: LayerSpec, lp, x, positions,
                      window=None, place=None):
    """One layer over the full sequence: pre-norm attention, Mamba or
    RWKV-6 mixer, then the pre-norm dense or MoE FFN (if any), each
    added to the residual stream. Returns (x, MoE aux loss or 0.0, the
    mixer's state: (k, v) for attention, {"conv", "ssm"} for Mamba,
    {"shift", "wkv"} for RWKV-6). On a mesh (``place``) x is the rank's
    stream and ``lp`` the layer's weights as ``place.layer`` gives them."""
    h = L.apply_norm(lp["norm1"], x)
    if spec.mixer == "attn":
        y, state = L.attention_full(lp["mixer"], h, cfg, positions=positions,
                                    window=window, place=place)
    elif spec.mixer == "mamba":
        y, state = L.apply_mamba(lp["mixer"], h, cfg, place=place)
    else:
        y, state = L.apply_rwkv6(lp["mixer"], h, cfg, place=place)
    x, aux = _ffn(cfg, spec, lp, x + y, place)
    return x, aux, state


def _layer_out(cfg, spec, lp, x, positions, window, place=None, i=0):
    """:func:`_apply_block_full`'s residual stream and MoE aux loss (what
    a checkpointed layer returns); on a mesh layer ``i``'s blocks are
    gathered here, inside the checkpoint, so the backward gathers them
    again instead of keeping them."""
    if place is not None:
        lp = place.layer(lp, i)
    return _apply_block_full(cfg, spec, lp, x, positions, window, place)[:2]


def forward_hidden(params, cfg: ModelConfig, tokens, *, media=None,
                   window=None, place=None):
    """Full-sequence forward up to the final norm (no output projection).

    tokens: (B, S); ``media`` (B, n, d), a vision frontend's patch
    embeddings, cast to the compute dtype and prepended. Returns (hidden
    (B, n + S, d), the MoE aux loss summed over layers, 0.0 for a stack
    without MoE). With ``cfg.remat`` each layer runs under
    ``torch.utils.checkpoint`` (non-reentrant): only its input is kept,
    and the backward recomputes the layer (its scan, router and aux loss
    included), as the reference's ``jax.checkpoint`` over the scanned
    block does.

    On a mesh (``place``, a ``dist.spmd.Placement``) ``params`` are the
    rank's blocks and the rows its own; the hidden states are the rank's
    sequence block (``place.positions()``) under ``seq_parallel``.
    """
    if place is None:
        x, n_media = _embed_inputs(params, tokens, media)
    else:
        x, n_media = _embed_inputs({"embed": place.leaf(params, "embed")},
                                   tokens, media)
    B, S, _ = x.shape
    positions = _positions(cfg, B, S, x.device, n_media)
    if place is not None:
        x = place.seq_block(x)
    aux = 0.0
    for i, lp in enumerate(params["layers"]):
        spec = _spec_of(cfg, i)
        args = (cfg, spec, lp, x, positions, window, place, i)
        if cfg.remat:
            # Nothing random runs inside a layer: no RNG state to stash.
            x, a = checkpoint(_layer_out, *args, use_reentrant=False,
                              preserve_rng_state=False)
        else:
            x, a = _layer_out(*args)
        aux = aux + a
    final = (params["final_norm"] if place is None
             else place.leaf(params, "final_norm"))
    return L.apply_norm(final, x), aux


def forward(params, cfg: ModelConfig, tokens, *, media=None, window=None):
    """Full-sequence forward. Returns logits (B, n_media + S, vocab);
    the MoE aux loss, which the reference's ``forward`` also returns, is
    dropped (:func:`forward_hidden` keeps it)."""
    return _head(params, forward_hidden(params, cfg, tokens, media=media,
                                        window=window)[0])


def _ce_chunk(params, h, targets):
    """Summed next-token NLL of one chunk: (B, c, d), (B, c) -> (B,),
    from fp32 logits of the head."""
    lg = _head(params, h).float()
    logz = torch.logsumexp(lg, dim=-1)
    gold = torch.gather(lg, -1, targets[..., None])[..., 0]
    return (logz - gold).sum(-1)


def _chunked_ce(params, cfg: ModelConfig, hidden, targets):
    """Per-example summed cross entropy, in sequence chunks of
    ``cfg.loss_chunk``, each checkpointed so that no chunk's (B, c,
    vocab) fp32 logits stay alive for the backward: it recomputes them.

    hidden: (B, S, d) aligned with targets (B, S). Returns (B,) fp32.
    """
    B, S, _ = hidden.shape
    c = min(cfg.loss_chunk, S)
    targets = targets.to(hidden.device, torch.long)
    acc = torch.zeros(B, dtype=torch.float32, device=hidden.device)
    for s0 in range(0, S, c):
        acc = acc + checkpoint(_ce_chunk, params, hidden[:, s0:s0 + c],
                               targets[:, s0:s0 + c],
                               use_reentrant=False, preserve_rng_state=False)
    return acc


def _rank_ce(params, cfg: ModelConfig, hidden, tokens, n_media, place):
    """Summed next-token NLL (B,) over the positions of the rank's
    stream block ``hidden`` (``place.positions()``) that predict a text
    token, summed over ``model`` (``place.loss_sum``); the head's weight
    gathered once. A block with no such position still runs its part of
    the graph, times 0, so every rank's backward calls the same
    collectives."""
    key = "embed" if "head" not in params else "head"
    hp = {key: place.leaf(params, key)}
    lo, hi = place.positions()
    a, b = max(lo, n_media), min(hi, n_media + tokens.shape[1] - 1)
    if b > a:
        tgt = tokens[:, a - n_media + 1:b - n_media + 1]
        nll = _chunked_ce(hp, cfg, hidden[:, a - lo:b - lo], tgt)
    else:
        nll = 0.0 * (_head(hp, hidden[:, :1]).float().sum((1, 2)))
    return place.loss_sum(nll)


def per_example_nll(params, cfg: ModelConfig, batch, place=None):
    """(mean next-token nll per example (B,), the MoE aux loss summed
    over layers (0.0 without MoE)) for masked distributed eval (C4).
    Only text positions count: with ``batch["media"]`` (B, n, d) the
    hidden states from n on predict the next token. On a mesh
    (``place``): the rank's rows, every position counted."""
    tokens = batch["tokens"]
    media = batch.get("media")
    hidden, aux = forward_hidden(params, cfg, tokens, media=media,
                                 place=place)
    n_media = 0 if media is None else media.shape[1]
    tgt = tokens[:, 1:]
    if place is None:
        nll_sum = _chunked_ce(params, cfg, hidden[:, n_media:-1], tgt)
    else:
        nll_sum = _rank_ce(params, cfg, hidden,
                           tokens.to(hidden.device, torch.long), n_media,
                           place)
    return nll_sum / tgt.shape[1], aux


def loss_fn(params, cfg: ModelConfig, batch, place=None):
    """Next-token cross entropy in fp32, plus ``cfg.moe.aux_loss_weight``
    times the MoE aux loss for a stack with MoE layers (``lm.py:281-
    290``). batch: {"tokens": (B, S) int, optional "media" (B, n, d)
    prepended}. Returns (loss, {"nll", "aux"}). On a mesh (``place``)
    both are the rank's share of the global batch's: its rows' sum over
    the global row count, and the (global) aux loss over the batch
    ranks, so the ranks' losses and gradients sum to the global ones."""
    nll_ex, aux = per_example_nll(params, cfg, batch, place)
    if place is None:
        nll, share = nll_ex.mean(), 1
    else:
        nll = nll_ex.sum() / (nll_ex.shape[0] * place.n_batch)
        share = place.n_batch
    total = nll + (cfg.moe.aux_loss_weight * aux / share if cfg.uses_moe
                   else 0.0)
    return total, {"nll": nll, "aux": aux}


def init_paged_cache(cfg: ModelConfig, n_pages: int, page: int, *,
                     device="cuda"):
    """Paged KV pools for every layer: ``kp``/``vp`` of shape
    (n_layers, n_pages + 1, page, K, hd), the last page the trash page,
    plus fp32 ``kp_scale``/``vp_scale`` for an int8/int4 pool
    (``layers.init_paged_kv_cache``). Attention-only stacks: a recurrent
    mixer carries per-slot state, not KV, and raises ``ValueError``
    (it serves from the slab, :func:`init_cache`)."""
    _check_supported(cfg)
    for spec in cfg.block_pattern:
        if spec.mixer != "attn":
            raise ValueError(
                f"paged KV cache requires an attention-only stack; "
                f"{cfg.name} has a {spec.mixer!r} mixer")
    return L.init_paged_kv_cache(cfg, n_pages, page, n_layers=cfg.n_layers,
                                 device=resolve_device(device))


def _serve_rows(place, *rows):
    """On a serving mesh (``place``) whose rank computes its rows of the
    batch: each (B, ...) input cut to them."""
    if place is None or place.rows is None:
        return rows
    return tuple(t[place.rows] if torch.is_tensor(t) and t.dim() else t
                 for t in rows)


def _out(params, x, place=None):
    """The head (logits) of x, on a mesh ``place.head``'s."""
    return _head(params, x) if place is None else place.head(params, x)


def _final(params, x, place=None):
    """The final norm of x."""
    final = (params["final_norm"] if place is None
             else place.leaf(params, "final_norm"))
    return L.apply_norm(final, x)


def decode_chunk(params, cfg: ModelConfig, tokens, cache, page_table, pos,
                 n_valid, *, window=None, full_logits=False, place=None):
    """C tokens per row against the paged cache: the serving engine's
    chunk program (chunked prefill and batched decode mixed).

    tokens: (B, C) ids, row b feeding ``n_valid[b]`` real tokens from
    absolute position ``pos[b]``; page_table: (B, max_pages) int32.
    Returns (logits of each row's last valid token (B, vocab), cache),
    or with ``full_logits`` the head over every position (B, C, vocab).
    The cache is updated in place.

    On a mesh (``place``, a ``dist.serving`` placement) ``params`` and
    the cache are the rank's blocks; when the rank computes its rows of
    the batch (``place.rows``) the inputs are the whole batch's and the
    logits its rows'.
    """
    ins = None
    if place is not None and place.rows is not None:
        ins = (page_table, pos, n_valid)
        tokens, page_table, pos, n_valid = _serve_rows(
            place, tokens, page_table, pos, n_valid)
    x, _ = _embed_inputs(params, tokens, None, place)
    for i, lp in enumerate(params["layers"]):
        if place is not None:
            lp = place.layer(lp, i)
        h = L.apply_norm(lp["norm1"], x)
        layer_cache = {name: pool[i] for name, pool in cache.items()}
        x = x + L.attention_decode_paged(
            lp["mixer"], h, cfg, layer_cache, page_table, pos, n_valid,
            window=window, place=place, ins=ins)
        x, _ = _ffn(cfg, _spec_of(cfg, i), lp, x, place)
    x = _final(params, x, place)
    if full_logits:
        return _out(params, x, place), cache
    return _out(params, L.gather_last(x, n_valid - 1), place)[:, 0], cache


def _ffn(cfg: ModelConfig, spec: LayerSpec, lp, x, place=None):
    """The layer's pre-norm dense or MoE FFN (if any) added to the
    residual stream x. Returns (x, the MoE aux loss or 0.0)."""
    if spec.ffn == "none":
        return x, 0.0
    h = L.apply_norm(lp["norm2"], x)
    if spec.ffn == "moe":
        y, aux = L.apply_moe(lp["ffn"], h, cfg, place=place)
        return x + y, aux
    return x + L.apply_ffn(lp["ffn"], h, cfg, place=place), 0.0


# ---- slab serving: cache, prefill, decode (``lm.py:296-471``) -------------- #
def _attn_cache_len(seq_len: int, window) -> int:
    return min(seq_len, window) if window else seq_len


def init_cache(cfg: ModelConfig, B: int, seq_len: int, window=None, *,
               device="cuda") -> List[Dict[str, torch.Tensor]]:
    """The slab decode cache: one dict per layer, batch on axis 0: an
    attention layer's K/V slab of ``min(seq_len, window)`` slots
    (``layers.init_kv_cache``), a Mamba layer's conv and SSM state
    (``layers.init_mamba_cache``), an RWKV-6 layer's token shift and wkv
    state (``layers.init_rwkv6_cache``)."""
    _check_supported(cfg)
    dev = resolve_device(device)
    L_attn = _attn_cache_len(seq_len, window)
    init = {"attn": lambda: L.init_kv_cache(cfg, B, L_attn, device=dev),
            "mamba": lambda: L.init_mamba_cache(cfg, B, device=dev),
            "rwkv6": lambda: L.init_rwkv6_cache(cfg, B, device=dev)}
    return [init[_spec_of(cfg, i).mixer]() for i in range(cfg.n_layers)]


def prefill(params, cfg: ModelConfig, tokens, *, media=None, cache_len=None,
            window=None, last_pos=None, place=None):
    """Forward over the prompt, building the slab decode cache.

    tokens: (B, S); ``media`` (B, n, d) prepended (a vision frontend).
    Returns (logits (B, vocab) at ``last_pos`` (B,) per row, an absolute
    position counting the media, or at n + S - 1 when None; the cache,
    one dict per layer). An attention layer's cache holds
    ``min(cache_len, window)`` slots (default n + S) with the last that
    many positions' K/V; a Mamba layer's holds its final conv inputs and
    SSM state, an RWKV-6 layer's its last token (in the compute dtype)
    and wkv state. Serving right-pads prompts of attention-only stacks
    to one length and reads each prompt's true last position (causality
    makes the positions up to it those of an unpadded prefill).

    On a mesh (``place``, a ``dist.serving`` placement) ``params`` are the
    rank's blocks; the cache holds every slot, and the rank's KV heads
    (every KV head when ``place.kv_whole``).
    """
    _check_supported(cfg)
    x, n_media = _embed_inputs(params, tokens, media, place)
    B, S, _ = x.shape
    L_attn = _attn_cache_len(cache_len or S, window)
    positions = _positions(cfg, B, S, x.device, n_media)
    caches = []
    for i, lp in enumerate(params["layers"]):
        spec = _spec_of(cfg, i)
        if place is not None:
            lp = place.layer(lp, i)
        x, _, state = _apply_block_full(cfg, spec, lp, x, positions, window,
                                        place)
        if spec.mixer == "attn":
            k, v = state
            caches.append(L.cache_from_prefill(cfg, k[:, -L_attn:],
                                               v[:, -L_attn:], L_attn))
        elif spec.mixer == "mamba":  # its state is its decode cache entry
            caches.append(state)
        else:
            wkv = state["wkv"]
            if place is not None and wkv.shape[1] < L._rwkv6_dims(cfg)[0]:
                wkv = place.heads_whole(wkv)  # the slab keeps every head
            caches.append({"shift": state["shift"].to(L.dtype_of(cfg.dtype)),
                           "wkv": wkv})
    x = _final(params, x, place)
    return _out(params, L.gather_last(x, last_pos), place)[:, 0], caches


def decode_step(params, cfg: ModelConfig, token, cache, pos, *, window=None,
                place=None):
    """One decode step for every row. token: (B, 1) ids; ``pos`` an int
    or (B,) absolute positions (each row an independent sequence at its
    own offset, continuous batching); cache: :func:`init_cache`'s list.
    Attention K/V are written into the cache in place; Mamba and RWKV-6
    states are replaced. Returns (logits (B, vocab), the cache).

    On a mesh (``place``, a ``dist.serving`` placement) ``params`` and the
    cache are the rank's blocks; when the rank computes its rows of the
    batch (``place.rows``) token and pos are the whole batch's and the
    logits its rows'."""
    token, pos = _serve_rows(place, token, pos)
    x, _ = _embed_inputs(params, token, None, place)
    for i, lp in enumerate(params["layers"]):
        spec = _spec_of(cfg, i)
        if place is not None:
            lp = place.layer(lp, i)
        h = L.apply_norm(lp["norm1"], x)
        if spec.mixer == "attn":
            y, cache[i] = L.attention_decode(lp["mixer"], h, cfg, cache[i],
                                             pos=pos, window=window,
                                             place=place)
        elif spec.mixer == "mamba":
            y, cache[i] = L.apply_mamba_step(lp["mixer"], h, cfg, cache[i],
                                             place=place)
        else:
            y, cache[i] = L.apply_rwkv6_step(lp["mixer"], h, cfg, cache[i],
                                             place=place)
        x, _ = _ffn(cfg, spec, lp, x + y, place)  # decode drops the aux loss
    x = _final(params, x, place)
    return _out(params, x, place)[:, 0], cache
