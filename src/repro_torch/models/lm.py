"""Decoder-only LM (``repro.models.lm``): weights, embedding, tied
head, the full-sequence forward and chunked loss of the train step, the
paged cache and the serving chunk program.

The reference stacks layer weights on a leading axis and scans over
them; here ``params["layers"]`` is a list walked by a Python loop.

Stored dtype: the reference keeps fp32 master weights and casts them to
the compute dtype (bf16) at every use. Serving never updates weights,
so the port stores them in the compute dtype once; training keeps fp32
masters (``init_lm(dtype=torch.float32)``) and casts them once per step
(``optim.precision.compute_cast``). Either way the layers receive
weights already in the compute dtype, and the values the matrix
products see are the reference's.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.utils import tree_map


def _check_supported(cfg: ModelConfig) -> None:
    if (not cfg.tie_embeddings
            or any((s.mixer, s.ffn) != ("attn", "dense")
                   for s in cfg.block_pattern)):
        raise NotImplementedError(
            f"{cfg.name}: the port runs dense attention stacks with "
            f"tied embeddings (gemma-7b) only")


def init_lm(cfg: ModelConfig, seed: int = 0, *, device="cuda",
            dtype=None) -> Dict[str, Any]:
    """Random weights with the reference's scales (``lm.py:62``,
    ``layers.py:101``, ``layers.py:516``), made on ``device`` from a
    ``torch.Generator`` seeded with ``seed``: normal(0, 1) times
    d^-0.5 for the embedding and the q/k/v/up/gate projections,
    (H*hd)^-0.5 for ``wo``, d_ff^-0.5 for ``wd``; norm scales are ones.
    The numbers differ from ``jax.random``'s; parity tests copy JAX
    weights in with :func:`params_from_numpy` instead."""
    _check_supported(cfg)
    dev = resolve_device(device)
    dt = dtype or L.dtype_of(cfg.dtype)
    gen = torch.Generator(device=dev).manual_seed(seed)
    d, H, K, hd, f = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                      cfg.head_dim, cfg.d_ff)

    def normal(shape, scale):
        w = torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)
        return w.mul_(scale).to(dt)

    def ones():
        return {"scale": torch.ones(d, device=dev, dtype=dt)}

    params = {"embed": normal((cfg.vocab, d), d ** -0.5), "layers": []}
    for _ in range(cfg.n_layers):
        params["layers"].append({
            "norm1": ones(),
            "mixer": {"wq": normal((d, H, hd), d ** -0.5),
                      "wk": normal((d, K, hd), d ** -0.5),
                      "wv": normal((d, K, hd), d ** -0.5),
                      "wo": normal((H, hd, d), (H * hd) ** -0.5)},
            "norm2": ones(),
            "ffn": {"wu": normal((d, f), d ** -0.5),
                    "wg": normal((d, f), d ** -0.5),
                    "wd": normal((f, d), f ** -0.5)},
        })
    params["final_norm"] = ones()
    return params


def params_from_numpy(tree, cfg: ModelConfig, device="cuda",
                      dtype=None) -> Dict[str, Any]:
    """The weight bridge: the reference's parameter tree, as numpy
    arrays (``split_tree(ModelAPI(cfg).init(cfg, key))[0]``), to the
    port's parameters on ``device`` in ``dtype`` (default: the config's
    compute dtype).

    The tree keeps the reference's names and layouts: ``embed`` (V, d);
    ``blocks[0]`` stacked over ``n_blocks`` with ``norm1``/``norm2``
    ``scale``, ``mixer`` ``wq`` (d, H, hd), ``wk``/``wv`` (d, K, hd),
    ``wo`` (H, hd, d) and ``ffn`` ``wu``/``wg`` (d, f), ``wd`` (f, d);
    ``final_norm`` ``scale``. Arrays are taken as fp32, then cast.
    """
    _check_supported(cfg)
    dev = resolve_device(device)
    dt = dtype or L.dtype_of(cfg.dtype)

    def conv(a):
        return torch.tensor(np.asarray(a, np.float32)).to(dev, dt)

    (stacked,) = tree["blocks"]
    return {
        "embed": conv(tree["embed"]),
        "layers": [tree_map(lambda a, i=i: conv(np.asarray(a)[i]), stacked)
                   for i in range(cfg.n_layers)],
        "final_norm": tree_map(conv, tree["final_norm"]),
    }


def _embed(params, tokens):
    return params["embed"][tokens.to(params["embed"].device, torch.long)]


def _head(params, x):
    """Tied output projection: x (B, S, d) @ embed^T -> (B, S, vocab)."""
    return x @ params["embed"].T


def _positions(B: int, S: int, device):
    """RoPE positions 0..S-1 for every row, (B, S)."""
    return torch.arange(S, device=device).expand(B, S)


def _apply_block_full(cfg: ModelConfig, lp, x, positions, window=None):
    """One decoder layer over the full sequence: pre-norm attention,
    then the pre-norm dense FFN, each added to the residual stream."""
    h = L.apply_norm(lp["norm1"], x)
    y, _ = L.attention_full(lp["mixer"], h, cfg, positions=positions,
                            window=window)
    x = x + y
    h = L.apply_norm(lp["norm2"], x)
    return x + L.apply_ffn(lp["ffn"], h, cfg)


def forward_hidden(params, cfg: ModelConfig, tokens, *, window=None):
    """Full-sequence forward up to the final norm (no output projection).

    tokens: (B, S). Returns hidden (B, S, d). With ``cfg.remat`` each
    layer runs under ``torch.utils.checkpoint`` (non-reentrant): only
    its input is kept, and the backward recomputes the layer, as the
    reference's ``jax.checkpoint`` over the scanned block does.
    """
    x = _embed(params, tokens)
    B, S, _ = x.shape
    positions = _positions(B, S, x.device)
    for lp in params["layers"]:
        if cfg.remat:
            # Nothing random runs inside a layer: no RNG state to stash.
            x = checkpoint(_apply_block_full, cfg, lp, x, positions, window,
                           use_reentrant=False, preserve_rng_state=False)
        else:
            x = _apply_block_full(cfg, lp, x, positions, window)
    return L.apply_norm(params["final_norm"], x)


def forward(params, cfg: ModelConfig, tokens, *, window=None):
    """Full-sequence forward. Returns logits (B, S, vocab)."""
    return _head(params, forward_hidden(params, cfg, tokens, window=window))


def _ce_chunk(params, h, targets):
    """Summed next-token NLL of one chunk: (B, c, d), (B, c) -> (B,),
    from fp32 logits of the tied head."""
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


def per_example_nll(params, cfg: ModelConfig, batch):
    """(mean next-token nll per example (B,), aux 0.0) for masked
    distributed eval (C4)."""
    _check_supported(cfg)
    tokens = batch["tokens"]
    hidden = forward_hidden(params, cfg, tokens)
    tgt = tokens[:, 1:]
    nll_sum = _chunked_ce(params, cfg, hidden[:, :-1], tgt)
    return nll_sum / tgt.shape[1], 0.0


def loss_fn(params, cfg: ModelConfig, batch):
    """Next-token cross entropy in fp32 (no MoE aux term in a dense
    stack). batch: {"tokens": (B, S) int}. Returns (loss, {"nll",
    "aux"})."""
    nll_ex, aux = per_example_nll(params, cfg, batch)
    nll = nll_ex.mean()
    return nll, {"nll": nll, "aux": aux}


def init_paged_cache(cfg: ModelConfig, n_pages: int, page: int, *,
                     device="cuda"):
    """Paged KV pools for every layer: ``kp``/``vp`` of shape
    (n_layers, n_pages + 1, page, K, hd), the last page the trash page,
    plus fp32 ``kp_scale``/``vp_scale`` for an int8/int4 pool
    (``layers.init_paged_kv_cache``)."""
    _check_supported(cfg)
    return L.init_paged_kv_cache(cfg, n_pages, page, n_layers=cfg.n_layers,
                                 device=resolve_device(device))


def decode_chunk(params, cfg: ModelConfig, tokens, cache, page_table, pos,
                 n_valid, *, window=None, full_logits=False):
    """C tokens per row against the paged cache: the serving engine's
    chunk program (chunked prefill and batched decode mixed).

    tokens: (B, C) ids, row b feeding ``n_valid[b]`` real tokens from
    absolute position ``pos[b]``; page_table: (B, max_pages) int32.
    Returns (logits of each row's last valid token (B, vocab), cache),
    or with ``full_logits`` the head over every position (B, C, vocab).
    The cache is updated in place.
    """
    x = _embed(params, tokens)
    for i, lp in enumerate(params["layers"]):
        h = L.apply_norm(lp["norm1"], x)
        layer_cache = {name: pool[i] for name, pool in cache.items()}
        x = x + L.attention_decode_paged(
            lp["mixer"], h, cfg, layer_cache, page_table, pos, n_valid,
            window=window)
        h = L.apply_norm(lp["norm2"], x)
        x = x + L.apply_ffn(lp["ffn"], h, cfg)
    x = L.apply_norm(params["final_norm"], x)
    if full_logits:
        return _head(params, x), cache
    return _head(params, L.gather_last(x, n_valid - 1))[:, 0], cache
