"""The MLPerf-0.6 Transformer (``repro.models.transformer_mlperf``,
paper section 3): the Vaswani encoder-decoder on WMT EN-DE, a *token*
encoder over the enc-dec blocks of :mod:`repro_torch.models.encdec`,
with one embedding shared by the source, the target and the output head.
The paper's trick of truncating the sequence length to 97, the longest
eval sentence, is the batch's length (``launch/mlperf.py --seq``).

The arithmetic is the reference's:

- a token's embedding is read from the fp32 table, cast to the compute
  dtype and multiplied by ``d_model ** 0.5`` in that dtype (the scalar
  rounded to it first, as JAX's weak typing does), then the sinusoid
  positions are added in it;
- the encoder layers are ``encdec._enc_block`` (non-causal), the decoder
  layers ``encdec._dec_block_full`` (causal self-attention,
  cross-attention over the encoder output, the ReLU FFN), each pre-norm
  (LayerNorm); their attention goes through ``kernels/ops.py:attention``,
  the flash kernels on the card. With ``cfg.remat`` each layer runs
  under ``torch.utils.checkpoint``;
- the head is ``x @ embed.to(dt).T``; the logits stay in the compute
  dtype, and the loss takes an fp32 log-sum-exp over ``logits[:, :-1]``,
  masks pad targets (id 0) and divides by ``max(mask.sum(), 1)``.

Weights are fp32 masters, and :func:`forward` reads them as the
reference's train step does (``benchmarks/fig9_step_times.py`` takes
the gradient of the fp32 tree with no compute cast): each layer's
matrices in the compute dtype and its norm leaves in fp32
(``lm.use_cast``), and the embedding from the fp32 table at each of its
three uses, so that its gradient is the fp32 sum of three cotangents and
the gather's transpose runs in fp32.

The tree is the enc-dec tree with a tied head (``embed``,
``enc_blocks``, ``enc_norm``, ``dec_blocks``, ``dec_norm``; no
``head``): :func:`init_transformer` is ``encdec.init_encdec`` in fp32,
and ``encdec.params_from_numpy`` is its weight bridge. The configs are
the reference's, field for field (``param_sharding`` "wus" included).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import encdec
from repro_torch.models import layers as L
from repro_torch.models import lm
from repro_torch.utils import count_params

# MLPerf Transformer "big" (the benchmark config) and a CPU-size variant.
TRANSFORMER_BIG = ModelConfig(
    name="transformer_mlperf_big", family="audio",  # enc-dec plumbing
    n_layers=6, n_enc_layers=6, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=4096, vocab=33708, norm="layernorm", activation="relu", glu=False,
    rope="none", tie_embeddings=True, enc_source_len=97,
    param_sharding="wus",
)
TRANSFORMER_TINY = dataclasses.replace(
    TRANSFORMER_BIG, name="transformer_mlperf_tiny", n_layers=2,
    n_enc_layers=2, d_model=128, n_heads=4, n_kv_heads=4, d_ff=256,
    vocab=512, enc_source_len=32, remat=False,
)


def init_transformer(cfg: ModelConfig, seed: int = 0, *,
                     device="cuda") -> Dict[str, Any]:
    """fp32 masters with the reference's names, shapes and distributions
    (``transformer_mlperf.py:41-53``: the enc-dec tree, no ``head``),
    drawn from a ``torch.Generator`` seeded with ``seed``."""
    return encdec.init_encdec(cfg, seed, device=device, dtype=torch.float32)


def param_count(cfg: ModelConfig) -> int:
    """The tree's parameters, from its shapes (nothing allocated)."""
    return count_params(lambda: init_transformer(cfg, device="cpu"))


def use_values(params, cfg: ModelConfig) -> Dict[str, Any]:
    """The values the reference's layers read from the fp32 masters:
    ``lm.use_cast`` (matrices in the compute dtype, norm leaves fp32),
    the embedding left fp32, to be cast at each use."""
    vals = lm.use_cast(params, cfg)
    vals["embed"] = params["embed"]
    return vals


def _scaled_embedding(vals, cfg: ModelConfig, tokens):
    """Tokens (B, S) -> (B, S, d): the fp32 table's rows cast to the
    compute dtype, times ``d_model ** 0.5`` rounded to that dtype."""
    dt = L.dtype_of(cfg.dtype)
    scale = torch.tensor(cfg.d_model ** 0.5).to(dt).item()
    return lm._embed(vals, tokens).to(dt) * scale


def encode(params, cfg: ModelConfig, src_tokens, *, values=None):
    """Source tokens (B, Ss) -> encoder output (B, Ss, d) in the compute
    dtype (``transformer_mlperf.py:56-82``; ``encdec.encode`` adds the
    positions). ``values``: the tree as :func:`use_values` reads it, when
    the caller has it already."""
    vals = use_values(params, cfg) if values is None else values
    return encdec.encode(vals, cfg, _scaled_embedding(vals, cfg, src_tokens))


def forward(params, cfg: ModelConfig, src_tokens, tgt_tokens):
    """Teacher-forced logits (B, St, vocab) in the compute dtype
    (``transformer_mlperf.py:85-102``)."""
    vals = use_values(params, cfg)
    enc_out = encode(params, cfg, src_tokens, values=vals)
    dt = L.dtype_of(cfg.dtype)
    B, S = tgt_tokens.shape
    x = _scaled_embedding(vals, cfg, tgt_tokens)
    x = x + encdec.sinusoid(S, cfg.d_model, dt, x.device)
    positions = encdec._positions(B, S, x.device)
    for bp in vals["dec_blocks"]:
        if cfg.remat:
            x = checkpoint(encdec._dec_layer_out, cfg, bp, x, enc_out,
                           positions, use_reentrant=False,
                           preserve_rng_state=False)
        else:
            x = encdec._dec_layer_out(cfg, bp, x, enc_out, positions)
    x = L.apply_norm(vals["dec_norm"], x)
    return x @ vals["embed"].to(dt).T


def loss_fn(params, cfg: ModelConfig, batch):
    """batch: {"src": (B, Ss), "tgt": (B, St)} token ids, 0 = pad.
    Masked next-token cross entropy in fp32, divided by the count of
    real targets (at least 1). Returns (loss, {"nll"})."""
    logits = forward(params, cfg, batch["src"], batch["tgt"])
    tgt = batch["tgt"][:, 1:].to(logits.device, torch.long)
    mask = (tgt != 0).float()
    lg = logits[:, :-1].float()
    logz = torch.logsumexp(lg, dim=-1)
    gold = torch.gather(lg, -1, tgt[..., None])[..., 0]
    nll = ((logz - gold) * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll, {"nll": nll}
