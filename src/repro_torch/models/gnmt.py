"""GNMT (``repro.models.gnmt``, paper section 3): an LSTM encoder-decoder
with the paper's RNN-loop restructuring (C9).

C9: an LSTM step depends on the previous step only through its hidden
state, so the input projection x_t . W_x is hoisted out of the time loop
and computed for all steps as one batched product; the loop body is then
the fused cell (``kernels.ops.lstm_cell``: the CUDA kernels on the card).
``hoist_input_projection=False`` keeps the per-step projection as the
baseline.

Structure and dtypes are the reference's: a bidirectional first encoder
layer, residual uni layers from the third on, a decoder whose layers take
[input, attention context]; ``w_x`` and ``w_h`` cast to the compute dtype,
``b`` and the cell state ``c`` in fp32, ``h`` in the compute dtype; the
decoder's dot attention and the head product in fp32, the context cast
back. fp32 products run in full fp32 as long as TF32 stays off
(``torch.backends.cuda.matmul.allow_tf32 = False``, PyTorch's default).
Parameters are a dict of fp32 masters with the reference's names.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.kernels import ops
from repro_torch.models.scan_utils import chunked_scan
from repro_torch.utils import tree_map

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclasses.dataclass(frozen=True)
class GNMTConfig:
    name: str = "gnmt"
    vocab: int = 32000
    d_model: int = 1024          # LSTM feature size F
    n_enc_layers: int = 4        # first is bidirectional
    n_dec_layers: int = 4
    dtype: str = "bfloat16"
    hoist_input_projection: bool = True  # the C9 optimization


GNMT_TINY = GNMTConfig(name="gnmt_tiny", vocab=512, d_model=64,
                       n_enc_layers=2, n_dec_layers=2)


def _dt(cfg: GNMTConfig) -> torch.dtype:
    if cfg.dtype not in _DTYPES:
        raise ValueError(f"unknown dtype {cfg.dtype!r}; known: "
                         f"{sorted(_DTYPES)}")
    return _DTYPES[cfg.dtype]


def init_gnmt(cfg: GNMTConfig, seed: int = 0, *,
              device="cuda") -> Dict[str, Any]:
    """Random fp32 weights with the reference's names and scales
    (``gnmt.py:40-73``), drawn in its order from a ``torch.Generator``
    seeded with ``seed`` on ``device``: ``embed`` (V, F) and ``head``
    (F, V) normal times F^-0.5; per LSTM layer ``w_x`` (in, 4F) times
    in^-0.5, ``w_h`` (F, 4F) times F^-0.5, ``b`` (4F,) zeros. The numbers
    differ from ``jax.random``'s; parity tests copy JAX weights in with
    :func:`params_from_numpy`."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    F = cfg.d_model

    def normal(shape, scale):
        return torch.randn(shape, generator=gen, device=dev).mul_(scale)

    def lstm(in_dim):
        return {"w_x": normal((in_dim, 4 * F), in_dim ** -0.5),
                "w_h": normal((F, 4 * F), F ** -0.5),
                "b": torch.zeros(4 * F, device=dev)}

    params = {"embed": normal((cfg.vocab, F), F ** -0.5),
              "enc_fwd0": lstm(F), "enc_bwd0": lstm(F)}
    in_dim = 2 * F
    for i in range(1, cfg.n_enc_layers):
        params[f"enc{i}"] = lstm(in_dim)
        in_dim = F
    for i in range(cfg.n_dec_layers):  # dec0: [emb, ctx]; others [h, ctx]
        params[f"dec{i}"] = lstm(2 * F)
    params["head"] = normal((F, cfg.vocab), F ** -0.5)
    return params


def params_from_numpy(tree, device="cuda") -> Dict[str, Any]:
    """The weight bridge: the reference's parameter tree as numpy arrays
    (``split_tree(init_gnmt(cfg, key))[0]``) to the port's fp32 masters
    on ``device``, names and layouts unchanged."""
    dev = resolve_device(device)
    return tree_map(
        lambda a: torch.tensor(np.asarray(a, np.float32)).to(dev), tree)


def _embed(params, tokens, dt):
    emb = params["embed"]
    return emb[tokens.to(emb.device, torch.long)].to(dt)


def lstm_layer(prm, x, cfg: GNMTConfig, *, reverse: bool = False):
    """One LSTM layer over x (B, S, in) -> (B, S, F).

    Hoisted (C9): x . W_x is one (S*B, in) x (in, 4F) product before the
    loop, time-major so that each step's (B, 4F) slice is contiguous; the
    loop runs only the cell. In-loop: the projection runs at every step.
    """
    dt = _dt(cfg)
    w_x = prm["w_x"].to(dt)
    w_h = prm["w_h"].to(dt)
    b = prm["b"]
    B, S, _ = x.shape
    F = w_h.shape[0]
    xs = (x.flip(1) if reverse else x).transpose(0, 1).to(dt)  # (S, B, in)

    if cfg.hoist_input_projection:
        xs_scan = xs @ w_x  # hoisted: (S, B, 4F)

        def step(carry, xp_t):
            h, c = carry
            h2, c2 = ops.lstm_cell(xp_t, h, c, w_h, b)
            return (h2, c2), h2
    else:
        xs_scan = xs.contiguous()

        def step(carry, x_t):
            h, c = carry
            h2, c2 = ops.lstm_cell(x_t @ w_x, h, c, w_h, b)  # in-loop
            return (h2, c2), h2

    h0 = torch.zeros((B, F), dtype=dt, device=x.device)
    c0 = torch.zeros((B, F), dtype=torch.float32, device=x.device)
    _, hs = chunked_scan(step, (h0, c0), xs_scan, chunk=64)
    out = hs.transpose(0, 1)
    return out.flip(1) if reverse else out


def encode(params, cfg: GNMTConfig, src_tokens):
    """src (B, S) int -> (B, S, F) in the compute dtype."""
    x = _embed(params, src_tokens, _dt(cfg))
    fwd = lstm_layer(params["enc_fwd0"], x, cfg)
    bwd = lstm_layer(params["enc_bwd0"], x, cfg, reverse=True)
    h = torch.cat([fwd, bwd], dim=-1)
    for i in range(1, cfg.n_enc_layers):
        y = lstm_layer(params[f"enc{i}"], h, cfg)
        h = y if i == 1 else h + y  # residual from layer 2 on (GNMT)
    return h


def decode_train(params, cfg: GNMTConfig, enc_out, tgt_tokens):
    """Teacher-forced decoder with per-step dot attention over the
    encoder outputs; returns fp32 logits (B, S, V). The encoder outputs
    are widened to fp32 once, before the loop (the reference widens them
    inside each step: the same values)."""
    dt = _dt(cfg)
    B, S = tgt_tokens.shape
    F = cfg.d_model
    emb = _embed(params, tgt_tokens, dt)
    enc = enc_out.to(dt).float()
    scale = F ** -0.5

    def weights(name):
        p = params[name]
        return p["w_x"].to(dt), p["w_h"].to(dt), p["b"]

    w0x, w0h, b0 = weights("dec0")
    layer_ws = [weights(f"dec{i}") for i in range(1, cfg.n_dec_layers)]

    def step(carry, emb_t):
        states, ctx = carry
        x0 = torch.cat([emb_t, ctx], dim=-1)
        h, c = ops.lstm_cell(x0 @ w0x, *states[0], w0h, b0)
        new_states = [(h, c)]
        scores = torch.einsum("bf,bsf->bs", h.float(), enc) * scale
        alpha = torch.softmax(scores, dim=-1)
        ctx_new = torch.einsum("bs,bsf->bf", alpha, enc).to(dt)
        y = h
        for li, (wx, wh, bb) in enumerate(layer_ws):
            inp = torch.cat([y, ctx_new], dim=-1)
            h2, c2 = ops.lstm_cell(inp @ wx, *states[li + 1], wh, bb)
            new_states.append((h2, c2))
            y = h2 if li == 0 else y + h2  # residual
        return (new_states, ctx_new), y

    dev = enc.device
    init_states = [(torch.zeros((B, F), dtype=dt, device=dev),
                    torch.zeros((B, F), dtype=torch.float32, device=dev))
                   for _ in range(cfg.n_dec_layers)]
    ctx0 = torch.zeros((B, F), dtype=dt, device=dev)
    _, ys = chunked_scan(step, (init_states, ctx0),
                         emb.transpose(0, 1).contiguous(), chunk=32)
    out = ys.transpose(0, 1)  # (B, S, F)
    return out.float() @ params["head"].float()


def _token_nll(params, cfg: GNMTConfig, batch):
    """Per-position nll (B, S - 1) of predicting tgt[:, 1:]."""
    enc = encode(params, cfg, batch["src"])
    logits = decode_train(params, cfg, enc, batch["tgt"])
    tgt = batch["tgt"][:, 1:].to(logits.device, torch.long)
    lg = logits[:, :-1]
    logz = torch.logsumexp(lg, dim=-1)
    gold = torch.gather(lg, -1, tgt[..., None])[..., 0]
    return logz - gold


def loss_fn(params, cfg: GNMTConfig, batch) -> Tuple[torch.Tensor, Dict]:
    """batch: {"src": (B, Ss) int, "tgt": (B, St) int, optional
    "tgt_mask": (B, St) 1.0 = real token (bucketized batches pad)}.
    Returns (mean nll over the masked target positions, {"nll": it})."""
    nll_tok = _token_nll(params, cfg, batch)
    mask = batch.get("tgt_mask")
    mask = (torch.ones_like(nll_tok) if mask is None
            else mask[:, 1:].to(nll_tok.device, torch.float32))
    nll = (nll_tok * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll, {"nll": nll}


def per_example_nll(params, cfg: GNMTConfig, batch):
    """(mean nll of each example over its positions, unmasked; 0)."""
    nll_tok = _token_nll(params, cfg, batch)
    return nll_tok.mean(dim=-1), torch.zeros((), device=nll_tok.device)
