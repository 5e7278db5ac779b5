"""Stand-ins for every model input (``repro.launch.specs``): trees of
fake tensors, made under a ``FakeTensorMode`` that the caller owns, in
place of the reference's ``jax.ShapeDtypeStruct``s. They have the shapes
and dtypes of the real inputs and allocate nothing; the dry run
(``launch.dryrun``) traces the train, prefill and decode steps on them.
Called outside such a mode they make real (zero) tensors.

Token ids are int32, as the port's batches and engine carry them; media
embeddings fp32, as the reference's. ``demo_batch`` makes a real batch of
the same structure from an explicit ``torch.Generator``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import InputShape, ModelConfig

TOKEN_DTYPE = torch.int32


def batch_structure(cfg: ModelConfig, shape: InputShape, *,
                    device="cpu") -> Dict[str, Any]:
    """The train / prefill batch: tokens, and a frontend's media."""
    B, S = shape.global_batch, shape.seq_len
    out = {}
    if cfg.frontend == "vision_patches":
        n_media = min(cfg.n_media_tokens, S // 2)
        out["tokens"] = torch.zeros((B, S - n_media), dtype=TOKEN_DTYPE,
                                    device=device)
        out["media"] = torch.zeros((B, n_media, cfg.d_model),
                                   dtype=torch.float32, device=device)
    elif cfg.frontend == "audio_frames":
        out["tokens"] = torch.zeros((B, S), dtype=TOKEN_DTYPE, device=device)
        out["media"] = torch.zeros((B, cfg.enc_source_len, cfg.d_model),
                                   dtype=torch.float32, device=device)
    else:
        out["tokens"] = torch.zeros((B, S), dtype=TOKEN_DTYPE, device=device)
    return out


def decode_structure(cfg: ModelConfig, shape: InputShape, *,
                     device="cpu") -> Dict[str, Any]:
    """The decode step's inputs but the cache (:func:`cache_structure`):
    one token a row and the step's position."""
    B = shape.global_batch
    return {"token": torch.zeros((B, 1), dtype=TOKEN_DTYPE, device=device),
            "pos": torch.zeros((), dtype=TOKEN_DTYPE, device=device)}


def cache_structure(cfg: ModelConfig, shape: InputShape, *, device="cpu"):
    """The decode cache: the family's real ``init_cache`` at the shape's
    batch, length and window."""
    from repro_torch.train.steps import ModelAPI

    return ModelAPI(cfg).init_cache(shape.global_batch, shape.seq_len,
                                    cfg.effective_window(shape),
                                    device=device)


def input_specs(cfg: ModelConfig, shape: InputShape, *,
                device="cpu") -> Dict[str, Any]:
    """Every input of the step that ``shape.kind`` implies."""
    if shape.kind in ("train", "prefill"):
        return {"batch": batch_structure(cfg, shape, device=device)}
    specs = decode_structure(cfg, shape, device=device)
    return {"token": specs["token"], "pos": specs["pos"],
            "cache": cache_structure(cfg, shape, device=device)}


def demo_batch(cfg: ModelConfig, shape: InputShape,
               generator: Optional[torch.Generator] = None, *,
               device="cpu") -> Dict[str, torch.Tensor]:
    """A real batch of :func:`batch_structure`'s shapes: uniform token
    ids and standard-normal media, drawn from ``generator`` (a CPU
    generator seeded 0 when None)."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    structure = batch_structure(cfg, shape, device="meta")
    out = {"tokens": torch.randint(0, cfg.vocab, structure["tokens"].shape,
                                   generator=generator,
                                   dtype=TOKEN_DTYPE).to(device)}
    if "media" in structure:
        out["media"] = torch.randn(structure["media"].shape,
                                   generator=generator).to(device)
    return out
