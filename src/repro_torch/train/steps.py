"""Train, eval and slab serving step factories (``repro.train.steps``)
for one device, and :class:`ModelAPI`, the family dispatch over the
decoder-only (``models.lm``) and encoder-decoder (``models.encdec``)
modules.

The reference's steps are pure functions that XLA compiles and shards;
here they run eagerly. ``train_step(state, batch)`` computes the loss
of the bf16 compute copy of the fp32 masters (C7), its gradient through
autograd (the attention and Mamba scan gradients through their backward
kernels on the card) in ``grad_dtype``, and applies the optimizer, which
updates ``state`` in place and returns it.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import encdec, lm
from repro_torch.optim import Optimizer, adam, compute_cast, cosine_warmup
from repro_torch.utils import tree_leaves

class ModelAPI:
    """One surface over the model families (the reference's
    ``ModelAPI``): ``models.encdec`` for an enc-dec config, else
    ``models.lm``. Enc-dec batches carry ``media`` (the encoder's
    frames) beside ``tokens``, a vision frontend's batches the patch
    embeddings that ``models.lm`` prepends to the text."""

    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        self._m = encdec if cfg.is_encdec else lm
        self.init = encdec.init_encdec if cfg.is_encdec else lm.init_lm

    def use_cast(self, params):
        """``lm.use_cast``: its rule walks either family's tree."""
        return lm.use_cast(params, self.cfg)

    def reference_tree(self, params):
        return self._m.reference_tree(params, self.cfg)

    def loss(self, params, batch):
        return self._m.loss_fn(params, self.cfg, batch)

    def per_example_nll(self, params, batch):
        return self._m.per_example_nll(params, self.cfg, batch)

    def prefill(self, params, batch, *, cache_len=None, window=None,
                last_pos=None):
        if self.cfg.is_encdec:
            return encdec.prefill(params, self.cfg, batch["media"],
                                  batch["tokens"], cache_len=cache_len,
                                  window=window, last_pos=last_pos)
        return lm.prefill(params, self.cfg, batch["tokens"],
                          media=batch.get("media"), cache_len=cache_len,
                          window=window, last_pos=last_pos)

    def decode(self, params, token, cache, pos, *, window=None):
        return self._m.decode_step(params, self.cfg, token, cache, pos,
                                   window=window)

    def init_cache(self, B, seq_len, window=None, *, device="cuda"):
        return self._m.init_cache(self.cfg, B, seq_len, window,
                                  device=device)

    # ---- paged serving (attention-only stacks) -------------------------- #
    def init_paged_cache(self, B, n_pages, page, *, device="cuda"):
        if self.cfg.is_encdec:
            return encdec.init_paged_cache(self.cfg, B, n_pages, page,
                                           device=device)
        return lm.init_paged_cache(self.cfg, n_pages, page, device=device)

    def decode_chunk(self, params, tokens, cache, page_table, pos, n_valid,
                     *, window=None, full_logits=False):
        return self._m.decode_chunk(params, self.cfg, tokens, cache,
                                    page_table, pos, n_valid, window=window,
                                    full_logits=full_logits)

    def encode_cross(self, params, frames):
        """Enc-dec only: the encoder and every layer's cross K/V."""
        return encdec.encode_cross(params, self.cfg, frames)


# Metric names make_train_step can add to its metrics dict
# (TrainerConfig.metrics).
EXTRA_METRICS = ("grad_norm", "param_norm")


def make_optimizer(cfg: ModelConfig, total_steps: int = 10_000) -> Optimizer:
    """Default optimizer: Adam with a cosine schedule (the paper's
    Transformer choice, with tuned betas for large batch)."""
    return adam(
        cosine_warmup(3e-4, min(1000, total_steps // 10), total_steps),
        b1=0.9, b2=0.95, eps=1e-8,
        moment_dtype=cfg.moment_dtype,
    )


def init_train_state(cfg: ModelConfig, optimizer: Optimizer, *, seed=0,
                     device="cuda", params=None) -> Dict:
    """{"params": fp32 masters, "opt": optimizer state}. ``params``
    takes a tree already on the device (e.g. the weight bridge's);
    otherwise the family's init (:class:`ModelAPI`) draws it from a
    seeded generator."""
    if params is None:
        params = ModelAPI(cfg).init(cfg, seed, device=device,
                                    dtype=getattr(torch, cfg.param_dtype))
    return {"params": params, "opt": optimizer.init(params)}


def _global_norm(leaves: Sequence[torch.Tensor]) -> torch.Tensor:
    """L2 norm over every leaf, in fp32."""
    return torch.sqrt(sum(g.float().square().sum() for g in leaves))


def _value_and_grad(cfg: ModelConfig, params, batch, acc):
    """(loss, nll) of the family's loss at the compute copy of ``params``;
    its gradient, in ``grad_dtype``, is added into ``acc`` (one entry a
    leaf; None: set) leaf by leaf as the backward pass finishes each.

    The gradient is taken at the compute copy's leaves. A master reaches
    the loss only through its cast, whose gradient is the copy's widened
    exactly, so the result in ``grad_dtype`` is bitwise the master's; but
    no fp32 gradient of the model, and no second gradient of it beside
    ``acc``, is ever held: each leaf's is folded into ``acc`` and freed."""
    gdt = getattr(torch, cfg.grad_dtype)
    with torch.no_grad():
        compute = compute_cast(params, cfg.dtype)
    leaves = tree_leaves(compute)

    def fold(i):
        def hook(w):
            g, w.grad = w.grad.to(gdt), None
            if acc[i] is None:
                acc[i] = g
            else:
                acc[i].add_(g)
        return hook

    handles = []
    try:
        for i, w in enumerate(leaves):
            w.requires_grad_(True)
            handles.append(w.register_post_accumulate_grad_hook(fold(i)))
        with torch.enable_grad():
            loss, metrics = ModelAPI(cfg).loss(compute, batch)
            loss.backward()
    finally:
        for h in handles:
            h.remove()
    missing = [i for i, g in enumerate(acc) if g is None]
    if missing:
        raise RuntimeError(f"leaves {missing} got no gradient: every "
                           f"parameter must reach the loss")
    return loss.detach(), metrics["nll"].detach()


def make_train_step(cfg: ModelConfig, optimizer: Optimizer,
                    extra_metrics=()) -> Callable:
    """``train_step(state, batch) -> (state, metrics)``; metrics are
    0-d device tensors {"loss", "nll"} plus any of ``EXTRA_METRICS``.
    With ``cfg.microbatches`` M > 1 the batch splits into M row blocks
    whose gradients are summed in ``grad_dtype`` and divided by M; a
    batch whose rows M does not divide raises ``ValueError``."""
    M = cfg.microbatches
    unknown = [m for m in extra_metrics if m not in EXTRA_METRICS]
    if unknown:
        raise ValueError(
            f"unknown extra metric(s) {unknown}; supported: {EXTRA_METRICS}")

    def train_step(state, batch):
        params, opt_state = state["params"], state["opt"]
        grads: List[Optional[torch.Tensor]] = [None] * len(
            tree_leaves(params))
        if M > 1:
            B = batch["tokens"].shape[0]
            if B % M:
                raise ValueError(
                    f"batch of {B} rows does not split into {M} "
                    f"microbatches")
            b = B // M
            losses, nlls = [], []
            for i in range(M):
                mb = {k: v[i * b:(i + 1) * b] for k, v in batch.items()}
                mb_loss, nll = _value_and_grad(cfg, params, mb, grads)
                losses.append(mb_loss)
                nlls.append(nll)
            for g in grads:
                g.div_(M)
            loss = sum(losses) / M  # summed in order, as the reference
            nll = torch.stack(nlls).mean()
        else:
            loss, nll = _value_and_grad(cfg, params, batch, grads)
        metrics = {"loss": loss, "nll": nll}
        if "grad_norm" in extra_metrics:
            metrics["grad_norm"] = _global_norm(grads)
        new_params, new_opt = optimizer.update(grads, opt_state, params)
        if "param_norm" in extra_metrics:
            metrics["param_norm"] = _global_norm(tree_leaves(new_params))
        return {"params": new_params, "opt": new_opt}, metrics

    return train_step


def make_eval_step(cfg: ModelConfig) -> Callable:
    """Distributed eval (C4): ``eval_step(params, batch, mask)`` returns
    (sum of per-example nll over real examples, their count). As in the
    reference, whose eval step runs no ``compute_cast``, the fp32 leaves
    the layers read in fp32 stay unrounded (``lm.use_cast``)."""
    api = ModelAPI(cfg)

    @torch.no_grad()
    def eval_step(params, batch, mask):
        nll_ex, _ = api.per_example_nll(api.use_cast(params), batch)
        mask = mask.to(nll_ex.device)
        return (nll_ex * mask).sum(), mask.sum()

    return eval_step


def make_serve_prefill_step(cfg: ModelConfig, *, cache_len: int,
                            window=None) -> Callable:
    """``prefill_step(params, batch, last_pos)``: (logits at each row's
    true last prompt position ``last_pos`` (B,), slab cache of
    ``cache_len`` slots; an enc-dec batch's ``media`` is encoded into
    the cross caches). Padded positions' K/V stay in the cache; the
    engine masks them with ``serve.cache.invalidate_beyond``."""
    api = ModelAPI(cfg)

    def prefill_step(params, batch, last_pos):
        return api.prefill(params, batch, cache_len=cache_len, window=window,
                           last_pos=last_pos)

    return prefill_step


def make_serve_decode_step(cfg: ModelConfig, *, window=None) -> Callable:
    """``decode_step(params, token, cache, pos)``: one token for every
    slot, ``pos`` (B,) one absolute offset per slot."""
    api = ModelAPI(cfg)

    def decode_step(params, token, cache, pos):
        return api.decode(params, token, cache, pos, window=window)

    return decode_step
