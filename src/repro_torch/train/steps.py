"""Train, eval and slab serving step factories (``repro.train.steps``),
the sharding specs of the train state, batches and caches, and
:class:`ModelAPI`, the family dispatch over the decoder-only
(``models.lm``) and encoder-decoder (``models.encdec``) modules.

The reference's steps are pure functions that XLA compiles and shards;
here they run eagerly. ``train_step(state, batch)`` computes the loss
of the bf16 compute copy of the fp32 masters (C7), its gradient through
autograd (the attention and Mamba scan gradients through their backward
kernels on the card) in ``grad_dtype``, and applies the optimizer, which
updates ``state`` in place and returns it. Given a ``dist.spmd.Plan``
the same step runs on a mesh: the state holds the rank's blocks, the
batch the rank's rows, and the step adds the plan's gradient reductions
and global metrics (:mod:`repro_torch.dist.spmd`).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.dist.context import use_rules
from repro_torch.dist.sharding import Rules, opt_state_specs, param_specs
from repro_torch.dist.spmd import Placement
from repro_torch.dist.tagging import Axes
from repro_torch.models import encdec, lm
from repro_torch.optim import Optimizer, adam, compute_cast, cosine_warmup
from repro_torch.utils import tree_leaves, tree_map, tree_unflatten

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

    def param_axes(self):
        """The logical axes of the family's parameter tree."""
        return self._m.param_axes(self.cfg)

    def use_cast(self, params):
        """``lm.use_cast``: its rule walks either family's tree."""
        return lm.use_cast(params, self.cfg)

    def reference_tree(self, params):
        return self._m.reference_tree(params, self.cfg)

    def loss(self, params, batch, place=None):
        if place is None:
            return self._m.loss_fn(params, self.cfg, batch)
        return self._m.loss_fn(params, self.cfg, batch, place)

    def per_example_nll(self, params, batch, place=None):
        if place is None:
            return self._m.per_example_nll(params, self.cfg, batch)
        return self._m.per_example_nll(params, self.cfg, batch, place)

    # ``place``: a ``dist.serving`` placement on a mesh (the decoder-only
    # family; an enc-dec config does not serve on a mesh).
    def prefill(self, params, batch, *, cache_len=None, window=None,
                last_pos=None, place=None):
        if self.cfg.is_encdec:
            return encdec.prefill(params, self.cfg, batch["media"],
                                  batch["tokens"], cache_len=cache_len,
                                  window=window, last_pos=last_pos)
        return lm.prefill(params, self.cfg, batch["tokens"],
                          media=batch.get("media"), cache_len=cache_len,
                          window=window, last_pos=last_pos, place=place)

    def decode(self, params, token, cache, pos, *, window=None, place=None):
        if place is None:
            return self._m.decode_step(params, self.cfg, token, cache, pos,
                                       window=window)
        return lm.decode_step(params, self.cfg, token, cache, pos,
                              window=window, place=place)

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
                     *, window=None, full_logits=False, place=None):
        if place is None:
            return self._m.decode_chunk(params, self.cfg, tokens, cache,
                                        page_table, pos, n_valid,
                                        window=window,
                                        full_logits=full_logits)
        return lm.decode_chunk(params, self.cfg, tokens, cache, page_table,
                               pos, n_valid, window=window,
                               full_logits=full_logits, place=place)

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


# ---- specs (``steps.py:121-194``) ----------------------------------------- #
# A spec is a tuple with one entry a dimension: the mesh axes that dim is
# split over, or None (``dist.sharding``). Per-layer trees carry no
# ``layer`` entry: the reference's specs of a stacked leaf without their
# first entry.
def train_state_specs(cfg: ModelConfig, state_shapes, axes, rules: Rules):
    """Spec tree matching {"params", "opt"}: the weights by
    ``param_specs``, each moment tree by ``opt_state_specs`` (the C1
    upgrade in wus mode), the optimizer's step replicated."""
    ospecs = {}
    for k, v in state_shapes["opt"].items():
        ospecs[k] = (() if k == "step"
                     else opt_state_specs(axes, v, rules))
    return {"params": param_specs(axes, state_shapes["params"], rules),
            "opt": ospecs}


def param_specs_serving(cfg: ModelConfig, params_shapes, axes,
                        rules: Rules):
    """Serving weight specs: the same rules, the config's mode."""
    return param_specs(axes, params_shapes, rules)


def batch_pspecs(batch_shapes, rules: Rules):
    """Each batch leaf's rows over the batch axes (``("pod", "data")``:
    row-major, so rank (p, d) holds the block p * |data| + d), the rest
    replicated."""
    def one(s):
        logical = ("batch",) + (None,) * (len(s.shape) - 1)
        return rules.spec_for(logical, tuple(s.shape))

    return tree_map(one, batch_shapes)


def _kv_cache_axes(cfg: ModelConfig, rules: Rules) -> Dict[str, Axes]:
    """One attention layer's slab axes: KV heads over ``model`` when it
    divides them, else the slots (``kv_seq``)."""
    model_size = rules.axis_size(rules.table.get("kv_heads", ()))
    head_sharded = model_size > 1 and cfg.n_kv_heads % model_size == 0
    seq_tag = None if head_sharded else "kv_seq"
    kv_tag = "kv_heads" if head_sharded else None
    ax = {"k": Axes(("batch", seq_tag, kv_tag, None)),
          "v": Axes(("batch", seq_tag, kv_tag, None)),
          "slot_pos": Axes(("batch", seq_tag))}
    if cfg.kv_cache_dtype == "int8":
        ax["k_scale"] = Axes(("batch", seq_tag, kv_tag))
        ax["v_scale"] = Axes(("batch", seq_tag, kv_tag))
    return ax


def cache_axes(cfg: ModelConfig, rules: Rules):
    """Axes tree matching the family's ``init_cache``: one tree a layer
    (an enc-dec's ``self`` and ``cross`` lists)."""
    if cfg.is_encdec:
        return {"self": [_kv_cache_axes(cfg, rules)
                         for _ in range(cfg.n_layers)],
                "cross": [_kv_cache_axes(cfg, rules)
                          for _ in range(cfg.n_layers)]}
    entries = []
    for i in range(cfg.n_layers):
        mixer = cfg.block_pattern[i % len(cfg.block_pattern)].mixer
        if mixer == "attn":
            entries.append(_kv_cache_axes(cfg, rules))
        elif mixer == "mamba":
            entries.append({"conv": Axes(("batch", None, "act_mlp")),
                            "ssm": Axes(("batch", "act_mlp", None))})
        else:  # rwkv6
            entries.append({"shift": Axes(("batch", None)),
                            "wkv": Axes(("batch", None, None, None))})
    return entries


def cache_pspecs(cfg: ModelConfig, cache_shapes, rules: Rules):
    return tree_map(lambda a, s: rules.spec_for(a.names, tuple(s.shape)),
                    cache_axes(cfg, rules), cache_shapes,
                    is_leaf=lambda x: isinstance(x, Axes))


def _global_norm(leaves: Sequence[torch.Tensor]) -> torch.Tensor:
    """L2 norm over every leaf, in fp32."""
    return torch.sqrt(sum(g.float().square().sum() for g in leaves))


def _value_and_grad(cfg: ModelConfig, params, batch, acc, place=None):
    """(loss, nll) of the family's loss at the compute copy of ``params``;
    its gradient, in ``grad_dtype``, is added into ``acc`` (one entry a
    leaf; None: set) leaf by leaf as the backward pass finishes each.

    The gradient is taken at the compute copy's leaves. A master reaches
    the loss only through its cast, whose gradient is the copy's widened
    exactly, so the result in ``grad_dtype`` is bitwise the master's; but
    no fp32 gradient of the model, and no second gradient of it beside
    ``acc``, is ever held: each leaf's is folded into ``acc`` and freed.
    On a mesh (``place``) the leaves are the rank's blocks and the loss
    its share of the global one."""
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
            loss, metrics = ModelAPI(cfg).loss(compute, batch, place)
            loss.backward()
    finally:
        for h in handles:
            h.remove()
    missing = [i for i, g in enumerate(acc) if g is None]
    if missing:
        raise RuntimeError(f"leaves {missing} got no gradient: every "
                           f"parameter must reach the loss")
    return loss.detach(), metrics["nll"].detach()


def _seq_len(batch) -> int:
    """The residual stream's length: the tokens and any media."""
    media = batch.get("media")
    return batch["tokens"].shape[1] + (0 if media is None
                                       else media.shape[1])


def make_train_step(cfg: ModelConfig, optimizer: Optimizer,
                    extra_metrics=(), *, plan=None) -> Callable:
    """``train_step(state, batch) -> (state, metrics)``; metrics are
    0-d device tensors {"loss", "nll"} plus any of ``EXTRA_METRICS``.
    With ``cfg.microbatches`` M > 1 the batch splits into M row blocks
    whose gradients are summed in ``grad_dtype`` and divided by M; a
    batch whose rows M does not divide raises ``ValueError``.

    With ``plan`` (a ``dist.spmd.Plan``) the step runs on the plan's
    mesh, under ``use_rules``: ``state`` holds the rank's blocks (the
    moments in their own layout), ``batch`` the rank's rows, and M splits
    those rows, so global microbatch i is every rank's block i, where the
    reference's is rows ``i * B/M ..`` of the global batch (the same
    gradient but for the order of sums; an MoE's aux loss groups its
    tokens otherwise). The gradients are summed over the batch axes by
    the plan's schedule, the optimizer updates the moments' blocks, and
    the loss, nll and norms are the global ones, every distinct block
    counted once."""
    M = cfg.microbatches
    unknown = [m for m in extra_metrics if m not in EXTRA_METRICS]
    if unknown:
        raise ValueError(
            f"unknown extra metric(s) {unknown}; supported: {EXTRA_METRICS}")

    def train_step(state, batch):
        params, opt_state = state["params"], state["opt"]
        grads: List[Optional[torch.Tensor]] = [None] * len(
            tree_leaves(params))
        with use_rules(None if plan is None else plan.rules):
            place = None if plan is None else Placement(plan,
                                                        _seq_len(batch))
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
                    mb_loss, nll = _value_and_grad(cfg, params, mb, grads,
                                                   place)
                    losses.append(mb_loss)
                    nlls.append(nll)
                for g in grads:
                    g.div_(M)
                loss = sum(losses) / M  # summed in order, as the reference
                nll = torch.stack(nlls).mean()
            else:
                loss, nll = _value_and_grad(cfg, params, batch, grads, place)
        if plan is None:
            metrics = {"loss": loss, "nll": nll}
            if "grad_norm" in extra_metrics:
                metrics["grad_norm"] = _global_norm(grads)
            new_params, new_opt = optimizer.update(grads, opt_state, params)
            if "param_norm" in extra_metrics:
                metrics["param_norm"] = _global_norm(tree_leaves(new_params))
            return {"params": new_params, "opt": new_opt}, metrics
        grads = plan.reduce_grads(grads)
        loss, nll = plan.batch_sum(torch.stack([loss, nll]).float())
        metrics = {"loss": loss, "nll": nll}
        if "grad_norm" in extra_metrics:
            metrics["grad_norm"] = plan.global_norm(grads, moments=True)
        views = plan.update_views(params)
        _, new_opt = optimizer.update(tree_unflatten(params, grads),
                                      opt_state,
                                      tree_unflatten(params, views))
        plan.rebuild(params, views)
        if "param_norm" in extra_metrics:
            metrics["param_norm"] = plan.global_norm(tree_leaves(params),
                                                     moments=False)
        return {"params": params, "opt": new_opt}, metrics

    return train_step


def make_eval_step(cfg: ModelConfig, *, plan=None) -> Callable:
    """Distributed eval (C4): ``eval_step(params, batch, mask)`` returns
    (sum of per-example nll over real examples, their count). As in the
    reference, whose eval step runs no ``compute_cast``, the fp32 leaves
    the layers read in fp32 stay unrounded (``lm.use_cast``). With
    ``plan`` the rank's blocks, rows and mask rows, both sums over the
    batch axes."""
    api = ModelAPI(cfg)

    @torch.no_grad()
    def eval_step(params, batch, mask):
        with use_rules(None if plan is None else plan.rules):
            place = None if plan is None else Placement(plan,
                                                        _seq_len(batch))
            nll_ex, _ = api.per_example_nll(api.use_cast(params), batch,
                                            place)
        mask = mask.to(nll_ex.device)
        if plan is None:
            return (nll_ex * mask).sum(), mask.sum()
        out = plan.batch_sum(torch.stack([(nll_ex * mask).sum(),
                                          mask.sum().float()]))
        return out[0], out[1]

    return eval_step


def make_serve_prefill_step(cfg: ModelConfig, *, cache_len: int,
                            window=None) -> Callable:
    """``prefill_step(params, batch, last_pos)``: (logits at each row's
    true last prompt position ``last_pos`` (B,), slab cache of
    ``cache_len`` slots; an enc-dec batch's ``media`` is encoded into
    the cross caches). Padded positions' K/V stay in the cache; the
    engine masks them with ``serve.cache.invalidate_beyond``."""
    api = ModelAPI(cfg)

    def prefill_step(params, batch, last_pos, place=None):
        return api.prefill(params, batch, cache_len=cache_len, window=window,
                           last_pos=last_pos, place=place)

    return prefill_step


def make_serve_decode_step(cfg: ModelConfig, *, window=None) -> Callable:
    """``decode_step(params, token, cache, pos)``: one token for every
    slot, ``pos`` (B,) one absolute offset per slot. On a mesh both
    steps take the placement (``place``) of ``dist.serving``."""
    api = ModelAPI(cfg)

    def decode_step(params, token, cache, pos, place=None):
        return api.decode(params, token, cache, pos, window=window,
                          place=place)

    return decode_step
