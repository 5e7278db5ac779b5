"""Mask R-CNN (``repro.models.maskrcnn``, paper section 3): the two-stage
detector, structurally the reference's, as plain functions over a
parameter dict.

- Stage 1: the ResNet-50 backbone (``resnet.features``), an FPN
  (lateral 1 x 1 convs, a top-down sum with nearest upsampling to each
  lateral's size, 3 x 3 output convs) and the RPN over the finest level
  (objectness and box deltas, one anchor a location), all in the
  config's dtype. The top ``num_proposals`` scores of each image are the
  proposals (no NMS), ties broken toward the lower index as
  ``jax.lax.top_k`` breaks them: a stable descending sort, then the
  first k (``torch.topk`` promises no order among ties, and bf16 scores
  tie often). A proposal's centre is its grid cell, its size
  ``sigmoid(delta) * 0.5 + 0.05``, the box clipped to [0, 1].
- Stage 2: ``roi_align`` crops each proposal from the finest level in
  fp32 (the reference's bilinear crop-resize), then three independent
  branches, the class and box products in fp32 and the mask branch
  (bilinear resize from ``roi_size`` to ``mask_size``, a ReLU 3 x 3 conv
  and a 1 x 1 conv, in fp32), run through
  ``core.graph_partitioning.run_partitioned`` (C10), which on one device
  runs them in order.

The reference's resizes and clips, matched:

- nearest: ``jax.image.resize(..., "nearest")`` samples input index
  ``floor((i + 0.5) * in / out)``, which is ``F.interpolate(mode=
  "nearest-exact")``, not ``mode="nearest"`` (they differ at 4 -> 7;
  at the configs' exact 2x they agree);
- bilinear: upsampling, ``jax.image.resize`` applies the normalised
  triangle kernel at half-pixel centres; the port builds that weight
  matrix (:func:`resize_matrix`) and applies it along each spatial axis.
  Shrinking, JAX antialiases; the port raises for ``mask_size <
  roi_size`` (the repo's configs only upsample);
- ``jnp.clip`` is a maximum then a minimum, whose gradient at a tie is
  half; ``torch.clamp``'s is whole, so the port clips with
  ``layers.jnp_clip`` (``torch.maximum``, then ``torch.minimum``, which
  split ties as JAX does): ``roi_align``'s sample positions, the
  proposals, the BCE's +-30; the BCE's ``max(z, 0)`` is
  ``torch.maximum`` too. ``jnp.abs``'s gradient at 0 is 1 and
  ``torch.abs``'s 0: the BCE's ``|z|`` and the box L1 take
  ``layers.jnp_abs``.

No float atomics in a backward, so that a second run repeats the losses
bitwise: ``roi_align``'s four corner gathers are products with one-hot
matrices, and the mask resize a product with the weight matrix, whose
backwards are matrix products; the nearest upsampling's backward sums
each input cell's window without atomics. The remaining gathers (the
class of each anchor or proposal, the mask of its target class, the
boxes of the top k) read each element at most once, so their
scatter-add backward writes each gradient element once.

Conv weights are stored (out, in, kh, kw); ``head_cls`` and ``head_box``
are dense (in, out) matrices. :func:`params_from_numpy` converts the
reference's tree. Spatial partitioning needs a mesh and raises.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.core.graph_partitioning import run_partitioned
from repro_torch.models import layers as L
from repro_torch.models import resnet as R
from repro_torch.utils import count_params


@dataclasses.dataclass(frozen=True)
class MaskRCNNConfig:
    name: str = "maskrcnn"
    image_size: int = 128
    num_classes: int = 81
    fpn_channels: int = 64
    num_proposals: int = 16     # top-k RPN proposals kept (no NMS)
    roi_size: int = 7
    mask_size: int = 14
    backbone: R.ResNetConfig = dataclasses.field(
        default_factory=lambda: R.RESNET50)
    dtype: str = "bfloat16"
    spatial_partition: bool = False


MASKRCNN_TINY = MaskRCNNConfig(
    name="maskrcnn_tiny", image_size=32, num_classes=5, fpn_channels=16,
    num_proposals=4, roi_size=4, mask_size=8,
    backbone=R.RESNET_TINY,
)

# The conv leaves of the model's own (stored HWIO by the reference);
# ``fpn_lat{s}`` and ``fpn_out{s}`` too.
_CONVS = ("rpn_conv", "rpn_cls", "rpn_box", "mask_conv", "mask_out")


def _is_conv(name: str) -> bool:
    return name in _CONVS or name.startswith(("fpn_lat", "fpn_out"))


def init_maskrcnn(cfg: MaskRCNNConfig, seed: int = 0, *,
                  device="cuda") -> Dict[str, Any]:
    """fp32 weights with the reference's names and distributions
    (``maskrcnn.py:53-84``): the backbone from ``resnet.init_resnet``
    (seed ``seed``), then from a ``torch.Generator`` seeded with ``seed +
    1`` He-normal convs (``N(0, 2 / (kh*kw*cin))``) and the dense heads
    ``N(0, 1 / roi_feat)`` (roi_feat = C * roi_size^2)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)

    def conv(kh, kw, cin, cout):
        return torch.randn((cout, cin, kh, kw), generator=gen,
                           device=dev).mul_((2.0 / (kh * kw * cin)) ** 0.5)

    def dense(n_in, n_out):
        return torch.randn((n_in, n_out), generator=gen,
                           device=dev).mul_(n_in ** -0.5)

    C = cfg.fpn_channels
    params: Dict[str, Any] = {
        "backbone": R.init_resnet(cfg.backbone, seed, device=dev)}
    for s in range(len(cfg.backbone.stage_sizes)):
        cin = R._block_channels(cfg.backbone, s)[1]
        params[f"fpn_lat{s}"] = conv(1, 1, cin, C)
        params[f"fpn_out{s}"] = conv(3, 3, C, C)
    params["rpn_conv"] = conv(3, 3, C, C)
    params["rpn_cls"] = conv(1, 1, C, 1)
    params["rpn_box"] = conv(1, 1, C, 4)
    roi_feat = C * cfg.roi_size * cfg.roi_size
    params["head_cls"] = dense(roi_feat, cfg.num_classes)
    params["head_box"] = dense(roi_feat, 4)
    params["mask_conv"] = conv(3, 3, C, C)
    params["mask_out"] = conv(1, 1, C, cfg.num_classes)
    return params


def param_count(cfg: MaskRCNNConfig) -> int:
    """The tree's parameters, from its shapes (nothing allocated)."""
    return count_params(lambda: init_maskrcnn(cfg, device="cpu"))


def params_from_numpy(tree, device="cuda") -> Dict[str, Any]:
    """The weight bridge: the reference's tree as numpy arrays
    (``split_tree(init_maskrcnn(cfg, key))[0]``) to fp32 tensors on
    ``device``; the backbone through ``resnet.params_from_numpy``, the
    model's conv leaves from HWIO to (out, in, kh, kw), the dense heads
    as they are."""
    dev = resolve_device(device)
    out = {"backbone": R.params_from_numpy(tree["backbone"], dev)}
    for k, v in tree.items():
        if k != "backbone":
            a = np.asarray(v, np.float32)
            if _is_conv(k):
                a = a.transpose(3, 2, 0, 1)
            out[k] = torch.tensor(np.ascontiguousarray(a)).to(dev)
    return out


def params_to_numpy(params) -> Dict[str, Any]:
    """The bridge back: parameters (or gradients) as numpy in the
    reference's layout."""
    out = {"backbone": R.params_to_numpy(params["backbone"])}
    for k, v in params.items():
        if k != "backbone":
            a = v.detach().float().cpu().numpy()
            out[k] = a.transpose(2, 3, 1, 0) if _is_conv(k) else a
    return out


def rpn_size(cfg: MaskRCNNConfig) -> int:
    """Side of the finest FPN level (the backbone's first stage), from the
    shapes: its H * W locations are the RPN's anchors."""
    b = cfg.backbone
    n = -(-cfg.image_size // b.stem_stride)
    return -(-n // 2) if b.stem_pool else n


# ---- the reference's resizes ---------------------------------------------- #
def resize_nearest(x, size):
    """NHWC ``x`` to (size[0], size[1]) as ``jax.image.resize(...,
    "nearest")``: input index ``floor((i + 0.5) * in / out)``."""
    y = F.interpolate(x.permute(0, 3, 1, 2), size=tuple(size),
                      mode="nearest-exact")
    return y.permute(0, 2, 3, 1)


def resize_matrix(n_in: int, n_out: int, *, device=None) -> torch.Tensor:
    """(n_out, n_in) fp32 weights of ``jax.image.resize(..., "bilinear")``
    along one axis when upsampling (``n_out >= n_in``): the triangle
    kernel at the half-pixel sample positions, each row normalised to
    sum 1 (``jax.image.scale.compute_weight_mat``)."""
    if n_out < n_in:
        raise NotImplementedError(
            f"bilinear resize {n_in} -> {n_out}: shrinking, "
            f"jax.image.resize applies an antialiasing triangle filter "
            f"scaled by {n_in / n_out:g}, which the port does not reproduce")
    f32 = torch.float32
    inv_scale = 1.0 / torch.tensor(n_out / n_in, dtype=f32, device=device)
    sample = ((torch.arange(n_out, dtype=f32, device=device) + 0.5)
              * inv_scale - 0.5)
    x = torch.abs(sample[None, :]
                  - torch.arange(n_in, dtype=f32, device=device)[:, None])
    w = torch.clamp(1.0 - x, min=0.0)
    total = w.sum(0, keepdim=True)
    w = torch.where(torch.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w)).T.contiguous()


def resize_bilinear(x, size: int):
    """NHWC ``x`` (N, s, s, C) to (N, size, size, C) as
    ``jax.image.resize(..., "bilinear")`` when upsampling: the weight
    matrix along H, then along W (matrix products, whose backward needs
    no atomics)."""
    mh = resize_matrix(x.shape[1], size, device=x.device).to(x.dtype)
    mw = resize_matrix(x.shape[2], size, device=x.device).to(x.dtype)
    y = torch.einsum("ih,nhwc->niwc", mh, x)
    return torch.einsum("jw,niwc->nijc", mw, y)


# ---- stage 1 ---------------------------------------------------------------- #
def _backbone_cfg(cfg: MaskRCNNConfig) -> R.ResNetConfig:
    return dataclasses.replace(cfg.backbone,
                               spatial_partition=cfg.spatial_partition)


def fpn_features(params, cfg: MaskRCNNConfig, images) -> List[torch.Tensor]:
    """Stage 1's trunk: the backbone and the FPN's top-down pathway, one
    NHWC map of ``fpn_channels`` a backbone stage, finest first."""
    dt = R._dt(cfg)
    feats = R.features(params["backbone"], _backbone_cfg(cfg), images)
    laterals = [R.same_conv(f, params[f"fpn_lat{s}"], 1, dt)
                for s, f in enumerate(feats)]
    out = [laterals[-1]]
    for s in range(len(laterals) - 2, -1, -1):
        up = resize_nearest(out[0], laterals[s].shape[1:3])
        out.insert(0, laterals[s] + up)
    return [R.same_conv(f, params[f"fpn_out{s}"], 1, dt)
            for s, f in enumerate(out)]


def top_k(x, k: int):
    """(values, indices) of the k largest entries of each row of ``x``
    (B, N), ties toward the lower index, as ``jax.lax.top_k``."""
    idx = torch.sort(x, dim=1, descending=True, stable=True).indices[:, :k]
    return torch.gather(x, 1, idx), idx


def rpn(params, cfg: MaskRCNNConfig, fpn_feats):
    """Objectness and boxes over the finest FPN level; returns (top-k
    scores (B, P), proposals (B, P, 4) as (y0, x0, y1, x1) in [0, 1],
    every score (B, H*W) and box delta (B, H*W, 4), fp32)."""
    dt = R._dt(cfg)
    f = F.relu(R.same_conv(fpn_feats[0], params["rpn_conv"], 1, dt))
    scores = R.same_conv(f, params["rpn_cls"], 1, dt)[..., 0]  # (B, H, W)
    boxes = R.same_conv(f, params["rpn_box"], 1, dt)           # (B, H, W, 4)
    B, H, W = scores.shape
    flat_s = scores.reshape(B, H * W).float()
    flat_b = boxes.reshape(B, H * W, 4).float()
    top_s, top_i = top_k(flat_s, cfg.num_proposals)
    top_b = torch.gather(flat_b, 1, top_i[..., None].expand(-1, -1, 4))
    cy = (top_i // W).float() / H
    cx = (top_i % W).float() / W
    centers = torch.stack([cy, cx], -1)
    sizes = torch.sigmoid(top_b[..., 2:]) * 0.5 + 0.05
    rois = torch.cat([centers - sizes / 2, centers + sizes / 2], -1)
    return top_s, L.jnp_clip(rois, 0.0, 1.0), flat_s, flat_b


# ---- stage 2 ---------------------------------------------------------------- #
def roi_align(feat, rois, out_size: int):
    """Bilinear crop-resize (the reference's simplified RoIAlign). feat
    (B, H, W, C), read in fp32; rois (B, P, 4) as (y0, x0, y1, x1) in
    [0, 1] -> (B, P, s, s, C). Sample i of a box sits at ``y0 + (y1 - y0)
    * (i + 0.5) / s``, then ``clip(y * H - 0.5, 0, H - 1)``; its corners
    are the floor and the next row (capped at H - 1), weighted in the
    reference's order of terms. The corners are gathered by products
    with one-hot matrices (exact in fp32)."""
    B, H, W, C = feat.shape
    feat = feat.float()
    ar = torch.arange(out_size, device=feat.device)
    y0, x0, y1, x1 = rois.unbind(-1)  # (B, P) each
    ys = y0[..., None] + (y1 - y0)[..., None] * (ar + 0.5) / out_size
    xs = x0[..., None] + (x1 - x0)[..., None] * (ar + 0.5) / out_size
    yi = L.jnp_clip(ys * H - 0.5, 0, H - 1)  # (B, P, s)
    xi = L.jnp_clip(xs * W - 0.5, 0, W - 1)
    y_lo, x_lo = torch.floor(yi).detach(), torch.floor(xi).detach()
    y_hi = torch.clamp(y_lo + 1, max=H - 1)
    x_hi = torch.clamp(x_lo + 1, max=W - 1)
    wy = (yi - y_lo)[..., :, None, None]  # (B, P, s, 1, 1)
    wx = (xi - x_lo)[..., None, :, None]  # (B, P, 1, s, 1)

    def one_hot(i, n):
        return F.one_hot(i.long(), n).float()  # (B, P, s, n)

    rows = {"lo": one_hot(y_lo, H), "hi": one_hot(y_hi, H)}
    cols = {"lo": one_hot(x_lo, W), "hi": one_hot(x_hi, W)}
    by_row = {k: torch.einsum("bpih,bhwc->bpiwc", m, feat)
              for k, m in rows.items()}

    def g(a, b):  # (B, P, s, s, C): feat at rows a, columns b
        return torch.einsum("bpjw,bpiwc->bpijc", cols[b], by_row[a])

    return ((1 - wy) * (1 - wx) * g("lo", "lo")
            + (1 - wy) * wx * g("lo", "hi")
            + wy * (1 - wx) * g("hi", "lo")
            + wy * wx * g("hi", "hi"))


def stage2_heads(params, cfg: MaskRCNNConfig, fpn_feats, rois, *, mesh=None):
    """The independent head branches over each proposal's crop: class
    logits (B, P, classes), boxes (B, P, 4) and masks (B, P, ms, ms,
    classes), through ``run_partitioned`` (C10; in order on one
    device)."""
    roi_feat = roi_align(fpn_feats[0], rois, cfg.roi_size)  # (B, P, s, s, C)
    B, P = roi_feat.shape[:2]
    flat = roi_feat.reshape(B, P, -1)

    def branch_cls():
        return flat @ params["head_cls"].float()

    def branch_box():
        return flat @ params["head_box"].float()

    def branch_mask():
        m = roi_feat.reshape(B * P, cfg.roi_size, cfg.roi_size, -1)
        m = resize_bilinear(m, cfg.mask_size)
        m = F.relu(R.same_conv(m, params["mask_conv"], 1, torch.float32))
        m = R.same_conv(m, params["mask_out"], 1, torch.float32)
        return m.reshape(B, P, cfg.mask_size, cfg.mask_size, -1)

    cls_logits, box_preds, masks = run_partitioned(
        [branch_cls, branch_box, branch_mask], mesh=mesh)
    return cls_logits, box_preds, masks


def forward(params, cfg: MaskRCNNConfig, images):
    """images (B, H, W, 3) -> {"rpn_scores", "rpn_boxes", "rois",
    "cls_logits", "box_preds", "masks"}."""
    fpn_feats = fpn_features(params, cfg, images)
    _, rois, rpn_s, rpn_b = rpn(params, cfg, fpn_feats)
    cls_logits, box_preds, masks = stage2_heads(params, cfg, fpn_feats, rois)
    return {"rpn_scores": rpn_s, "rpn_boxes": rpn_b, "rois": rois,
            "cls_logits": cls_logits, "box_preds": box_preds,
            "masks": masks}


def _bce(logits, labels):
    """Binary cross entropy with logits clipped to +-30, as the
    reference's ``_bce`` (``jnp.maximum``'s half gradient at 0 kept)."""
    z = L.jnp_clip(logits, -30.0, 30.0)
    return (torch.maximum(z, torch.zeros_like(z)) - z * labels
            + torch.log1p(torch.exp(-L.jnp_abs(z))))


def loss_fn(params, cfg: MaskRCNNConfig, batch):
    """batch: images (B, H, W, 3), rpn_labels (B, A) in {0, 1},
    cls_targets (B, P), box_targets (B, P, 4), mask_targets (B, P, ms, ms)
    in {0, 1}. RPN BCE + class CE + box L1 + BCE of each proposal's mask
    for its target class. Returns (loss, {"nll", "rpn", "cls", "box",
    "mask"})."""
    out = forward(params, cfg, batch["images"])
    rpn_l = torch.mean(_bce(out["rpn_scores"], batch["rpn_labels"].float()))
    cls_t = batch["cls_targets"].long()
    logp = torch.log_softmax(out["cls_logits"], -1)
    cls_l = -torch.gather(logp, -1, cls_t[..., None]).mean()
    box_l = L.jnp_abs(out["box_preds"] - batch["box_targets"]).mean()
    mt = batch["mask_targets"].float()
    B, P, ms = mt.shape[:3]
    idx = cls_t[:, :, None, None, None].expand(B, P, ms, ms, 1)
    mp = torch.gather(out["masks"], -1, idx)[..., 0]
    mask_l = torch.mean(_bce(mp, mt))
    loss = rpn_l + cls_l + box_l + mask_l
    return loss, {"nll": loss, "rpn": rpn_l, "cls": cls_l, "box": box_l,
                  "mask": mask_l}
