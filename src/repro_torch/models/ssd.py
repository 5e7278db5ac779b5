"""SSD (``repro.models.ssd``, paper section 3): the single-shot detector
with a ResNet-34 backbone, as plain functions over a parameter dict.

The graph is the reference's: ResNet-34 truncated after stage 3
(``resnet.features(..., n_stages=3)``; its stage 4 and a 0-class head
are built and never read, as in the reference), extra pyramid layers
down to 1 x 1 (a 1 x 1 conv to half the channels, then a 3 x 3 conv,
stride 2 while the map is larger than 1 x 1, each followed by ReLU),
and a class and a box conv head (3 x 3) on every pyramid level. Every
conv is SAME (``resnet.same_conv``) in the config's dtype; the backbone
keeps its own config's dtype. The heads' NHWC outputs (B, H, W, A*C)
become (B, H*W*A, C) in that order, so anchor i of the port is anchor i
of the reference and of the targets.

Target assignment is the data pipeline's: the batch carries a class id
(0 = background) and box offsets for every anchor. The loss is the
multibox loss: cross entropy from the fp32 ``log_softmax`` on the
positives and the 3:1 hardest negatives, ranked by two stable argsorts
outside autograd (the reference's ``stop_gradient``), plus smooth-L1 on
the positives, each divided by the example's positive count (at least
1), then the mean over examples; its ``|diff|`` passes a gradient of 1
at 0, as ``jnp.abs`` does.

Conv weights are stored (out, in, kh, kw); :func:`params_from_numpy`
converts the reference's HWIO. ``forward`` and ``loss_fn`` take the
reference's ``mesh`` and hand it, with ``spatial_partition``, to the
backbone (``ssd.py:84-91,133-140``): on a mesh its convs are spatially
partitioned over ``model`` (C3); with ``mesh=None`` the option is inert.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import resnet as R
from repro_torch.utils import count_params


@dataclasses.dataclass(frozen=True)
class SSDConfig:
    name: str = "ssd_resnet34"
    image_size: int = 300
    num_classes: int = 81  # COCO + background
    anchors_per_loc: int = 4
    # channels of the extra pyramid layers after the backbone
    extra_channels: Tuple[int, ...] = (512, 512, 256, 256, 256)
    backbone: R.ResNetConfig = dataclasses.field(
        default_factory=lambda: dataclasses.replace(R.RESNET34,
                                                    num_classes=0))
    dtype: str = "bfloat16"
    neg_pos_ratio: float = 3.0
    spatial_partition: bool = False


SSD_TINY = SSDConfig(
    name="ssd_tiny", image_size=64, num_classes=11,
    extra_channels=(64, 64),
    backbone=dataclasses.replace(R.RESNET_TINY, block="basic",
                                 stage_sizes=(1, 1), width=16),
)


def _n_stages(cfg: SSDConfig) -> int:
    return min(3, len(cfg.backbone.stage_sizes))


def init_ssd(cfg: SSDConfig, seed: int = 0, *, device="cuda") -> Dict[str, Any]:
    """fp32 weights with the reference's names and distributions
    (``ssd.py:52-76``): the whole backbone from ``resnet.init_resnet``
    (seed ``seed``), then He-normal convs (``N(0, 2 / (kh*kw*cin))``)
    for the extras and heads, from a ``torch.Generator`` seeded with
    ``seed + 1``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)

    def conv(kh, kw, cin, cout):
        return torch.randn((cout, cin, kh, kw), generator=gen,
                           device=dev).mul_((2.0 / (kh * kw * cin)) ** 0.5)

    params: Dict[str, Any] = {
        "backbone": R.init_resnet(cfg.backbone, seed, device=dev)}
    cin = R._block_channels(cfg.backbone, _n_stages(cfg) - 1)[1]
    feat_channels = [cin]
    for i, c in enumerate(cfg.extra_channels):
        params[f"extra{i}_a"] = conv(1, 1, cin, c // 2)
        params[f"extra{i}_b"] = conv(3, 3, c // 2, c)
        cin = c
        feat_channels.append(c)
    A = cfg.anchors_per_loc
    for i, c in enumerate(feat_channels):
        params[f"cls{i}"] = conv(3, 3, c, A * cfg.num_classes)
        params[f"box{i}"] = conv(3, 3, c, A * 4)
    return params


def param_count(cfg: SSDConfig) -> int:
    """The tree's parameters, from its shapes (nothing allocated)."""
    return count_params(lambda: init_ssd(cfg, device="cpu"))


def params_from_numpy(tree, device="cuda") -> Dict[str, Any]:
    """The weight bridge: the reference's tree as numpy arrays
    (``split_tree(init_ssd(cfg, key))[0]``) to fp32 tensors on
    ``device``; the backbone through ``resnet.params_from_numpy``, the
    extras and heads from HWIO to (out, in, kh, kw)."""
    dev = resolve_device(device)
    out = {"backbone": R.params_from_numpy(tree["backbone"], dev)}
    for k, v in tree.items():
        if k != "backbone":
            a = np.asarray(v, np.float32).transpose(3, 2, 0, 1)
            out[k] = torch.tensor(np.ascontiguousarray(a)).to(dev)
    return out


def params_to_numpy(params) -> Dict[str, Any]:
    """The bridge back: parameters (or gradients) as numpy in the
    reference's layout (conv weights HWIO)."""
    out = {"backbone": R.params_to_numpy(params["backbone"])}
    for k, v in params.items():
        if k != "backbone":
            out[k] = v.detach().float().cpu().numpy().transpose(2, 3, 1, 0)
    return out


def _backbone_cfg(cfg: SSDConfig) -> R.ResNetConfig:
    return dataclasses.replace(cfg.backbone,
                               spatial_partition=cfg.spatial_partition)


def forward(params, cfg: SSDConfig, images, *, mesh=None):
    """images (B, H, W, 3) -> (cls_logits (B, A, num_classes), box_preds
    (B, A, 4)), both fp32."""
    dt = R._dt(cfg)
    feats = R.features(params["backbone"], _backbone_cfg(cfg), images,
                       mesh=mesh, n_stages=_n_stages(cfg))
    x = feats[-1]
    pyramid = [x]
    for i in range(len(cfg.extra_channels)):
        y = F.relu(R.same_conv(x, params[f"extra{i}_a"], 1, dt))
        stride = 2 if x.shape[1] > 1 else 1
        x = F.relu(R.same_conv(y, params[f"extra{i}_b"], stride, dt))
        pyramid.append(x)
    B = images.shape[0]
    cls_out, box_out = [], []
    for i, f in enumerate(pyramid):
        # NHWC (B, H, W, A*C) -> (B, H*W*A, C): the reference's order
        cls_out.append(R.same_conv(f, params[f"cls{i}"], 1, dt)
                       .reshape(B, -1, cfg.num_classes))
        box_out.append(R.same_conv(f, params[f"box{i}"], 1, dt)
                       .reshape(B, -1, 4))
    return (torch.cat(cls_out, 1).float(), torch.cat(box_out, 1).float())


def level_sizes(cfg: SSDConfig) -> List[int]:
    """Side of each pyramid level's map, from the shapes alone (a SAME
    conv or pool at stride s maps n to ceil(n / s))."""
    b = cfg.backbone
    n = -(-cfg.image_size // b.stem_stride)
    if b.stem_pool:
        n = -(-n // 2)
    for _ in range(1, _n_stages(cfg)):
        n = -(-n // 2)
    sizes = [n]
    for _ in cfg.extra_channels:
        n = -(-n // (2 if n > 1 else 1))
        sizes.append(n)
    return sizes


def num_anchors(cfg: SSDConfig) -> int:
    """Anchors over every pyramid level (2,000 for ``SSDConfig()``)."""
    return cfg.anchors_per_loc * sum(n * n for n in level_sizes(cfg))


def loss_fn(params, cfg: SSDConfig, batch, *, mesh=None):
    """batch: images (B, H, W, 3), cls_targets (B, A) ints (0 =
    background), box_targets (B, A, 4) fp32 (counted where the class is
    not 0). Returns (loss, {"nll", "cls", "box"})."""
    cls_logits, box_preds = forward(params, cfg, batch["images"], mesh=mesh)
    cls_t = batch["cls_targets"].to(cls_logits.device, torch.long)
    box_t = batch["box_targets"]
    pos = (cls_t > 0).float()
    n_pos = torch.clamp(pos.sum(1), min=1.0)

    logp = torch.log_softmax(cls_logits, dim=-1)
    ce = -torch.gather(logp, -1, cls_t[..., None])[..., 0]
    with torch.no_grad():  # the selection is a mask, not differentiated
        neg_ce = torch.where(pos > 0, float("-inf"), ce)
        k = torch.clamp((cfg.neg_pos_ratio * n_pos).to(torch.int32),
                        max=cls_t.shape[1] - 1)
        order = torch.argsort(-neg_ce, dim=1, stable=True)
        rank = torch.argsort(order, dim=1, stable=True)
        neg_keep = (rank < k[:, None]).float() * (1 - pos)
    cls_loss = (ce * (pos + neg_keep)).sum(1) / n_pos

    diff = L.jnp_abs(box_preds - box_t)
    sl1 = torch.where(diff < 1.0, 0.5 * diff ** 2, diff - 0.5).sum(-1)
    box_loss = (sl1 * pos).sum(1) / n_pos

    loss = (cls_loss + box_loss).mean()
    return loss, {"nll": loss, "cls": cls_loss.mean(),
                  "box": box_loss.mean()}
