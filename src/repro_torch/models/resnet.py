"""ResNet v1.5 (``repro.models.resnet``, paper section 3, ResNet-50) as
plain functions over a parameter dict.

"v1.5" is the MLPerf variant: in bottleneck blocks the stride-2 conv is
the 3x3, not the first 1x1. The arithmetic is the reference's, step by
step:

- ``images`` are NHWC, and so is every activation between the convs
  (each conv sees a channels-last NCHW view, which costs no copy);
- each conv casts x and w to ``cfg.dtype`` and pads as XLA's ``"SAME"``
  does, which at stride 2 puts the extra row and column at the end (the
  7x7 stride-2 stem at 224 pads (2, 3), a 3x3 stride-2 conv at 56 pads
  (0, 1)); the 3x3 stride-2 max pool pads the same way, with -inf;
- batch norm always uses batch statistics (there are no running ones),
  in fp32, and returns the conv's dtype; the residual add and ReLU run
  in that dtype;
- the global average pool is a mean in the compute dtype (fp32
  accumulation, result rounded to it), then cast to fp32; the head is an
  fp32 ``x @ head + head_bias`` (full fp32 while TF32 stays off, as is
  PyTorch's default for matmul).

Parameters are fp32 masters with the reference's names (``stem_conv``,
``stem_bn``, ``s{s}b{b}`` with ``conv1..3``, ``bn1..3``, ``proj``,
``proj_bn``, then ``head``, ``head_bias``). Conv weights are stored
(out, in, kh, kw), the layout ``F.conv2d`` takes; :func:`params_from_numpy`
converts the reference's HWIO. Distributed batch norm and spatial
partitioning need a device mesh and raise here.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.core.distributed_norm import batch_norm

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
_MESH_ONLY = ("needs a device mesh; it waits on the ROADMAP.md item "
              "'distribution, fleet and bench'")


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    name: str = "resnet50"
    block: str = "bottleneck"          # 'bottleneck' | 'basic'
    stage_sizes: Tuple[int, ...] = (3, 4, 6, 3)
    width: int = 64
    num_classes: int = 1000
    dtype: str = "bfloat16"
    stem_stride: int = 2
    stem_pool: bool = True
    # distributed BN (C5): replicas per stats group (1 = local BN)
    bn_group_size: int = 1
    # spatial partitioning (C3): shard conv H over the 'model' axis
    spatial_partition: bool = False


RESNET50 = ResNetConfig()
RESNET34 = ResNetConfig(name="resnet34", block="basic",
                        stage_sizes=(3, 4, 6, 3))
RESNET18 = ResNetConfig(name="resnet18", block="basic",
                        stage_sizes=(2, 2, 2, 2))
RESNET_TINY = ResNetConfig(name="resnet_tiny", block="bottleneck",
                           stage_sizes=(1, 1), width=16, num_classes=10,
                           stem_stride=1, stem_pool=False)


def _dt(cfg: ResNetConfig) -> torch.dtype:
    if cfg.dtype not in _DTYPES:
        raise ValueError(f"unknown dtype {cfg.dtype!r}; known: "
                         f"{sorted(_DTYPES)}")
    return _DTYPES[cfg.dtype]


def _check(cfg: ResNetConfig) -> None:
    if cfg.bn_group_size > 1:
        raise NotImplementedError(
            f"bn_group_size={cfg.bn_group_size}: distributed batch norm "
            f"{_MESH_ONLY}")
    if cfg.spatial_partition:
        raise NotImplementedError(
            f"spatial_partition=True: the spatially partitioned conv "
            f"{_MESH_ONLY}")


def _block_channels(cfg: ResNetConfig, stage: int):
    base = cfg.width * (2 ** stage)
    return (base, base * 4) if cfg.block == "bottleneck" else (base, base)


def _blocks(cfg: ResNetConfig, n_stages=None):
    """(stage, block, name, stride) in the reference's order."""
    stages = cfg.stage_sizes if n_stages is None else cfg.stage_sizes[:n_stages]
    for s, n_blocks in enumerate(stages):
        for b in range(n_blocks):
            yield s, b, f"s{s}b{b}", 2 if (b == 0 and s > 0) else 1


def init_resnet(cfg: ResNetConfig, seed: int = 0, *,
                device="cuda") -> Dict[str, Any]:
    """Random fp32 weights with the reference's names and distributions
    (``resnet.py:51-104``), drawn in its order from a ``torch.Generator``
    seeded with ``seed`` on ``device``: He-normal convs
    (``N(0, 2 / (kh*kw*cin))``, stored (out, in, kh, kw)), batch-norm
    scales 1 and biases 0, the head ``N(0, 1/cin)`` (cin, classes) and a
    zero head bias. The numbers differ from ``jax.random``'s; parity tests
    copy JAX weights in with :func:`params_from_numpy`."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def conv(kh, kw, cin, cout):
        return torch.randn((cout, cin, kh, kw), generator=gen,
                           device=dev).mul_((2.0 / (kh * kw * cin)) ** 0.5)

    def bn(c):
        return {"scale": torch.ones(c, device=dev),
                "bias": torch.zeros(c, device=dev)}

    params: Dict[str, Any] = {"stem_conv": conv(7, 7, 3, cfg.width),
                              "stem_bn": bn(cfg.width)}
    cin = cfg.width
    for s, _, name, stride in _blocks(cfg):
        mid, cout = _block_channels(cfg, s)
        blk = {}
        if cfg.block == "bottleneck":
            blk["conv1"], blk["bn1"] = conv(1, 1, cin, mid), bn(mid)
            blk["conv2"], blk["bn2"] = conv(3, 3, mid, mid), bn(mid)
            blk["conv3"], blk["bn3"] = conv(1, 1, mid, cout), bn(cout)
        else:
            blk["conv1"], blk["bn1"] = conv(3, 3, cin, mid), bn(mid)
            blk["conv2"], blk["bn2"] = conv(3, 3, mid, cout), bn(cout)
        if stride != 1 or cin != cout:
            blk["proj"], blk["proj_bn"] = conv(1, 1, cin, cout), bn(cout)
        params[name] = blk
        cin = cout
    params["head"] = torch.randn((cin, cfg.num_classes), generator=gen,
                                 device=dev).mul_(cin ** -0.5)
    params["head_bias"] = torch.zeros(cfg.num_classes, device=dev)
    return params


def _is_conv(name: str) -> bool:
    return name == "stem_conv" or name.startswith("conv") or name == "proj"


def params_from_numpy(tree, device="cuda") -> Dict[str, Any]:
    """The weight bridge: the reference's parameter tree as numpy arrays
    (``split_tree(init_resnet(cfg, key))[0]``) to the port's fp32 masters
    on ``device``, names unchanged, conv weights from HWIO to
    (out, in, kh, kw), contiguous."""
    dev = resolve_device(device)

    def walk(sub):
        out = {}
        for k, v in sub.items():
            if isinstance(v, dict):
                out[k] = walk(v)
                continue
            a = np.asarray(v, np.float32)
            if _is_conv(k):
                a = a.transpose(3, 2, 0, 1)
            out[k] = torch.tensor(np.ascontiguousarray(a)).to(dev)
        return out

    return walk(tree)


def params_to_numpy(params) -> Dict[str, Any]:
    """The bridge back: the port's parameters (or gradients) as numpy in
    the reference's layout (conv weights HWIO)."""
    out = {}
    for k, v in params.items():
        if isinstance(v, dict):
            out[k] = params_to_numpy(v)
        else:
            a = v.detach().float().cpu().numpy()
            out[k] = a.transpose(2, 3, 1, 0) if _is_conv(k) else a
    return out


def same_pads(size: int, k: int, stride: int) -> Tuple[int, int]:
    """XLA ``"SAME"`` padding of one spatial dim: (lo, hi), the odd one at
    the end (``spatial_partitioning.py:73-78`` computes the same split)."""
    total = max((-(-size // stride) - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _pad_nchw(x, k: int, stride: int, value: float = 0.0):
    """x (B, C, H, W) padded for a k x k window at ``stride``, SAME."""
    (hl, hh), (wl, wh) = (same_pads(x.shape[2], k, stride),
                          same_pads(x.shape[3], k, stride))
    if hl == hh == wl == wh == 0:
        return x
    return F.pad(x, (wl, wh, hl, hh), value=value)


def same_conv(x, w, stride: int, dtype: torch.dtype):
    """SAME conv of NHWC ``x`` with w (out, in, kh, kw), both cast to
    ``dtype``; returns NHWC (a channels-last view)."""
    xn = _pad_nchw(x.to(dtype).permute(0, 3, 1, 2), w.shape[2], stride)
    return F.conv2d(xn, w.to(dtype), stride=stride).permute(0, 2, 3, 1)


def conv(x, w, stride: int, cfg: ResNetConfig):
    """:func:`same_conv` in ``cfg.dtype``."""
    return same_conv(x, w, stride, _dt(cfg))


def max_pool(x):
    """3 x 3 stride-2 SAME max pool of NHWC ``x``, -inf padding."""
    xn = _pad_nchw(x.permute(0, 3, 1, 2), 3, 2, value=float("-inf"))
    return F.max_pool2d(xn, 3, 2).permute(0, 2, 3, 1)


def _bn(x, bnp):
    return batch_norm(x, bnp["scale"], bnp["bias"])[0]


def _stem(params, cfg, images):
    x = conv(images, params["stem_conv"], cfg.stem_stride, cfg)
    x = torch.relu(_bn(x, params["stem_bn"]))
    return max_pool(x) if cfg.stem_pool else x


def _block(blk, cfg, x, stride):
    sc = x
    if "proj" in blk:
        sc = _bn(conv(x, blk["proj"], stride, cfg), blk["proj_bn"])
    if cfg.block == "bottleneck":  # v1.5: stride on the 3x3 conv
        y = torch.relu(_bn(conv(x, blk["conv1"], 1, cfg), blk["bn1"]))
        y = torch.relu(_bn(conv(y, blk["conv2"], stride, cfg), blk["bn2"]))
        y = _bn(conv(y, blk["conv3"], 1, cfg), blk["bn3"])
    else:
        y = torch.relu(_bn(conv(x, blk["conv1"], stride, cfg), blk["bn1"]))
        y = _bn(conv(y, blk["conv2"], 1, cfg), blk["bn2"])
    return torch.relu(sc + y)


def features(params, cfg: ResNetConfig, images, *,
             n_stages=None) -> List[torch.Tensor]:
    """Backbone feature maps, NHWC, one per stage (for SSD)."""
    _check(cfg)
    x = _stem(params, cfg, images)
    feats = []
    for s, b, name, stride in _blocks(cfg, n_stages):
        x = _block(params[name], cfg, x, stride)
        if b == cfg.stage_sizes[s] - 1:  # the stage's last block
            feats.append(x)
    return feats


def forward(params, cfg: ResNetConfig, images):
    """images: (B, H, W, 3) -> logits (B, num_classes), fp32."""
    _check(cfg)
    x = _stem(params, cfg, images)
    for _, _, name, stride in _blocks(cfg):
        x = _block(params[name], cfg, x, stride)
    x = x.mean(dim=(1, 2)).float()  # global average pool
    return x @ params["head"] + params["head_bias"]


def loss_fn(params, cfg: ResNetConfig, batch, *,
            label_smoothing: float = 0.1):
    """batch: {"images": (B, H, W, 3), "labels": (B,)}; cross entropy
    with label smoothing (MLPerf uses 0.1). Returns (loss, {"nll", "acc"})."""
    logits = forward(params, cfg, batch["images"])
    n = cfg.num_classes
    labels = batch["labels"].long()
    onehot = F.one_hot(labels, n).float()
    soft = onehot * (1 - label_smoothing) + label_smoothing / n
    logp = torch.log_softmax(logits.float(), dim=-1)
    loss = -(soft * logp).sum(-1).mean()
    acc = (logits.argmax(-1) == labels).float().mean()
    return loss, {"nll": loss, "acc": acc}

