"""Roofline analysis (``repro.analysis``): analytic FLOPs, HBM-traffic
and memory-budget models, and the three-term roofline that combines them
with the dry run's collective bytes (``launch.dryrun``).

The analytic terms are the reference's, term for term: the model's
6 N D, the attention and scan extras, remat and MoE capacity overheads,
the per-device memory budget and the per-step HBM traffic. They take the
true dtypes and trip counts and need no step at all.

Hardware target: one NVIDIA H100 SXM.

  989 TFLOP/s dense bf16 · 3.35 TB/s HBM3 · 450 GB/s NVLink 4 a card,
  one direction · ``hbm_cap`` the card's ``total_memory`` (79.18 GiB).

``link_bw`` replaces the reference's per-link ``ici_bw``. On the
production meshes a 16-wide axis spans two 8-card NVLink domains, and
between them a card has about 50 GB/s of InfiniBand, so the single
collective term below is optimistic for such an axis. The one-term model
is kept as the reference has it.

The collective bytes are taken as the dry run gives them. The reference
halves them for bf16 configs (``dtype_corr``) because its CPU lowering
widens bf16 to f32; the port's dry run traces fake tensors that keep
their dtypes, so its bytes are already true and no factor applies.
"""
from __future__ import annotations

from typing import Dict, Optional

from repro_torch.configs.base import InputShape, ModelConfig

HW = {
    "peak_flops": 989e12,   # dense bf16 / card
    "hbm_bw": 3.35e12,      # bytes/s / card
    "link_bw": 450e9,       # bytes/s / card, NVLink 4, one direction
    # the card's torch.cuda.get_device_properties(0).total_memory, read
    # by chip_smoke.py's dryrun phase on an "NVIDIA H100 80GB HBM3"
    "hbm_cap": 85_017_493_504,
}

_DT_BYTES = {"bfloat16": 2, "float32": 4, "int8": 1, "int4": 0.5}


def _bytes(dtype: str) -> float:
    return _DT_BYTES[dtype]


def mesh_shape(multi_pod: bool) -> Dict[str, int]:
    return ({"pod": 2, "data": 16, "model": 16} if multi_pod
            else {"data": 16, "model": 16})


def _counts(cfg: ModelConfig, multi_pod: bool):
    ms = mesh_shape(multi_pod)
    model = ms["model"]
    data = ms["data"] * ms.get("pod", 1)
    return data, model, model * data


def _layer_census(cfg: ModelConfig):
    n_attn = sum(1 for s in cfg.block_pattern if s.mixer == "attn")
    n_mamba = sum(1 for s in cfg.block_pattern if s.mixer == "mamba")
    n_rwkv = sum(1 for s in cfg.block_pattern if s.mixer == "rwkv6")
    per = cfg.n_blocks
    out = {"attn": n_attn * per, "mamba": n_mamba * per,
           "rwkv6": n_rwkv * per}
    if cfg.is_encdec:
        out["attn"] += cfg.n_enc_layers + cfg.n_layers  # enc self + cross
    return out


# --------------------------------------------------------------------------- #
# FLOPs.
# --------------------------------------------------------------------------- #
def _attn_ctx(S: int, window, attn_impl: str) -> float:
    """Effective visible context per query: S for ``masked_full`` (every
    key visited and masked); for ``block_skip`` the causal band, S/2, or
    the window."""
    if attn_impl == "masked_full":
        return S
    return min(window, S) if window else S / 2


def analytic_flops(cfg: ModelConfig, shape: InputShape,
                   multi_pod: bool = False,
                   attn_impl: str = "block_skip") -> Dict[str, float]:
    """Per-step FLOPs: the model's 6 N_active D, the attention and scan
    extras, the remat and capacity overheads; global and per device."""
    data, model, devices = _counts(cfg, multi_pod)
    census = _layer_census(cfg)
    B, S = shape.global_batch, shape.seq_len
    hd, H = cfg.head_dim, cfg.n_heads
    window = cfg.effective_window(shape)

    if shape.kind == "train":
        tokens = B * S
        model_flops = 6 * cfg.active_param_count() * tokens
        # score and value products: forward 4 B S ctx H hd; training is the
        # forward, a backward of twice it, and the remat recompute: 12
        ctx = _attn_ctx(S, window, attn_impl)
        attn = 12 * B * S * ctx * H * hd * census["attn"]
        m = cfg.mamba
        scan = 0.0
        if census["mamba"] and m:
            scan += 9 * B * S * (m.expand * cfg.d_model) * m.d_state \
                * census["mamba"] * 4  # 9-op recurrence, x4 to train
        if census["rwkv6"] and cfg.rwkv6:
            dh = cfg.rwkv6.head_dim
            scan += 4 * B * S * cfg.d_model * dh * census["rwkv6"] * 4
        # remat recomputes the forward of the matmul stack: + 2 N D
        overhead = (2 * cfg.active_param_count() * tokens) if cfg.remat else 0
        if cfg.uses_moe:  # capacity padding of the expert FFNs
            overhead += (cfg.moe.capacity_factor - 1.0) * 6 \
                * cfg.active_param_count() * tokens * 0.5
        total = model_flops + attn + scan + overhead
        eff_dev = devices
    elif shape.kind == "prefill":
        tokens = B * S
        model_flops = 2 * cfg.active_param_count() * tokens
        ctx = _attn_ctx(S, window, attn_impl)
        attn = 4 * B * S * ctx * H * hd * census["attn"]
        total = model_flops + attn
        eff_dev = devices
    else:  # decode: one token against the cache
        tokens = B
        model_flops = 2 * cfg.active_param_count() * tokens
        L = min(window or S, S)
        attn = 4 * B * L * H * hd * census["attn"]
        total = model_flops + attn
        eff_dev = model * min(data, B)
    return {
        "model_flops": float(model_flops),
        "total_flops": float(total),
        "flops_per_device": float(total / eff_dev),
        "effective_devices": eff_dev,
    }


# --------------------------------------------------------------------------- #
# Decode-cache bytes.
# --------------------------------------------------------------------------- #
def cache_bytes(cfg: ModelConfig, shape: InputShape) -> float:
    census = _layer_census(cfg)
    B, S = shape.global_batch, shape.seq_len
    window = cfg.effective_window(shape)
    L = min(window or S, S)
    kvb = _bytes(cfg.kv_cache_dtype)
    total = census["attn"] * B * L * cfg.n_kv_heads * cfg.head_dim * 2 * kvb
    if cfg.kv_cache_dtype in ("int8", "int4"):
        total += census["attn"] * B * L * cfg.n_kv_heads * 2 * 4  # scales
    total += census["attn"] * B * L * 4  # slot_pos
    if census["mamba"] and cfg.mamba:
        di = cfg.mamba.expand * cfg.d_model
        total += census["mamba"] * B * (di * cfg.mamba.d_state * 4
                                        + (cfg.mamba.d_conv - 1) * di * 2)
    if census["rwkv6"] and cfg.rwkv6:
        dh = cfg.rwkv6.head_dim
        H = cfg.d_model // dh
        total += census["rwkv6"] * B * (H * dh * dh * 4 + 2 * cfg.d_model)
    if cfg.is_encdec:  # the cross-attention cache over the source
        total += cfg.n_layers * B * cfg.enc_source_len \
            * cfg.n_kv_heads * cfg.head_dim * 2 * kvb
    return float(total)


# --------------------------------------------------------------------------- #
# Per-device memory budget (the "fits 80 GB" criterion).
# --------------------------------------------------------------------------- #
def analytic_memory(cfg: ModelConfig, shape: InputShape,
                    multi_pod: bool = False) -> Dict[str, float]:
    data, model, devices = _counts(cfg, multi_pod)
    N = cfg.param_count()
    mode = cfg.param_sharding
    param_shards = model * (data if mode == "fsdp" else 1)
    opt_shards = model * (data if mode in ("fsdp", "wus") else 1)

    out: Dict[str, float] = {}
    if shape.kind == "train":
        out["master_params"] = N * 4 / param_shards
        out["adam_moments"] = 2 * N * _bytes(cfg.moment_dtype) / opt_shards
        out["grads"] = N * _bytes(cfg.grad_dtype) / param_shards
        B_loc = max(1, shape.global_batch // (data * cfg.microbatches))
        act = cfg.n_blocks * B_loc * shape.seq_len * cfg.d_model * 2
        out["act_checkpoints"] = act / (model if cfg.seq_parallel else 1)
        # transient: one gathered layer (bf16, model-sharded) and one CE
        # chunk of fp32 logits
        out["gathered_layer"] = 2 * N / max(cfg.n_layers, 1) / model
        out["logit_chunk"] = B_loc * cfg.loss_chunk * cfg.vocab * 4 / model
        # the attention backward's working set (chunk stash, fp32)
        ctx = min(cfg.effective_window(shape) or shape.seq_len,
                  shape.seq_len)
        heads_loc = max(1, cfg.n_heads // model)
        out["attn_workspace"] = B_loc * shape.seq_len * min(ctx, 2048) \
            * heads_loc * 4
    else:
        out["serve_params"] = N * 2 / param_shards
        cb = cache_bytes(cfg, shape)
        batch_shards = min(data, shape.global_batch)
        kv_div = model if (cfg.n_kv_heads and
                           (cfg.n_kv_heads % model == 0
                            or shape.seq_len % model == 0)) else 1
        out["cache"] = cb / (batch_shards * kv_div)
        B_loc = max(1, shape.global_batch // data)
        out["logits"] = B_loc * cfg.vocab * 4 / model
        if shape.kind == "prefill":
            out["activations"] = B_loc * shape.seq_len * cfg.d_model * 2 \
                / (model if cfg.seq_parallel else 1)
    out["total"] = float(sum(out.values()))
    out["fits_80GB"] = out["total"] < HW["hbm_cap"]
    return out


# --------------------------------------------------------------------------- #
# HBM traffic per step (the memory term).
# --------------------------------------------------------------------------- #
def analytic_hbm_traffic(cfg: ModelConfig, shape: InputShape,
                         multi_pod: bool = False) -> float:
    data, model, devices = _counts(cfg, multi_pod)
    N = cfg.param_count()
    mem = analytic_memory(cfg, shape, multi_pod)
    if shape.kind == "train":
        # weights read forward and backward (bf16), gradients written,
        # the optimizer's reads and writes
        param_traffic = (2 * (2 * N / model)
                         + mem["grads"] * 2 + mem["master_params"] * 2
                         + mem["adam_moments"] * 2)
        act_traffic = 4 * mem["act_checkpoints"] * cfg.microbatches
        return float(param_traffic + act_traffic)
    if shape.kind == "prefill":
        return float(2 * N / devices * 2 + mem.get("activations", 0) * 4)
    # decode: every (sharded) weight and the whole cache shard read once
    return float(mem["serve_params"] + mem["cache"] + mem["logits"])


# --------------------------------------------------------------------------- #
# Three-term roofline.
# --------------------------------------------------------------------------- #
def roofline(cfg: ModelConfig, shape: InputShape, dryrun: Optional[dict],
             multi_pod: bool = False, attn_impl: str = "block_skip") -> Dict:
    """Compute, memory and collective seconds of one step on one card,
    and the dominant term. ``dryrun`` (a ``launch.dryrun`` result, or
    None) gives the collective bytes and the traced flops."""
    fl = analytic_flops(cfg, shape, multi_pod, attn_impl)
    mem = analytic_memory(cfg, shape, multi_pod)
    traffic = analytic_hbm_traffic(cfg, shape, multi_pod)

    compute_s = fl["flops_per_device"] / HW["peak_flops"]
    memory_s = traffic / HW["hbm_bw"]

    coll_bytes = 0.0
    traced_flops = None
    if dryrun and "collective_bytes_per_device" in dryrun:
        coll_bytes = float(sum(dryrun["collective_bytes_per_device"].values()))
        traced_flops = dryrun.get("flops_per_device")
    collective_s = coll_bytes / HW["link_bw"]  # no dtype factor: see above

    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    return {
        "arch": cfg.name,
        "shape": shape.name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "compute_s": compute_s,
        "memory_s": memory_s,
        "collective_s": collective_s,
        "dominant": max(terms, key=terms.get),
        "model_flops": fl["model_flops"],
        "analytic_flops_per_device": fl["flops_per_device"],
        "traced_flops_per_device": traced_flops,
        "collective_bytes_per_device": coll_bytes,
        "useful_ratio": fl["model_flops"] / fl["total_flops"],
        "mem_budget_GiB": mem["total"] / 2 ** 30,
        "fits_80GB": bool(mem["fits_80GB"]),
    }
