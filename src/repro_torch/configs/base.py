"""Model config for the port: the ``repro.configs.base`` fields that
the serving path and the train step read, with the same names, defaults
and ``reduced()`` rule, so one architecture id builds the same model on
both sides (tests compare every kept field)."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts FFN (switch/mixtral-style top-k routing)."""
    n_experts: int
    top_k: int = 2
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.01


@dataclass(frozen=True)
class MambaConfig:
    """Mamba (S6) mixer [arXiv:2312.00752], used by hybrid stacks."""
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0  # 0 -> ceil(d_model / 16)


@dataclass(frozen=True)
class RWKV6Config:
    """RWKV-6 "Finch" mixer [arXiv:2404.05892]."""
    head_dim: int = 64
    decay_lora_dim: int = 64  # low-rank dim of the data-dependent decay


@dataclass(frozen=True)
class LayerSpec:
    """One layer of a (possibly heterogeneous) stack.

    mixer: 'attn' | 'mamba' | 'rwkv6'; ffn: 'dense' | 'moe' | 'none'.
    """
    mixer: str = "attn"
    ffn: str = "dense"


@dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    d_ff: int
    vocab: int
    family: str = "dense"     # 'dense' | 'moe' | 'ssm' | 'hybrid' | ...
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0         # 0 -> d_model // n_heads
    qkv_bias: bool = False    # biases on the q, k and v projections
    rope: str = "rope"        # 'rope' | 'mrope' (multimodal, 3 position
    #                           streams) | 'none' (no positional encoding)
    rope_theta: float = 10000.0
    norm: str = "rmsnorm"     # 'rmsnorm' | 'layernorm'
    activation: str = "silu"  # 'silu' (SwiGLU) | 'gelu' (GeGLU, tanh form)
    #                           | 'relu' | 'relu2' (squared ReLU)
    glu: bool = True
    tie_embeddings: bool = False
    sliding_window: Optional[int] = None   # native sliding-window attention
    # Window used only for the long-context decode variant on archs whose
    # native attention is full and causal.
    long_context_window: Optional[int] = None
    moe: Optional[MoEConfig] = None
    mamba: Optional[MambaConfig] = None
    rwkv6: Optional[RWKV6Config] = None
    block_pattern: Tuple[LayerSpec, ...] = ()
    # Encoder-decoder (audio family): encoder layer count + source length.
    n_enc_layers: int = 0
    enc_source_len: int = 0
    # Modality frontend stub: 'none' | 'audio_frames' | 'vision_patches';
    # batches carry precomputed embeddings of shape (B, n_media, d).
    frontend: str = "none"
    n_media_tokens: int = 0
    # Distribution defaults (the sharded trainer, ``dist.spmd``).
    param_sharding: str = "fsdp"      # 'replicated' | 'wus' | 'fsdp'
    remat: bool = True                # recompute each layer in backward
    seq_parallel: bool = True         # residual stream's sequence over
    #                                   the model axis between blocks
    loss_chunk: int = 256             # CE computed in seq chunks of this size
    dtype: str = "bfloat16"           # activation / compute dtype
    param_dtype: str = "float32"      # master weights
    kv_cache_dtype: str = "bfloat16"  # KV cache: bfloat16 | float32 |
    #                                   int8 | int4 (quantized, fp32 scales;
    #                                   int4 on the paged layout only)
    grad_dtype: str = "float32"       # gradient summation dtype
    moment_dtype: str = "float32"     # Adam moment dtype
    microbatches: int = 1             # gradient-accumulation microbatches

    def __post_init__(self):
        if self.n_heads:
            object.__setattr__(
                self, "head_dim", self.head_dim or self.d_model // self.n_heads)
        if not self.block_pattern:
            if self.family == "ssm":
                mixer = "rwkv6" if self.rwkv6 is not None else "mamba"
            else:
                mixer = "attn"
            ffn = "moe" if self.moe is not None else "dense"
            object.__setattr__(self, "block_pattern", (LayerSpec(mixer, ffn),))
        if self.n_layers % len(self.block_pattern) != 0:
            raise ValueError(
                f"{self.name}: n_layers={self.n_layers} not divisible by "
                f"block_pattern length {len(self.block_pattern)}")

    @property
    def n_blocks(self) -> int:
        return self.n_layers // len(self.block_pattern)

    @property
    def uses_moe(self) -> bool:
        return any(s.ffn == "moe" for s in self.block_pattern)

    @property
    def is_encdec(self) -> bool:
        return self.n_enc_layers > 0

    def reduced(self) -> "ModelConfig":
        """CPU smoke variant: same family and pattern, tiny dims
        (``repro.configs.base.ModelConfig.reduced``): up to 4 distinct
        (mixer, ffn) kinds kept, at most 4 experts at a no-drop capacity
        factor, windows capped at 64, at most 2 encoder layers over at
        most 64 source frames and 16 media tokens, RWKV-6 heads of 32
        with a decay rank of 16."""
        pat = self.block_pattern[: max(1, min(2, len(self.block_pattern)))]
        kinds = {(s.mixer, s.ffn) for s in self.block_pattern}
        if len(kinds) > len(pat):
            seen, keep = set(), []
            for s in self.block_pattern:
                k = (s.mixer, s.ffn)
                if k not in seen:
                    seen.add(k)
                    keep.append(s)
                if len(keep) == 4:
                    break
            pat = tuple(keep)
        d_model = min(self.d_model, 256)
        n_heads = min(self.n_heads, 4) if self.n_heads else 0
        n_kv = min(self.n_kv_heads, n_heads) if self.n_kv_heads else 0
        if n_kv:
            n_kv = max(1, min(n_kv, n_heads))
            while n_heads % n_kv:
                n_kv -= 1
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            n_layers=len(pat),
            block_pattern=tuple(pat),
            d_model=d_model,
            d_ff=min(self.d_ff, 512),
            vocab=min(self.vocab, 1024),
            n_heads=n_heads,
            n_kv_heads=n_kv,
            head_dim=(d_model // n_heads) if n_heads else 0,
            # capacity factor = n_experts: no token is ever dropped
            moe=None if self.moe is None else dataclasses.replace(
                self.moe, n_experts=min(self.moe.n_experts, 4),
                capacity_factor=float(min(self.moe.n_experts, 4))),
            rwkv6=None if self.rwkv6 is None else dataclasses.replace(
                self.rwkv6, head_dim=32, decay_lora_dim=16),
            n_enc_layers=min(self.n_enc_layers, 2),
            enc_source_len=min(self.enc_source_len, 64) or 0,
            n_media_tokens=min(self.n_media_tokens, 16),
            sliding_window=None if self.sliding_window is None else 64,
            long_context_window=(None if self.long_context_window is None
                                 else 64),
            param_sharding="replicated",
            remat=False,
            microbatches=1,
        )

    def param_count(self) -> int:
        """Analytic parameter count (``repro.configs.base``'s rule for
        attention, Mamba and RWKV-6 mixers, dense and MoE FFNs, and an
        enc-dec stack's encoder layers and cross-attention)."""
        d, f, v = self.d_model, self.d_ff, self.vocab
        total = v * d + (0 if self.tie_embeddings else v * d)
        for spec in self.block_pattern:
            mixer = 0
            if spec.mixer == "attn":
                hd = self.head_dim
                mixer = (d * (self.n_heads * hd) * 2
                         + d * (self.n_kv_heads * hd) * 2)
            elif spec.mixer == "mamba":
                m = self.mamba or MambaConfig()
                di = m.expand * d
                dt_rank = m.dt_rank or -(-d // 16)
                mixer = (d * di * 2 + di * m.d_conv
                         + di * (dt_rank + 2 * m.d_state) + dt_rank * di
                         + di * m.d_state + di + di * d)
            elif spec.mixer == "rwkv6":
                r = self.rwkv6 or RWKV6Config()
                mixer = d * d * 4 + 2 * d * r.decay_lora_dim + d * 6
            if spec.ffn == "dense":
                ffn = d * f * (3 if self.glu else 2)
            elif spec.ffn == "moe":
                ffn = (self.moe.n_experts * d * f * (3 if self.glu else 2)
                       + d * self.moe.n_experts)
            else:
                ffn = 0
            total += self.n_blocks * (mixer + ffn)
        if self.is_encdec:
            # encoder layers: self-attention + dense FFN; each decoder
            # layer adds a cross-attention
            hd = self.head_dim
            attn = d * (self.n_heads * hd) * 2 + d * (self.n_kv_heads * hd) * 2
            total += self.n_enc_layers * (attn + d * f * (3 if self.glu else 2))
            total += self.n_layers * attn
        return int(total)
