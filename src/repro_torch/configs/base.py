"""Model config for the port: the ``repro.configs.base`` fields that
the paged serving path and the train step read, with the same names,
defaults and ``reduced()`` rule, so one architecture id builds the same
model on both sides (tests compare every kept field)."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class LayerSpec:
    """One layer of a stack. mixer: 'attn'; ffn: 'dense'."""
    mixer: str = "attn"
    ffn: str = "dense"


@dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    d_ff: int
    vocab: int
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0         # 0 -> d_model // n_heads
    rope_theta: float = 10000.0
    activation: str = "silu"  # 'silu' (SwiGLU) | 'gelu' (GeGLU, tanh form)
    glu: bool = True
    tie_embeddings: bool = False
    block_pattern: Tuple[LayerSpec, ...] = ()
    remat: bool = True                # recompute each layer in backward
    loss_chunk: int = 256             # CE computed in seq chunks of this size
    dtype: str = "bfloat16"           # activation / compute dtype
    param_dtype: str = "float32"      # master weights
    kv_cache_dtype: str = "bfloat16"  # paged pool: bfloat16 | float32 |
    #                                   int8 | int4 (quantized, fp32 scales)
    grad_dtype: str = "float32"       # gradient summation dtype
    moment_dtype: str = "float32"     # Adam moment dtype
    microbatches: int = 1             # gradient-accumulation microbatches

    def __post_init__(self):
        if self.n_heads:
            object.__setattr__(
                self, "head_dim", self.head_dim or self.d_model // self.n_heads)
        if not self.block_pattern:
            object.__setattr__(self, "block_pattern", (LayerSpec(),))
        if self.n_layers % len(self.block_pattern) != 0:
            raise ValueError(
                f"{self.name}: n_layers={self.n_layers} not divisible by "
                f"block_pattern length {len(self.block_pattern)}")

    @property
    def n_blocks(self) -> int:
        return self.n_layers // len(self.block_pattern)

    def reduced(self) -> "ModelConfig":
        """CPU smoke variant: same family and pattern, tiny dims
        (``repro.configs.base.ModelConfig.reduced`` for a dense stack)."""
        pat = self.block_pattern[: max(1, min(2, len(self.block_pattern)))]
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
            remat=False,
            microbatches=1,
        )
