"""jamba-1.5-large-398b [hybrid] — AI21 Jamba-1.5-Large [arXiv:2403.19887].

72L d_model=8192 64H (GQA kv=8) d_ff=24576 vocab=65536, MoE 16 experts
top-2. Mamba+attention 1:7 interleave (one attention layer per 8-layer
block), MoE on every other layer, no positional encoding. The port's
copy of ``repro/configs/jamba_1_5_large_398b.py``.
"""
from repro_torch.configs.base import (
    LayerSpec,
    MambaConfig,
    ModelConfig,
    MoEConfig,
)

# One Jamba block = 8 layers: attention at position 4, Mamba elsewhere;
# the MoE FFN on odd positions.
_PATTERN = tuple(
    LayerSpec(mixer="attn" if i == 4 else "mamba",
              ffn="moe" if i % 2 == 1 else "dense")
    for i in range(8)
)

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=24576,
    vocab=65536,
    moe=MoEConfig(n_experts=16, top_k=2),
    mamba=MambaConfig(d_state=16, d_conv=4, expand=2),
    block_pattern=_PATTERN,
    rope="none",  # Mamba carries position
    long_context_window=4096,
    grad_dtype="bfloat16",
    moment_dtype="bfloat16",
    microbatches=8,
    param_sharding="fsdp",
)
