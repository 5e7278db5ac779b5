"""grok-1-314b [moe] — xAI Grok-1 [hf:xai-org/grok-1].

64L d_model=6144 48H (GQA kv=8) d_ff=32768 vocab=131072, MoE 8 experts
top-2; bf16 gradient sums and Adam moments, 4 microbatches. The port's
copy of ``repro/configs/grok_1_314b.py``.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="grok-1-314b",
    family="moe",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=32768,
    vocab=131072,
    moe=MoEConfig(n_experts=8, top_k=2),
    long_context_window=4096,  # sliding-window decode for long contexts
    grad_dtype="bfloat16",
    moment_dtype="bfloat16",
    microbatches=4,
    param_sharding="fsdp",
)
