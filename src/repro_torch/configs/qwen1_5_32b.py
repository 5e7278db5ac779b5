"""qwen1.5-32b [dense] — Alibaba Qwen1.5-32B [hf:Qwen/Qwen1.5-0.5B family].

64L d_model=5120 40H (kv=40) d_ff=27392 vocab=152064, QKV bias. The
port's copy of ``repro/configs/qwen1_5_32b.py`` without
``param_sharding``, which the port's config does not have (one device).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv_heads=40,
    d_ff=27392,
    vocab=152064,
    qkv_bias=True,
    rope_theta=1e6,
    long_context_window=8192,  # sliding-window decode for long contexts
    # Full MHA (kv=40): an int8 KV cache halves the bf16 one.
    kv_cache_dtype="int8",
)
