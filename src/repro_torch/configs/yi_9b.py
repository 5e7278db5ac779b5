"""yi-9b [dense] — 01.AI Yi-9B [arXiv:2403.04652].

48L d_model=4096 32H (GQA kv=4) d_ff=11008 vocab=64000, llama
architecture. The port's copy of ``repro/configs/yi_9b.py``.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="yi-9b",
    family="dense",
    n_layers=48,
    d_model=4096,
    n_heads=32,
    n_kv_heads=4,
    d_ff=11008,
    vocab=64000,
    long_context_window=4096,  # sliding-window decode for long contexts
    param_sharding="wus",
)
