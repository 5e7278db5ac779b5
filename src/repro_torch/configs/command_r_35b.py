"""command-r-35b [dense] — Cohere Command-R [hf:CohereForAI/c4ai-command-r-v01].

40L d_model=8192 64H (GQA kv=8) d_ff=22528 vocab=256000, no biases,
layernorm, tied embeddings. The port's copy of
``repro/configs/command_r_35b.py`` without ``param_sharding``, which the
port's config does not have (one device).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="command-r-35b",
    family="dense",
    n_layers=40,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22528,
    vocab=256000,
    norm="layernorm",
    tie_embeddings=True,
    rope_theta=4e6,
    long_context_window=4096,  # sliding-window decode for long contexts
)
