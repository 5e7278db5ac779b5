"""gemma-7b [dense] — Google Gemma 7B [arXiv:2403.08295].

28L d_model=3072 16H (kv=16) d_ff=24576 vocab=256000, GeGLU activation,
head_dim=256 (wider than d_model/n_heads), tied embeddings.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma-7b",
    family="dense",
    n_layers=28,
    d_model=3072,
    n_heads=16,
    n_kv_heads=16,
    head_dim=256,  # 16*256 = 4096 != d_model: o_proj maps 4096 -> 3072
    d_ff=24576,
    vocab=256000,
    activation="gelu",
    glu=True,  # GeGLU
    tie_embeddings=True,
    long_context_window=4096,  # sliding-window decode for long contexts
)
