"""mixtral-8x7b [moe] — Mistral Mixtral-8x7B [arXiv:2401.04088].

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000, MoE 8 experts
top-2, native sliding-window attention (window 4096). The port's copy of
``repro/configs/mixtral_8x7b.py`` without ``param_sharding``, which the
port's config does not have (one device). As in the reference, the
window is a config field that serving (``Engine``) and the train loss
do not apply: both attend fully and causally.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=32000,
    moe=MoEConfig(n_experts=8, top_k=2),
    sliding_window=4096,
    rope_theta=1e6,
)
