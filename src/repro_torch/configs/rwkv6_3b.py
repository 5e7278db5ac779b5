"""rwkv6-3b [ssm] — RWKV-6 "Finch" 3B [arXiv:2404.05892].

32L d_model=2560 (attention-free) d_ff=8960 vocab=65536, data-dependent
decay through a low-rank projection, squared-ReLU channel mix. The
port's copy of ``repro/configs/rwkv6_3b.py`` without
``param_sharding``, which the port's config does not have (one device).
"""
from repro_torch.configs.base import ModelConfig, RWKV6Config

CONFIG = ModelConfig(
    name="rwkv6-3b",
    family="ssm",
    n_layers=32,
    d_model=2560,
    n_heads=0,
    n_kv_heads=0,
    d_ff=8960,
    vocab=65536,
    rwkv6=RWKV6Config(head_dim=64, decay_lora_dim=64),
    rope="none",
    activation="relu2",  # the channel mix's squared ReLU
    glu=False,
)
