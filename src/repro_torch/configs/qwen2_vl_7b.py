"""qwen2-vl-7b [vlm] — Alibaba Qwen2-VL-7B [arXiv:2409.12191].

28L d_model=3584 28H (GQA kv=4) d_ff=18944 vocab=152064, M-RoPE
(multimodal rotary: temporal/height/width sections). The port's copy of
``repro/configs/qwen2_vl_7b.py``.

The ViT vision encoder and projector are a stub: batches and requests
carry precomputed patch embeddings of shape (n_patches, 3584), at most
``n_media_tokens`` of them, prepended to the text.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-7b",
    family="vlm",
    n_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    d_ff=18944,
    vocab=152064,
    qkv_bias=True,
    rope="mrope",
    rope_theta=1e6,
    frontend="vision_patches",
    n_media_tokens=1024,
    long_context_window=4096,  # sliding-window decode for long contexts
    param_sharding="wus",
)
