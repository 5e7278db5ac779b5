"""whisper-medium [audio] — OpenAI Whisper medium [arXiv:2212.04356].

24L d_model=1024 16H (kv=16) d_ff=4096 vocab=51865. Encoder-decoder;
the mel-spectrogram + conv frontend is a stub: batches carry
precomputed frame embeddings of shape (B, 1500, 1024). The port's copy
of ``repro/configs/whisper_medium.py`` without ``param_sharding``,
which the port's config does not have (one device).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium",
    family="audio",
    n_layers=24,        # decoder layers
    n_enc_layers=24,    # encoder layers
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab=51865,
    qkv_bias=True,
    norm="layernorm",
    activation="gelu",
    glu=False,
    rope="none",        # sinusoidal absolute positions
    enc_source_len=1500,
    frontend="audio_frames",
    n_media_tokens=1500,
)
