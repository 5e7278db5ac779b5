"""Architecture registry of the port: ``get_config(arch_id)``.

The port covers every architecture of the JAX package's registry, in its
order: the attention-only LMs ``gemma-7b``, ``yi-9b``, ``qwen1.5-32b``,
``command-r-35b``, ``mixtral-8x7b`` and ``grok-1-314b``, the hybrid
``jamba-1.5-large-398b``, the encoder-decoder ``whisper-medium``, the
attention-free ``rwkv6-3b`` and the vision-language ``qwen2-vl-7b``
(serving and training).
"""
from __future__ import annotations

from typing import List

from repro_torch.configs import (
    command_r_35b,
    gemma_7b,
    grok_1_314b,
    jamba_1_5_large_398b,
    mixtral_8x7b,
    qwen1_5_32b,
    qwen2_vl_7b,
    rwkv6_3b,
    whisper_medium,
    yi_9b,
)
from repro_torch.configs.base import (
    INPUT_SHAPES,
    InputShape,
    LayerSpec,
    MambaConfig,
    ModelConfig,
    MoEConfig,
    RWKV6Config,
)

# arch id -> (module name, config), in the JAX package's order
_PORTED = {
    "jamba-1.5-large-398b": ("jamba_1_5_large_398b",
                             jamba_1_5_large_398b.CONFIG),
    "grok-1-314b": ("grok_1_314b", grok_1_314b.CONFIG),
    "whisper-medium": ("whisper_medium", whisper_medium.CONFIG),
    "mixtral-8x7b": ("mixtral_8x7b", mixtral_8x7b.CONFIG),
    "qwen1.5-32b": ("qwen1_5_32b", qwen1_5_32b.CONFIG),
    "rwkv6-3b": ("rwkv6_3b", rwkv6_3b.CONFIG),
    "gemma-7b": ("gemma_7b", gemma_7b.CONFIG),
    "yi-9b": ("yi_9b", yi_9b.CONFIG),
    "command-r-35b": ("command_r_35b", command_r_35b.CONFIG),
    "qwen2-vl-7b": ("qwen2_vl_7b", qwen2_vl_7b.CONFIG),
}


def list_archs() -> List[str]:
    return list(_PORTED)


def get_config(arch: str) -> ModelConfig:
    """The config of ``arch`` (an id, or its module-style name)."""
    for arch_id, (module, cfg) in _PORTED.items():
        if arch in (arch_id, module):
            return cfg
    raise KeyError(f"unknown arch {arch!r}; known: {list_archs()}")


def get_shape(name: str) -> InputShape:
    return INPUT_SHAPES[name]


__all__ = ["INPUT_SHAPES", "InputShape", "LayerSpec", "MambaConfig",
           "ModelConfig", "MoEConfig", "RWKV6Config", "get_config",
           "get_shape", "list_archs"]
