"""Architecture registry of the port: ``get_config(arch_id)``.

The port covers the attention-only LMs ``gemma-7b``, ``yi-9b``,
``qwen1.5-32b``, ``command-r-35b``, ``mixtral-8x7b`` and ``grok-1-314b``,
the hybrid ``jamba-1.5-large-398b`` and the encoder-decoder
``whisper-medium`` (serving and training); the other architectures of
the JAX package are known by name and refused until they are ported
(ROADMAP.md item 3).
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
    whisper_medium,
    yi_9b,
)
from repro_torch.configs.base import (
    LayerSpec,
    MambaConfig,
    ModelConfig,
    MoEConfig,
)

# arch id -> (module name, config)
_PORTED = {
    "gemma-7b": ("gemma_7b", gemma_7b.CONFIG),
    "yi-9b": ("yi_9b", yi_9b.CONFIG),
    "qwen1.5-32b": ("qwen1_5_32b", qwen1_5_32b.CONFIG),
    "command-r-35b": ("command_r_35b", command_r_35b.CONFIG),
    "mixtral-8x7b": ("mixtral_8x7b", mixtral_8x7b.CONFIG),
    "grok-1-314b": ("grok_1_314b", grok_1_314b.CONFIG),
    "jamba-1.5-large-398b": ("jamba_1_5_large_398b",
                             jamba_1_5_large_398b.CONFIG),
    "whisper-medium": ("whisper_medium", whisper_medium.CONFIG),
}

# The JAX package's other architectures (id -> module name), for the
# error message and module-style ids.
_NOT_PORTED = {
    "rwkv6-3b": "rwkv6_3b",
    "qwen2-vl-7b": "qwen2_vl_7b",
}


def list_archs() -> List[str]:
    return list(_PORTED)


def get_config(arch: str) -> ModelConfig:
    """The config of ``arch`` (an id, or its module-style name)."""
    for arch_id, (module, cfg) in _PORTED.items():
        if arch in (arch_id, module):
            return cfg
    for arch_id, module in _NOT_PORTED.items():
        if arch in (arch_id, module):
            raise NotImplementedError(
                f"arch {arch_id!r} is not ported yet: the PyTorch port "
                f"covers {', '.join(_PORTED)} (the other families are "
                f"ROADMAP.md item 3)")
    raise KeyError(f"unknown arch {arch!r}; known: {list_archs()}")


__all__ = ["LayerSpec", "MambaConfig", "ModelConfig", "MoEConfig",
           "get_config", "list_archs"]
