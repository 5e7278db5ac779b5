"""Architecture registry of the port: ``get_config(arch_id)``.

The port covers ``gemma-7b`` only (serving and training); the other
architectures of the JAX package are known by name and refused until
their slice.
"""
from __future__ import annotations

from typing import List

from repro_torch.configs import gemma_7b
from repro_torch.configs.base import LayerSpec, ModelConfig

_PORTED = {"gemma-7b": gemma_7b.CONFIG}

# The JAX package's other architectures (id -> module name), for the
# error message and module-style ids.
_NOT_PORTED = {
    "jamba-1.5-large-398b": "jamba_1_5_large_398b",
    "grok-1-314b": "grok_1_314b",
    "whisper-medium": "whisper_medium",
    "mixtral-8x7b": "mixtral_8x7b",
    "qwen1.5-32b": "qwen1_5_32b",
    "rwkv6-3b": "rwkv6_3b",
    "yi-9b": "yi_9b",
    "command-r-35b": "command_r_35b",
    "qwen2-vl-7b": "qwen2_vl_7b",
}


def list_archs() -> List[str]:
    return list(_PORTED)


def get_config(arch: str) -> ModelConfig:
    arch = arch.replace("_", "-") if arch == "gemma_7b" else arch
    for arch_id, module in _NOT_PORTED.items():
        if arch in (arch_id, module):
            raise NotImplementedError(
                f"arch {arch_id!r} is not ported yet: the PyTorch port "
                f"covers gemma-7b only (see ROADMAP.md)")
    if arch not in _PORTED:
        raise KeyError(f"unknown arch {arch!r}; known: {list_archs()}")
    return _PORTED[arch]


__all__ = ["LayerSpec", "ModelConfig", "get_config", "list_archs"]
