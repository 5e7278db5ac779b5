"""PyTorch + CUDA port of ``repro`` for one NVIDIA H100.

The JAX package ``repro`` stays the reference; this package keeps its
own copies of what it needs and imports nothing of it. Slice 1 covers
paged serving of ``gemma-7b``: configs, the paged-attention kernel
(hand-written CUDA C++ for ``sm_90a``), the decoder layers, the paged
KV pool, the scheduler and the continuous-batching engine. Slice 2
trains it: the flash-attention forward and backward kernels, the
full-sequence forward with remat and chunked loss, Adam under a cosine
warmup, the train and eval steps, the ``Trainer`` and its CLI. Later
slices serve from int8/int4 pools (the paged kernel's quantized
branches), train GNMT through the LSTM cell kernels, train ResNet-50
v1.5 with LARS through the ``lars_update`` kernels, and serve
``jamba-1.5-large`` (Mamba, MoE and attention layers) through the
slot-slab layout, its Mamba prefill through the ``mamba_scan`` kernel,
and train it through that kernel and its backward kernel.
The serving engine samples at a temperature with counter-based keys bit
for bit those of ``jax.random`` (:mod:`repro_torch.random`); the trainer
saves and resumes checkpoints in the reference's format and reads the
streaming input pipeline (:mod:`repro_torch.data`) through a
double-buffered input stage.

Entry points take ``device`` (default ``"cuda"``) and refuse to fall
back to the CPU when no card is present; tests pass ``device="cpu"``,
where every kernel's plain PyTorch version runs instead.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises when it names CUDA and
    no card is visible, so an entry point never runs quietly on the
    CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available in this process; pass device='cpu' "
            "(--device cpu) to run the plain PyTorch path on the CPU")
    return dev
