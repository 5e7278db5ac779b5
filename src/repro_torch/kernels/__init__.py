"""Hand-written Hopper kernels of the port, each beside its plain
PyTorch version (``csrc/`` holds the CUDA sources, ``build`` compiles
them at first use)."""
