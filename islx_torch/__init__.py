"""islx_torch: the PyTorch/CUDA port of islx (bf16 main path on one NVIDIA H100).

The JAX package ``islx`` is the reference; this package imports nothing
from it and nothing of JAX."""
