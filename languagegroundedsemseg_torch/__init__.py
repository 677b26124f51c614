"""PyTorch / CUDA port of languagegroundedsemseg_tpu for NVIDIA Hopper.

The JAX package beside it is the reference. This package imports torch,
numpy and the standard library only — never jax, flax or the JAX package —
and keeps the JAX package's module paths so each counterpart is easy to
find. Entry points run on the card (``device="cuda"``) unless the caller
asks for the CPU.
"""

import os

# Native libraries (CUDA kernels, C++ graph builders) are built at first use
# into this git-ignored directory, never next to their sources.
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")
