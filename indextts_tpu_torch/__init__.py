"""indextts_tpu_torch — the PyTorch + CUDA port of indextts_tpu for one NVIDIA H100.

The module layout and names follow indextts_tpu/, so each module's JAX
counterpart is easy to find; that package is the reference the port is held
against (tests/test_torch_*.py). The port imports torch and never jax.
Kernels written by hand for Hopper live in csrc/ and are bound in ops/cuda/.
"""

__version__ = "0.1.0"
