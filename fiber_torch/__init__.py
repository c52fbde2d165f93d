"""PyTorch / CUDA port of FIBER, beside the JAX package `fiber_tpu`.

Runs on an NVIDIA GPU (CUDA kernels built by hand for Hopper, sm_90a) or,
when the caller asks for the CPU, on the plain PyTorch path.  It imports
neither JAX nor anything of `fiber_tpu`.
"""

from fiber_torch.config import FiberConfig

__all__ = ["FiberConfig"]
