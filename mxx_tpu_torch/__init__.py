"""mxx_tpu_torch — the PyTorch and CUDA port of `mxx_tpu`, for NVIDIA Hopper.

Same module names as the JAX package, so each part finds its counterpart:
DCRT polynomials are int64[L, n] tensors, matrices int64[L, r, c, n], every
constructor and sampler takes an explicit `device=`, and randomness is the
keyed ChaCha20 stream of the JAX package, bit for bit. The package imports
torch and never jax (nor `mxx_tpu`); the hand-written CUDA kernels under
`csrc/` are built with nvcc at first use.
"""

from .ring.params import RingParams  # noqa: F401

__all__ = ["RingParams"]
__version__ = "0.1.0"
