"""unicycler_tpu_torch: the PyTorch/CUDA port of unicycler_tpu.

Long-read semi-global alignment on an NVIDIA H100: the same host pipeline
(minimiser seeding, corridor construction, tape layout, CIGAR decode) as
the JAX package, with every TPU kernel on that path rewritten by hand in
CUDA C++ (csrc/*.cu, built with nvcc at first use). Entry points run on
the GPU unless the caller passes device='cpu', which takes the JAX
package's CPU route with the kernels' plain PyTorch versions.

This package imports torch, never jax, and nothing from unicycler_tpu.
"""

__version__ = '0.1.0'
