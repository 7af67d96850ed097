"""kasportsformer_torch: the PyTorch/CUDA port of kasportsformer_tpu.

The JAX package stays the reference; this package computes the same
functions in PyTorch, with hand-written CUDA kernels for Hopper (sm_90a) in
place of the JAX package's Pallas kernels. Entry points run on the GPU
unless the caller passes device='cpu'. The package imports nothing of JAX or
of kasportsformer_tpu. Importing it starts nothing and builds nothing: the
kernels are compiled at first use.
"""

__version__ = "0.1.0"
