"""maskedsst_tpu_torch — the MaskedSST classifier in PyTorch, with hand-written
CUDA kernels for NVIDIA Hopper (sm_90a).

The JAX package ``maskedsst_tpu`` is the reference this package is held
against; nothing here imports it, JAX or flax. Importing the package loads
no torch module and builds no kernel: kernels are compiled with ``nvcc`` at
their first launch (``ops/_build.py``).
"""

__version__ = "0.1.0"
