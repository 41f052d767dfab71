"""Operators with hand-written CUDA kernels (``csrc/``) and their plain
PyTorch versions; the tensor's device picks which one runs."""
