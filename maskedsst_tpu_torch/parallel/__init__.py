"""Data-parallel training across processes (``torch.distributed``), as the
JAX package's ``parallel/`` mesh; see ``mesh.py``."""
