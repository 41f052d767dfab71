"""Operators with hand-written CUDA kernels (``csrc/``) and their plain
PyTorch versions; the tensor's device picks which one runs."""

import importlib

# each wrapper's launch count: (module of ops, its counter)
_COUNTERS = {"fused_layer_fwd": ("fused_layer", "launches"),
             "fused_layer_bwd": ("fused_layer", "bwd_launches"),
             "layer_wgrad": ("layer_wgrad", "launches"),
             "fused_embed_fwd": ("fused_embed", "launches"),
             "fused_embed_bwd": ("fused_embed", "bwd_launches"),
             "fused_simmim_fwd": ("fused_simmim", "launches"),
             "fused_simmim_bwd": ("fused_simmim", "bwd_launches")}


def _counter(name: str):
    module, attr = _COUNTERS[name]
    return importlib.import_module(f"{__name__}.{module}"), attr


def launch_counts() -> dict:
    """Every kernel wrapper's launch count (kernel launches since the count
    was last set to 0; plain-version calls do not count)."""
    return {name: getattr(*_counter(name)) for name in _COUNTERS}


def reset_launch_counts() -> None:
    """Sets every count of ``launch_counts`` to 0."""
    for name in _COUNTERS:
        setattr(*_counter(name), 0)


def add_launch_counts(delta: dict) -> None:
    """Adds ``delta`` (counts by the names of ``launch_counts``) to the
    counts: a replayed CUDA graph launches the kernels it captured without
    calling their wrappers (``train/superstep.py``)."""
    for name, n in delta.items():
        module, attr = _counter(name)
        setattr(module, attr, getattr(module, attr) + n)
