"""Map the JAX package's flax parameter trees onto this package's
``state_dict`` and back.

The port's modules carry the flax names (``to_patch_embedding``,
``spatial_transformer``, ``attn/to_qkv``, ``head_linear``, ...), so the
mapping is by rule rather than by table:

* a nested dict path ``a/b/c`` is the dotted key ``a.b.c``;
* ``layers_<i>`` is the ``nn.ModuleList`` entry ``layers.<i>``;
* a LayerNorm ``scale`` is ``weight``;
* a Dense ``kernel`` [in, out] is an ``nn.Linear`` ``weight`` [out, in],
  transposed; a stacked 3-D kernel (the embedding's ``blockwise_kernel``
  [g, p, d], the SimMIM decoder's ``to_pixels/kernel`` [g, d, p]) keeps
  its name and layout;
* everything else (``bias``, ``pos_embed``, ``channel_embed``, ...) keeps
  its name.

The fused and unfused JAX transformers declare identical trees, so one
mapping serves both, and the SimMIM tree (``encoder/...``, ``mask_token``,
``to_pixels/{kernel,bias}``) maps by the same rules; ``grads_to_flax``
maps a model's gradients the same way, for comparing them leaf by leaf
with ``jax.grad``. Leaves are numpy arrays on the flax side and CPU tensors
on the port's side; the round trip is exact.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping

import numpy as np
import torch

_LAYER = re.compile(r"^layers_(\d+)$")


def params_from_flax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax ``params`` tree (numpy leaves) → this package's ``state_dict``."""
    out: Dict[str, torch.Tensor] = {}

    def walk(node, path):
        if isinstance(node, Mapping):
            for key, child in node.items():
                m = _LAYER.match(key)
                walk(child, path + (["layers", m.group(1)] if m else [key]))
            return
        arr = np.asarray(node)
        name = path[-1]
        if name == "kernel" and arr.ndim == 2:  # Dense [in, out] → Linear.weight [out, in]
            path, arr = path[:-1] + ["weight"], arr.T
        elif name == "scale":
            path = path[:-1] + ["weight"]
        out[".".join(path)] = torch.tensor(arr)  # a copy: flax leaves may be read-only

    walk(tree, [])
    return out


def grads_to_flax(model: torch.nn.Module) -> Dict[str, Any]:
    """The ``.grad`` of every parameter that has one, as a flax tree."""
    return flax_from_params(
        {n: p.grad for n, p in model.named_parameters() if p.grad is not None}
    )


def flax_from_params(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """This package's ``state_dict`` → flax ``params`` tree (numpy leaves)."""
    tree: Dict[str, Any] = {}
    for key, value in state_dict.items():
        arr = value.detach().cpu().numpy()
        parts = key.split(".")
        path = []
        i = 0
        while i < len(parts):
            if parts[i] == "layers" and i + 1 < len(parts) and parts[i + 1].isdigit():
                path.append(f"layers_{parts[i + 1]}")
                i += 2
            else:
                path.append(parts[i])
                i += 1
        if path[-1] == "weight":
            if arr.ndim == 2:  # Linear.weight [out, in] → Dense kernel [in, out]
                path[-1], arr = "kernel", arr.T
            else:
                path[-1] = "scale"
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = np.array(arr, order="C")  # a copy: never the tensor's memory
    return tree
