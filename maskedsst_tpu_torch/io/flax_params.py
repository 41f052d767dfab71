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

The DeepHyperX zoo's variables (``params`` and ``batch_stats``) map through
``zoo_state_from_flax`` and back through ``zoo_flax_from_state`` (below).
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


# --- the DeepHyperX zoo ------------------------------------------------------
#
# The JAX zoo's variables are {"params", "batch_stats"}; its module names are
# the reference's with "." → "_" (``encoder_0``), and its ``Conv3d`` /
# ``Conv2d`` wrappers nest their kernel one level down (``conv1/Conv_0``).
# Conv kernels [*k, in, out] are [out, in, *k] here, dense kernels are
# transposed, BatchNorm ``scale`` / ``mean`` / ``var`` are ``weight`` /
# ``running_mean`` / ``running_var``, and the GRU's ``weight_ih`` [in, 3H] is
# ``nn.GRU``'s ``weight_ih_l0`` [3H, in] (gate order r, z, n in both).

_WRAPPER = re.compile(r"^Conv_\d+$")
_SEQ = re.compile(r"^(encoder)_(\d+)$")
_GRU = {"weight_ih": "weight_ih_l0", "weight_hh": "weight_hh_l0", "bias_ih": "bias_ih_l0",
        "bias_hh": "bias_hh_l0"}
_GRU_BACK = {v: k for k, v in _GRU.items()}


def _zoo_module_name(flax_name: str) -> str:
    m = _SEQ.match(flax_name)
    return f"{m.group(1)}.{m.group(2)}" if m else flax_name


def zoo_state_from_flax(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX zoo ``variables`` (numpy leaves) → the port net's ``state_dict``."""
    out: Dict[str, torch.Tensor] = {}

    def walk(node, path, stats):
        for key, child in node.items():
            if isinstance(child, Mapping):
                walk(child, path if _WRAPPER.match(key) else path + [_zoo_module_name(key)], stats)
                continue
            arr = np.asarray(child)
            if stats:
                name = {"mean": "running_mean", "var": "running_var"}[key]
            elif key in _GRU:
                name, arr = _GRU[key], arr.T if arr.ndim == 2 else arr
            elif key == "kernel":
                name = "weight"
                arr = arr.T if arr.ndim == 2 else np.transpose(
                    arr, (arr.ndim - 1, arr.ndim - 2, *range(arr.ndim - 2)))
            else:
                name = "weight" if key == "scale" else key
            out[".".join(path + [name])] = torch.tensor(np.ascontiguousarray(arr))

    walk(variables["params"], [], False)
    walk(variables.get("batch_stats", {}), [], True)
    return out


def zoo_flax_from_state(state_dict: Mapping[str, torch.Tensor],
                        like: Mapping[str, Any]) -> Dict[str, Any]:
    """The port net's ``state_dict`` (or any subset of it, e.g. gradients by
    parameter name) → JAX zoo variables, nested as ``like`` (a JAX
    ``params`` tree, or variables holding one) nests its conv wrappers."""
    like = like.get("params", like)
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    for key, value in state_dict.items():
        arr = value.detach().cpu().numpy()
        *mods, leaf = key.split(".")
        if mods[:1] == ["encoder"]:
            mods = [f"encoder_{mods[1]}"] + mods[2:]
        path, node = list(mods), like
        for m in mods:
            node = node[m]
        inner = [k for k in node if _WRAPPER.match(k)]
        if inner and "kernel" not in node:
            path.append(inner[0])
        if leaf in ("running_mean", "running_var"):
            tree, name = stats, {"running_mean": "mean", "running_var": "var"}[leaf]
        elif leaf in _GRU_BACK:
            tree, name, arr = params, _GRU_BACK[leaf], arr.T if arr.ndim == 2 else arr
        elif leaf == "weight" and arr.ndim == 1:
            tree, name = params, "scale"
        elif leaf == "weight":
            tree, name = params, "kernel"
            arr = arr.T if arr.ndim == 2 else np.transpose(arr, (*range(2, arr.ndim), 1, 0))
        else:
            tree, name = params, leaf
        for p in path:
            tree = tree.setdefault(p, {})
        tree[name] = np.array(arr, order="C")
    return {"params": params, "batch_stats": stats} if stats else {"params": params}
