"""The reference's ``.pth`` state dicts ↔ this package's ``state_dict``.

The reference saves ``torch.save({"model_state_dict": ...})`` with its own
module layout (the JAX package's ``io/torch_import.py`` maps it onto flax
trees). This module keeps its own copy of that mapping: a reference-keyed
state dict is first rewritten to the flax-shaped tree of numpy arrays the
JAX importer builds, then through ``io/flax_params.py::params_from_flax``
to this package's keys, so the two importers agree leaf for leaf. The
exporters are the exact inverses.

Structural translations (reference → flax tree):

* ``nn.Linear`` weight [out, in] → kernel [in, out]; ``nn.LayerNorm``
  weight/bias → scale/bias;
* the ``num_blocks`` Linears of ``to_patch_embedding.blockwise_embed.{i}``
  stack into ``blockwise_kernel`` [blocks, patch_dim, dim] and
  ``blockwise_bias``; the SimMIM decoders ``to_pixels.layers.{i}`` into
  ``to_pixels`` kernel [blocks, dim, pixels] and bias;
* ``spatial_spectral_transformer`` is an ``nn.Sequential`` whose stacks sit
  at index 1 (spatial) and 3 (spectral), index 1 only under
  ``spectral_only``;
* the shared ``PatchEmbed`` keeps its pre-norm at ``to_patch.1`` and its
  Linear and post-norm at ``embed.{0,1}``; the Sequential patch chains of
  ViTRGB and V1 (``to_patch_embedding.{1,2,3}``: LN, Linear, LN) become
  ``patch_chain`` and ``embed_chain``; SimMIM's shared decoder
  ``to_pixels`` becomes ``to_pixels_linear``.

``load_pretrained_encoder`` is the reference's finetune-time surgery:
strip the ``encoder.`` prefix SimMIM adds, take the fresh ``head_linear``,
keep the checkpoint's ``head_norm``, and truncate ``pos_embed`` under
``patch_sub``.
"""

from __future__ import annotations

import warnings
from typing import Any, Dict, Mapping

import numpy as np
import torch

from maskedsst_tpu_torch.io.flax_params import flax_from_params, params_from_flax


def _np(t) -> np.ndarray:
    """A tensor (or array) → an owned numpy array."""
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy().copy()
    return np.array(t)


def _linear(sd: Mapping[str, Any], prefix: str) -> Dict[str, np.ndarray]:
    return {"kernel": _np(sd[f"{prefix}.weight"]).T, "bias": _np(sd[f"{prefix}.bias"])}


def _layernorm(sd: Mapping[str, Any], prefix: str) -> Dict[str, np.ndarray]:
    return {"scale": _np(sd[f"{prefix}.weight"]), "bias": _np(sd[f"{prefix}.bias"])}


def _transformer(sd: Mapping[str, Any], prefix: str, depth: int) -> Dict[str, Any]:
    """The reference Transformer's ``layers.{i}.{0,1}`` (PreNorm(Attention),
    PreNorm(FeedForward)) → ``layers_{i}/{attn_norm, attn, ff_norm, ff}``."""
    out: Dict[str, Any] = {}
    for i in range(depth):
        base = f"{prefix}.layers.{i}"
        layer = {
            "attn_norm": _layernorm(sd, f"{base}.0.norm"),
            "attn": {"to_qkv": {"kernel": _np(sd[f"{base}.0.fn.to_qkv.weight"]).T}},
            "ff_norm": _layernorm(sd, f"{base}.1.norm"),
            "ff": {"fc1": _linear(sd, f"{base}.1.fn.net.0"),
                   "fc2": _linear(sd, f"{base}.1.fn.net.3")},
        }
        if f"{base}.0.fn.to_out.0.weight" in sd:
            layer["attn"]["to_out"] = _linear(sd, f"{base}.0.fn.to_out.0")
        out[f"layers_{i}"] = layer
    return out


def _stack_blockwise(sd: Mapping[str, Any], prefix: str, num_blocks: int) -> Dict[str, np.ndarray]:
    """``{prefix}.{i}.weight/bias`` Linears → kernel [g, in, out], bias [g, out]."""
    return {"kernel": np.stack([_np(sd[f"{prefix}.{i}.weight"]).T for i in range(num_blocks)]),
            "bias": np.stack([_np(sd[f"{prefix}.{i}.bias"]) for i in range(num_blocks)])}


def _depth(model) -> int:
    return len(model.spectral_transformer.layers)


def _chain(sd: Mapping[str, Any], names) -> Dict[str, Any]:
    """The reference's ``to_patch_embedding`` Sequential (Rearrange, LN,
    Linear, LN) → the three named stages of a flax patch chain."""
    pre, proj, post = names
    return {pre: _layernorm(sd, "to_patch_embedding.1"),
            proj: _linear(sd, "to_patch_embedding.2"),
            post: _layernorm(sd, "to_patch_embedding.3")}


def _vit_tree(sd: Mapping[str, Any], model) -> Dict[str, Any]:
    """Reference ViTSpatialSpectral state dict → the flax-shaped tree."""
    if model.blockwise_patch_embed:
        stacked = _stack_blockwise(sd, "to_patch_embedding.blockwise_embed",
                                   model.num_spectral_patches)
        embedding = {
            "pre_norm": _layernorm(sd, "to_patch_embedding.pre_norm"),
            "post_norm": _layernorm(sd, "to_patch_embedding.post_norm"),
            "blockwise_kernel": stacked["kernel"],
            "blockwise_bias": stacked["bias"],
        }
    else:  # PatchEmbed: to_patch = (Rearrange, LN), embed = (Linear, LN)
        embedding = {
            "pre_norm": _layernorm(sd, "to_patch_embedding.to_patch.1"),
            "proj": _linear(sd, "to_patch_embedding.embed.0"),
            "post_norm": _layernorm(sd, "to_patch_embedding.embed.1"),
        }
    tree: Dict[str, Any] = {"to_patch_embedding": embedding}
    if model.spectral_pos_embed:
        tree["pos_embed"] = _np(sd["pos_embed"])
        tree["channel_embed"] = _np(sd["channel_embed"])
    else:
        tree["pos_embedding"] = _np(sd["pos_embedding"])
    depth = _depth(model)
    if model.spectral_only:
        tree["spectral_transformer"] = _transformer(sd, "spatial_spectral_transformer.1", depth)
    else:
        tree["spatial_transformer"] = _transformer(sd, "spatial_spectral_transformer.1", depth)
        tree["spectral_transformer"] = _transformer(sd, "spatial_spectral_transformer.3", depth)
    # heads: Sequential(LN, Linear, ...), the Linear at index 2 when
    # pixelwise (a Flatten sits at 1), else 1; pretraining checkpoints
    # (never pixelwise) keep theirs at 1
    if "mlp_head.0.weight" in sd:
        tree["head_norm"] = _layernorm(sd, "mlp_head.0")
    for linear_idx in ((2, 1) if model.pixelwise else (1,)):
        if f"mlp_head.{linear_idx}.weight" in sd:
            tree["head_linear"] = _linear(sd, f"mlp_head.{linear_idx}")
            break
    else:
        head_keys = sorted(k for k in sd if k.startswith("mlp_head."))
        if head_keys:
            warnings.warn(f"checkpoint has an mlp_head ({head_keys}) but no Linear at the "
                          "expected indices; head_linear was NOT imported", stacklevel=3)
    return tree


def _strip_encoder(sd: Mapping[str, Any]) -> Dict[str, Any]:
    return {k[len("encoder."):]: v for k, v in sd.items() if k.startswith("encoder.")}


def import_vit_spatial_spectral(sd: Mapping[str, Any], model) -> Dict[str, torch.Tensor]:
    """Reference ViTSpatialSpectral state dict → ``state_dict`` of the
    port's ``ViTSpatialSpectral`` of the same config (CPU tensors)."""
    return params_from_flax(_vit_tree(sd, model))


def import_simmim(sd: Mapping[str, Any], simmim) -> Dict[str, torch.Tensor]:
    """Reference SimMIMSpatialSpectral state dict (``encoder.``-prefixed
    keys, ``mask_token``, the per-block ``to_pixels.layers.{i}`` or the
    shared ``to_pixels``) → ``state_dict`` of the port's
    ``SimMIMSpatialSpectral`` (a ViTSpatialSpectral encoder)."""
    tree = {
        "encoder": _vit_tree(_strip_encoder(sd), simmim.encoder),
        "mask_token": _np(sd["mask_token"]),
    }
    if simmim.per_block:
        tree["to_pixels"] = _stack_blockwise(sd, "to_pixels.layers",
                                             simmim.encoder.num_spectral_patches)
    else:
        tree["to_pixels_linear"] = _linear(sd, "to_pixels")
    return params_from_flax(tree)


_RGB_CHAIN = ("patch_pre_norm", "patch_proj", "patch_post_norm")
_V1_CHAIN = ("pre_norm", "proj", "post_norm")


def import_vit_rgb(sd: Mapping[str, Any], model) -> Dict[str, torch.Tensor]:
    """Reference ViTRGB state dict → ``state_dict`` of the port's ``ViTRGB``
    of the same config."""
    return params_from_flax({
        "patch_chain": _chain(sd, _RGB_CHAIN),
        "pos_embedding": _np(sd["pos_embedding"]),
        "cls_token": _np(sd["cls_token"]),
        "transformer": _transformer(sd, "transformer", len(model.transformer.layers)),
        "head_norm": _layernorm(sd, "mlp_head.0"),
        "head_linear": _linear(sd, "mlp_head.1"),
    })


def import_vit_spatial_spectral_v1(sd: Mapping[str, Any], model) -> Dict[str, torch.Tensor]:
    """Reference ViTSpatialSpectral_V1 state dict → ``state_dict`` of the
    port's ``ViTSpatialSpectralV1`` of the same config."""
    depth = _depth(model)
    return params_from_flax({
        "embed_chain": _chain(sd, _V1_CHAIN),
        "pos_embedding": _np(sd["pos_embedding"]),
        "spatial_transformer": _transformer(sd, "spatial_spectral_transformer.1", depth),
        "spectral_transformer": _transformer(sd, "spatial_spectral_transformer.3", depth),
        "head_norm": _layernorm(sd, "mlp_head.0"),
        "head_linear": _linear(sd, "mlp_head.1"),
    })


def load_pretrained_encoder(checkpoint: Mapping[str, Any], model,
                            fresh: Mapping[str, torch.Tensor],
                            patch_sub: int = 0) -> Dict[str, torch.Tensor]:
    """The reference's finetune-time import of a pretraining ``.pth``.

    ``checkpoint`` holds ``model_state_dict`` with ``encoder.``-prefixed
    keys; ``model`` is the finetune model and ``fresh`` a fresh
    ``state_dict`` of it, whose ``head_linear`` replaces the pretraining
    one (the head LayerNorm loads from the checkpoint, as the reference's
    ``load_state_dict`` keeps it; a checkpoint without one, as this
    package's SimMIM export, leaves it fresh). Returns the model's whole
    ``state_dict`` (CPU tensors)."""
    tree = _vit_tree(_strip_encoder(checkpoint["model_state_dict"]), model)
    if patch_sub != 0 and "pos_embed" in tree:
        tree["pos_embed"] = tree["pos_embed"][:, : model.num_spatial_patches, :]
    out = {k: v.detach().cpu().clone() for k, v in fresh.items()}
    out.update((k, v) for k, v in params_from_flax(tree).items()
               if not k.startswith("head_linear."))
    return out


def load_torch_checkpoint(path: str) -> Dict[str, Any]:
    """Load a ``.pth`` onto the CPU, restricted to tensors and containers
    (``weights_only=True``) first; the reference's own files pickle a
    custom config object and need the unrestricted loader, which runs
    arbitrary pickle code: fall back to it only with a loud warning."""
    try:
        return torch.load(path, map_location="cpu", weights_only=True)
    except Exception:
        warnings.warn(
            f"{path}: not loadable under weights_only=True (non-tensor pickled objects, e.g. "
            "the reference's Dotdict config); falling back to the UNRESTRICTED pickle loader "
            "- only do this for checkpoints from a trusted source", stacklevel=2)
        return torch.load(path, map_location="cpu", weights_only=False)


# --- export: this package's state_dict → reference keys ---------------------

def _export_linear(tree, prefix: str, out: Dict[str, np.ndarray]) -> None:
    out[f"{prefix}.weight"] = np.asarray(tree["kernel"]).T
    if "bias" in tree:
        out[f"{prefix}.bias"] = np.asarray(tree["bias"])


def _export_layernorm(tree, prefix: str, out: Dict[str, np.ndarray]) -> None:
    out[f"{prefix}.weight"] = np.asarray(tree["scale"])
    out[f"{prefix}.bias"] = np.asarray(tree["bias"])


def _export_transformer(tree, prefix: str, depth: int, out: Dict[str, np.ndarray]) -> None:
    for i in range(depth):
        layer, base = tree[f"layers_{i}"], f"{prefix}.layers.{i}"
        _export_layernorm(layer["attn_norm"], f"{base}.0.norm", out)
        out[f"{base}.0.fn.to_qkv.weight"] = np.asarray(layer["attn"]["to_qkv"]["kernel"]).T
        if "to_out" in layer["attn"]:
            _export_linear(layer["attn"]["to_out"], f"{base}.0.fn.to_out.0", out)
        _export_layernorm(layer["ff_norm"], f"{base}.1.norm", out)
        _export_linear(layer["ff"]["fc1"], f"{base}.1.fn.net.0", out)
        _export_linear(layer["ff"]["fc2"], f"{base}.1.fn.net.3", out)


def _export_stacked(tree, prefix: str, out: Dict[str, np.ndarray]) -> None:
    kernel, bias = np.asarray(tree["kernel"]), np.asarray(tree["bias"])
    for i in range(kernel.shape[0]):
        out[f"{prefix}.{i}.weight"] = kernel[i].T
        out[f"{prefix}.{i}.bias"] = bias[i]


def _export_chain(tree, names, out: Dict[str, np.ndarray]) -> None:
    pre, proj, post = names
    _export_layernorm(tree[pre], "to_patch_embedding.1", out)
    _export_linear(tree[proj], "to_patch_embedding.2", out)
    _export_layernorm(tree[post], "to_patch_embedding.3", out)


def _export_vit(tree, model) -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    emb = tree["to_patch_embedding"]
    if model.blockwise_patch_embed:
        _export_layernorm(emb["pre_norm"], "to_patch_embedding.pre_norm", out)
        _export_layernorm(emb["post_norm"], "to_patch_embedding.post_norm", out)
        _export_stacked({"kernel": emb["blockwise_kernel"], "bias": emb["blockwise_bias"]},
                        "to_patch_embedding.blockwise_embed", out)
    else:
        _export_layernorm(emb["pre_norm"], "to_patch_embedding.to_patch.1", out)
        _export_linear(emb["proj"], "to_patch_embedding.embed.0", out)
        _export_layernorm(emb["post_norm"], "to_patch_embedding.embed.1", out)
    if model.spectral_pos_embed:
        out["pos_embed"] = np.asarray(tree["pos_embed"])
        out["channel_embed"] = np.asarray(tree["channel_embed"])
    else:
        out["pos_embedding"] = np.asarray(tree["pos_embedding"])
    depth = _depth(model)
    if model.spectral_only:
        _export_transformer(tree["spectral_transformer"], "spatial_spectral_transformer.1",
                            depth, out)
    else:
        _export_transformer(tree["spatial_transformer"], "spatial_spectral_transformer.1",
                            depth, out)
        _export_transformer(tree["spectral_transformer"], "spatial_spectral_transformer.3",
                            depth, out)
    if "head_norm" in tree:
        _export_layernorm(tree["head_norm"], "mlp_head.0", out)
    if "head_linear" in tree:
        _export_linear(tree["head_linear"], f"mlp_head.{2 if model.pixelwise else 1}", out)
    return out


def _tensors(sd: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}


def export_vit_spatial_spectral(state_dict: Mapping[str, torch.Tensor],
                                model) -> Dict[str, torch.Tensor]:
    """The port's ViTSpatialSpectral ``state_dict`` → a reference-keyed one
    (CPU tensors, for ``torch.save({"model_state_dict": ...})``); the exact
    inverse of :func:`import_vit_spatial_spectral`."""
    return _tensors(_export_vit(flax_from_params(state_dict), model))


def export_simmim(state_dict: Mapping[str, torch.Tensor], simmim) -> Dict[str, torch.Tensor]:
    """The port's SimMIM ``state_dict`` → the reference's pretraining keys
    (``encoder.*``, ``mask_token``, ``to_pixels.layers.{i}``); the exact
    inverse of :func:`import_simmim`."""
    tree = flax_from_params(state_dict)
    out = {f"encoder.{k}": v for k, v in _export_vit(tree["encoder"], simmim.encoder).items()}
    out["mask_token"] = np.asarray(tree["mask_token"])
    if simmim.per_block:
        _export_stacked(tree["to_pixels"], "to_pixels.layers", out)
    else:
        _export_linear(tree["to_pixels_linear"], "to_pixels", out)
    return _tensors(out)


def export_vit_rgb(state_dict: Mapping[str, torch.Tensor], model) -> Dict[str, torch.Tensor]:
    """The port's ViTRGB ``state_dict`` → reference keys; the exact inverse
    of :func:`import_vit_rgb`."""
    tree = flax_from_params(state_dict)
    out: Dict[str, np.ndarray] = {}
    _export_chain(tree["patch_chain"], _RGB_CHAIN, out)
    out["pos_embedding"] = np.asarray(tree["pos_embedding"])
    out["cls_token"] = np.asarray(tree["cls_token"])
    _export_transformer(tree["transformer"], "transformer", len(model.transformer.layers), out)
    _export_layernorm(tree["head_norm"], "mlp_head.0", out)
    _export_linear(tree["head_linear"], "mlp_head.1", out)
    return _tensors(out)


def export_vit_spatial_spectral_v1(state_dict: Mapping[str, torch.Tensor],
                                   model) -> Dict[str, torch.Tensor]:
    """The port's ViTSpatialSpectralV1 ``state_dict`` → reference keys; the
    exact inverse of :func:`import_vit_spatial_spectral_v1`."""
    tree = flax_from_params(state_dict)
    out: Dict[str, np.ndarray] = {}
    _export_chain(tree["embed_chain"], _V1_CHAIN, out)
    out["pos_embedding"] = np.asarray(tree["pos_embedding"])
    depth = _depth(model)
    _export_transformer(tree["spatial_transformer"], "spatial_spectral_transformer.1", depth, out)
    _export_transformer(tree["spectral_transformer"], "spatial_spectral_transformer.3", depth,
                        out)
    _export_layernorm(tree["head_norm"], "mlp_head.0", out)
    _export_linear(tree["head_linear"], "mlp_head.1", out)
    return _tensors(out)
