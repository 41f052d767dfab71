"""Finetune model factory: builds the model named by ``config.method_name``
(``li``, the DeepHyperX 3-D CNN baseline; ``ViTSpatialSpectral``; or
``ViTRGB``) with weights made from ``config.seed``, plus the trainer flags
it needs, and loads pretrained encoder weights into it
(``load_pretrained_params``).
"""

from __future__ import annotations

import copy
import os
from typing import Any, Dict, Optional, Tuple, Union

import torch

from maskedsst_tpu_torch.config import Config
from maskedsst_tpu_torch.models import ViTRGB, ViTSpatialSpectral
from maskedsst_tpu_torch.models.zoo import LiEtAl, get_model as zoo_get_model


def check_fused_mesh(world) -> None:
    """The trainers run the fused layer kernels, which take data parallelism
    only: a grid whose model axis is above 1 raises (JAX's
    ``check_fused_mesh`` for ``fused=True``). The port has no unfused
    trainer, so JAX's one accepted combination, ``fused=False`` with a model
    axis (parameters left whole, the model axis idle), raises here too; a
    head-split step is ``tools/dist_worker.py``'s ``tensor_parallel`` case."""
    if getattr(world, "model_size", 1) > 1:
        raise ValueError(
            f"a grid with a model axis of {world.model_size} cannot train: the fused kernels "
            "support data parallelism only. Use a pure data grid, or place the model "
            "(parallel/sharding_rules.py) for the head-split layer outside the trainers.")


def build_finetune_model(
    config: Config, dtype: Optional[torch.dtype] = None, device: str = "cuda"
) -> Tuple[Union[ViTSpatialSpectral, ViTRGB, LiEtAl], Dict[str, Any]]:
    """Returns (model on ``device``, trainer_kwargs). ``dtype`` is the
    compute dtype of the fused ops (None = fp32; params stay fp32); the li
    3-D CNN ignores it and keeps the paper recipe in fp32.

    trainer_kwargs for li: ``center_pixel`` and ``add_channel_dim``, and,
    unless ``overwrite_li_optim``, the paper recipe: ``optimizer_override``
    (SGD, momentum 0.9, L2 5e-4) and ``class_weights`` (the factory's,
    with the ignored label's weight zeroed)."""
    name = config.method_name
    size = config.image_size - config.get("patch_sub", 0)

    if name == "li":
        model, opt, crit, _ = zoo_get_model(
            "li", n_classes=config.n_classes, n_bands=config.n_bands,
            ignored_labels=[config.ignored_label], patch_size=size,
            seed=config.get("seed", 5))
        trainer_kwargs: Dict[str, Any] = {"center_pixel": True, "add_channel_dim": True}
        if not config.get("overwrite_li_optim", False):
            trainer_kwargs["optimizer_override"] = opt
            trainer_kwargs["class_weights"] = crit["weight"]
        return model.to(device), trainer_kwargs

    if name == "ViTSpatialSpectral":
        model = ViTSpatialSpectral(
            image_size=size,
            spatial_patch_size=config.patch_size,
            spectral_patch_size=config.band_patch_size,
            num_classes=config.n_classes,
            dim=config.transformer_dim,
            depth=config.transformer_depth,
            heads=config.transformer_n_heads,
            mlp_dim=config.transformer_mlp_dim,
            dropout=config.transformer_dropout,
            emb_dropout=config.transformer_emb_dropout,
            channels=config.n_bands,
            spectral_pos=config.get("spectral_pos"),
            spectral_pos_embed=config.spectral_pos_embed,
            blockwise_patch_embed=config.blockwise_patch_embed,
            spectral_only=config.spectral_only,
            pixelwise=config.pixelwise,
            pos_embed_len=config.get("pos_embed_len"),
            dtype=dtype,
        )
        model.init_weights(config.get("seed", 5))
        return model.to(device), {"center_pixel": bool(config.pixelwise)}

    if name == "ViTRGB":
        model = ViTRGB(
            image_size=config.image_size,
            patch_size=config.patch_size,
            num_classes=config.n_classes,
            dim=config.transformer_dim,
            depth=config.transformer_depth,
            heads=config.transformer_n_heads,
            mlp_dim=config.transformer_mlp_dim,
            dropout=config.transformer_dropout,
            emb_dropout=config.transformer_emb_dropout,
            channels=config.n_bands,
            pixelwise=True,  # one prediction per pixel
            dtype=dtype,
        )
        model.init_weights(config.get("seed", 5))
        return model.to(device), {}

    raise NotImplementedError(f"method {name} not available")


def load_pretrained_params(path: str, config: Config, model: torch.nn.Module,
                           seed: int = 5) -> Optional[Dict[str, torch.Tensor]]:
    """A ``state_dict`` for ``model`` (the finetune model of ``config``):
    the pretrained encoder of the checkpoint at ``path`` over weights made
    fresh from ``seed``, with the reference's head surgery (a fresh
    classification head; ``pos_embed`` truncated under ``patch_sub``).
    None when ``path`` does not exist.

    ``.pth``: the reference format, through ``io/torch_import.py`` (for li
    a reference LiEtAl state dict, ``import_li_et_al``).
    ``.pt``: this package's pretraining checkpoint; ``.msgpack``: the JAX
    package's (``maskedsst_tpu/train/factory.py:150-180``: a full state or
    bare parameters, through ``io/flax_checkpoint.py``; for li the zoo's
    converters). Both give the ``encoder.*`` entries of the model (all of
    them where there is no encoder), ``head_linear`` skipped, keys the
    model lacks printed and skipped. Tensors come back on the CPU."""
    if not os.path.exists(path):
        return None
    fresh = {k: v.detach().cpu().clone()
             for k, v in copy.deepcopy(model).init_weights(seed).state_dict().items()}
    patch_sub = config.get("patch_sub", 0)

    if path.endswith(".pth"):
        from maskedsst_tpu_torch.io.torch_import import (
            import_li_et_al,
            load_pretrained_encoder,
            load_torch_checkpoint,
        )

        if config.method_name == "li":
            ckpt = load_torch_checkpoint(path)
            return import_li_et_al(ckpt.get("model_state_dict", ckpt), model)
        return load_pretrained_encoder(load_torch_checkpoint(path), model, fresh, patch_sub)

    from maskedsst_tpu_torch.train.checkpoint import restore_params

    params = restore_params(path, model=model)
    enc = {k[len("encoder."):]: v for k, v in params.items() if k.startswith("encoder.")} or params
    merged = dict(fresh)
    for key, val in enc.items():
        if key.startswith("head_linear."):
            continue  # a fresh classification head (the reference's head surgery)
        if key not in fresh:
            print(f"[finetune] skipping checkpoint key {key!r} absent from model")
            continue
        if key == "pos_embed" and patch_sub:
            want = (config.image_size - patch_sub) ** 2
            # the reference asserts before it truncates: a checkpoint
            # pretrained at a smaller image_size would make the slice a no-op
            assert val.shape[1] >= want, (
                f"checkpoint pos_embed has {val.shape[1]} positions < the {want} this finetune "
                f"geometry needs (image_size {config.image_size} - patch_sub {patch_sub}); the "
                "checkpoint was pretrained at a smaller image_size")
            val = val[:, :want, :]
        merged[key] = val
    return merged
