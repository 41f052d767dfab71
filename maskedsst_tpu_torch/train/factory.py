"""Finetune model factory: builds the model named by ``config.method_name``
with weights made from ``config.seed``, plus the trainer flags it needs.
Only ``ViTSpatialSpectral`` is ported; ``li`` and ``ViTRGB`` raise.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from maskedsst_tpu_torch.config import Config
from maskedsst_tpu_torch.models import ViTSpatialSpectral


def build_finetune_model(
    config: Config, dtype: Optional[torch.dtype] = None, device: str = "cuda"
) -> Tuple[ViTSpatialSpectral, Dict[str, Any]]:
    """Returns (model on ``device``, trainer_kwargs). ``dtype`` is the
    compute dtype of the fused ops (None = fp32; params stay fp32)."""
    name = config.method_name
    size = config.image_size - config.get("patch_sub", 0)

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

    if name in ("li", "ViTRGB"):
        raise NotImplementedError(
            f"method {name} is not ported yet (ROADMAP.md, Queue 1, Slice E)"
        )
    raise NotImplementedError(f"method {name} not available")
