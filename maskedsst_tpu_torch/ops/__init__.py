"""Operators with hand-written CUDA kernels (``csrc/``) and their plain
PyTorch versions; the tensor's device picks which one runs."""


def launch_counts() -> dict:
    """Every kernel wrapper's launch count (kernel launches since the count
    was last set to 0; plain-version calls do not count)."""
    from maskedsst_tpu_torch.ops import fused_embed, fused_layer, fused_simmim, layer_wgrad

    return {"fused_layer_fwd": fused_layer.launches, "fused_layer_bwd": fused_layer.bwd_launches,
            "layer_wgrad": layer_wgrad.launches,
            "fused_embed_fwd": fused_embed.launches, "fused_embed_bwd": fused_embed.bwd_launches,
            "fused_simmim_fwd": fused_simmim.launches,
            "fused_simmim_bwd": fused_simmim.bwd_launches}


def reset_launch_counts() -> None:
    """Sets every count of ``launch_counts`` to 0."""
    from maskedsst_tpu_torch.ops import fused_embed, fused_layer, fused_simmim, layer_wgrad

    fused_layer.launches = fused_layer.bwd_launches = layer_wgrad.launches = 0
    fused_embed.launches = fused_embed.bwd_launches = 0
    fused_simmim.launches = fused_simmim.bwd_launches = 0
