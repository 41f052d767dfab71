"""The factorized spatial-spectral encoder, the SimMIM loss and the
classifier, in plain PyTorch over a dict of named weights.

Weights are named and shaped as :func:`weight_shapes` lists them (the
layout of the published model's modules): ``[out, in]`` Linear weights,
``to_patch_embedding.blockwise_kernel`` [g, p, d], ``to_pixels.kernel``
[g, d, p]. Tokens are block-major: token ``block * n + position``. A layer
is pre-LN attention (QKV without bias, scores scaled by dim_head**-0.5,
softmax, dropout on the probabilities, out-projection, dropout) then a
pre-LN MLP (exact GELU, dropout after it and after the second product),
each with its residual. ``q`` rounds every matrix-product operand
(``quant.py``): the identity for the reference.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Callable, Dict, Optional, Sequence

import torch
import torch.nn.functional as F

from hsi_bench.reference.draws import (
    SITE_ATTN,
    SITE_FF_MID,
    SITE_FF_OUT,
    SITE_PROJ,
    keep_multiplier,
    loss_weights,
)

LN_EPS = 1e-5
Weights = Dict[str, torch.Tensor]
Round = Callable[[torch.Tensor], torch.Tensor]


def _dims(cfg: dict):
    d, depth = int(cfg["transformer_dim"]), int(cfg["transformer_depth"])
    inner = int(cfg["transformer_n_heads"]) * int(cfg["dim_head"])
    g = int(cfg["n_bands"]) // int(cfg["band_patch_size"])
    if int(cfg["patch_size"]) != 1:
        raise ValueError("the reference takes spatial patches of 1 pixel")
    n = int(cfg["image_size"]) ** 2
    return d, depth, inner, int(cfg["transformer_mlp_dim"]), g, n, int(cfg["band_patch_size"])


def weight_shapes(cfg: dict, kind: str) -> "OrderedDict[str, tuple]":
    """Name → shape of every weight of the SimMIM model (``kind``
    "simmim") or of the classifier ("classifier")."""
    d, depth, inner, mlp, g, n, p = _dims(cfg)
    pre = "encoder." if kind == "simmim" else ""
    out: "OrderedDict[str, tuple]" = OrderedDict()
    e = pre + "to_patch_embedding."
    out.update({e + "pre_norm.weight": (p,), e + "pre_norm.bias": (p,),
                e + "blockwise_kernel": (g, p, d), e + "blockwise_bias": (g, d),
                e + "post_norm.weight": (d,), e + "post_norm.bias": (d,)})
    if cfg["spectral_pos_embed"]:
        out[pre + "pos_embed"] = (1, n, d - d // 3)
        out[pre + "channel_embed"] = (1, g, d // 3)
    else:
        out[pre + "pos_embedding"] = (1, g * n + 1, d)
    for stack in ("spatial_transformer", "spectral_transformer"):
        for i in range(depth):
            lp = f"{pre}{stack}.layers.{i}."
            out.update({lp + "attn_norm.weight": (d,), lp + "attn_norm.bias": (d,),
                        lp + "attn.to_qkv.weight": (3 * inner, d),
                        lp + "attn.to_out.weight": (d, inner), lp + "attn.to_out.bias": (d,),
                        lp + "ff_norm.weight": (d,), lp + "ff_norm.bias": (d,),
                        lp + "ff.fc1.weight": (mlp, d), lp + "ff.fc1.bias": (mlp,),
                        lp + "ff.fc2.weight": (d, mlp), lp + "ff.fc2.bias": (d,)})
    if kind == "simmim":
        out.update({"mask_token": (d,), "to_pixels.kernel": (g, d, p), "to_pixels.bias": (g, p)})
    elif kind == "classifier":
        classes = int(cfg["n_classes"])
        out.update({"head_norm.weight": (d,), "head_norm.bias": (d,),
                    "head_linear.weight": (classes, d), "head_linear.bias": (classes,)})
    else:
        raise ValueError(f"unknown model kind {kind!r}")
    return out


def layer(x: torch.Tensor, w: Weights, pre: str, heads: int, rate: float,
          seed: Optional[int], q: Round) -> torch.Tensor:
    """One pre-LN layer over x [B, S, D]; dropout at ``rate`` under layer
    seed ``seed`` (None: no dropout)."""
    b, s, d = x.shape
    inner = w[pre + "attn.to_qkv.weight"].shape[0] // 3
    dh = inner // heads
    drop = seed is not None and rate > 0.0
    h1 = F.layer_norm(x, (d,), w[pre + "attn_norm.weight"], w[pre + "attn_norm.bias"], LN_EPS)
    qkv = q(h1) @ q(w[pre + "attn.to_qkv.weight"]).t()
    qh, kh, vh = (t.reshape(b, s, heads, dh).transpose(1, 2) for t in qkv.split(inner, dim=-1))
    att = torch.softmax((q(qh) @ q(kh).transpose(-1, -2)) * dh**-0.5, dim=-1)
    if drop:
        att = att * keep_multiplier((b, heads, s, s), seed, SITE_ATTN, rate, x.device)
    o = (q(att) @ q(vh)).transpose(1, 2).reshape(b * s, inner)
    p1 = q(o) @ q(w[pre + "attn.to_out.weight"]).t() + w[pre + "attn.to_out.bias"]
    if drop:
        p1 = p1 * keep_multiplier((b * s, d), seed, SITE_PROJ, rate, x.device)
    x1 = x.reshape(b * s, d) + p1
    h2 = F.layer_norm(x1, (d,), w[pre + "ff_norm.weight"], w[pre + "ff_norm.bias"], LN_EPS)
    u = q(h2) @ q(w[pre + "ff.fc1.weight"]).t() + w[pre + "ff.fc1.bias"]
    gd = F.gelu(u)
    if drop:
        gd = gd * keep_multiplier(tuple(gd.shape), seed, SITE_FF_MID, rate, x.device)
    ff = q(gd) @ q(w[pre + "ff.fc2.weight"]).t() + w[pre + "ff.fc2.bias"]
    if drop:
        ff = ff * keep_multiplier((b * s, d), seed, SITE_FF_OUT, rate, x.device)
    return (x1 + ff).reshape(b, s, d)


def positions(w: Weights, cfg: dict, pre: str) -> torch.Tensor:
    """The positional table of the g * n tokens, [g, n, d]."""
    d, _, _, _, g, n, _ = _dims(cfg)
    if cfg["spectral_pos_embed"]:
        pos = w[pre + "pos_embed"][0][None].expand(g, n, -1)
        chan = w[pre + "channel_embed"][0][:, None].expand(g, n, -1)
        return torch.cat([pos, chan], dim=-1)
    return w[pre + "pos_embedding"][0, : g * n].reshape(g, n, d)


def tokens(img: torch.Tensor, w: Weights, cfg: dict, pre: str, q: Round,
           mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Cubes [B, C, H, W] → tokens [B, g, n, d]: LN over each block's
    pixels, the block's product and bias, LN over d, + positions; tokens
    under ``mask`` (bool [B, g * n]) become the mask token + positions."""
    d, _, _, _, g, n, p = _dims(cfg)
    b = img.shape[0]
    e = pre + "to_patch_embedding."
    x = img.reshape(b, g, p, n).transpose(2, 3)  # [B, g, n, p]
    x = F.layer_norm(x, (p,), w[e + "pre_norm.weight"], w[e + "pre_norm.bias"], LN_EPS)
    t = torch.einsum("bgnp,gpd->bgnd", q(x), q(w[e + "blockwise_kernel"]))
    t = t + w[e + "blockwise_bias"][None, :, None, :]
    t = F.layer_norm(t, (d,), w[e + "post_norm.weight"], w[e + "post_norm.bias"], LN_EPS)
    pos = positions(w, cfg, pre)
    t = t + pos[None]
    if mask is not None:
        t = torch.where(mask.reshape(b, g, n, 1), (w["mask_token"] + pos)[None], t)
    return t


def encode(t: torch.Tensor, w: Weights, cfg: dict, pre: str, q: Round,
           layer_seeds: Optional[Sequence[int]] = None) -> torch.Tensor:
    """Tokens [B, g, n, d] → the spatial stack over n, the spectral stack
    over g → [B, n, g, d]. ``layer_seeds``: one seed a layer, spatial then
    spectral (None: no dropout)."""
    b, g, n, d = t.shape
    depth, heads = int(cfg["transformer_depth"]), int(cfg["transformer_n_heads"])
    rate = float(cfg["transformer_dropout"]) if layer_seeds is not None else 0.0
    x = t.reshape(b * g, n, d)
    for i in range(depth):
        seed = None if layer_seeds is None else layer_seeds[i]
        x = layer(x, w, f"{pre}spatial_transformer.layers.{i}.", heads, rate, seed, q)
    x = x.reshape(b, g, n, d).transpose(1, 2).reshape(b * n, g, d)
    for i in range(depth):
        seed = None if layer_seeds is None else layer_seeds[depth + i]
        x = layer(x, w, f"{pre}spectral_transformer.layers.{i}.", heads, rate, seed, q)
    return x.reshape(b, n, g, d)


def simmim_loss(img: torch.Tensor, w: Weights, cfg: dict, mask: torch.Tensor,
                layer_seeds: Sequence[int], q: Round) -> torch.Tensor:
    """The SimMIM loss of crops [B, C, H, W] under ``mask``: the per-block
    decode of every token, its L1 distance to the raw pixels weighted to
    the first ``num_masked`` masked tokens of each row, divided by
    B · num_masked · p and by num_masked once more (the published code's
    normalization)."""
    d, _, _, _, g, n, p = _dims(cfg)
    b = img.shape[0]
    num_masked = int(float(cfg["mim_masking_ratio"]) * g * n)
    enc = encode(tokens(img, w, cfg, "encoder.", q, mask), w, cfg, "encoder.", q, layer_seeds)
    enc = enc.transpose(1, 2)  # [B, g, n, d]
    preds = torch.einsum("bgnd,gdp->bgnp", q(enc), q(w["to_pixels.kernel"]))
    preds = preds + w["to_pixels.bias"][None, :, None, :]
    target = img.reshape(b, g, p, n).transpose(2, 3)
    weights = loss_weights(mask, num_masked).reshape(b, g, n, 1)
    wsum = ((preds - target).abs() * weights).sum()
    return wsum / (b * num_masked * p) / num_masked


def classifier_logits(cubes: torch.Tensor, w: Weights, cfg: dict, q: Round) -> torch.Tensor:
    """Cubes [B, C, H, W] → per-pixel logits [B, classes, H, W]: the encoder,
    the mean over spectral blocks, LN and the linear head at each pixel."""
    side = int(cfg["image_size"])
    x = encode(tokens(cubes, w, cfg, "", q), w, cfg, "", q).mean(dim=2)  # [B, n, d]
    x = F.layer_norm(x, (x.shape[-1],), w["head_norm.weight"], w["head_norm.bias"], LN_EPS)
    x = q(x) @ q(w["head_linear.weight"]).t() + w["head_linear.bias"]
    return x.reshape(cubes.shape[0], side, side, -1).movedim(-1, 1)
