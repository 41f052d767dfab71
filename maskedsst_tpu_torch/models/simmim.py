"""SimMIM masked pretraining objectives, as the JAX package's
``models/simmim.py``.

``SimMIMSpatialSpectral`` computes the masked-reconstruction loss of a batch
of cubes. On the recipe's route (a blockwise ``ViTSpatialSpectral`` with
per-block decoders): mask → fused tokenization (pre-LN → blockwise embed →
post-LN → + pos → masked tokens replaced by the learned mask token + pos) →
the factorized transformer in block-major token order → the fused
per-block decode of every token and its L1 distance to the raw pixels,
weighted to the first ``num_masked`` masked positions of each row
(``ops/masking.loss_weights``) → ``wsum / (B · num_masked · p) /
num_masked``, the reference's quirk of dividing the mean L1 by
``num_masked`` again. The other options take JAX's unfused routes in plain
ops around the same transformer: the shared ``to_pixels_linear`` decoder
(``to_pixels_per_spectral_block=False``; after the fused tokenization on
the blockwise route), the ``PatchEmbed`` encoder (its layer-normed patches
are the targets), and the V1 encoder (raw patches as targets, positions
from table rows [1, n + 1), ``intermediate_losses`` the loss × 3, which the
JAX package allows for V1 only). As in the JAX model, embedding dropout is
never applied here.

``SimMIM`` is the legacy wrapper over a plain ViT (``ViTRGB``): random
per-token masks, positions from table rows [1, n + 1), one linear decoder
of the masked tokens; it returns the reference's five-tuple.

Randomness comes from an explicit ``torch.Generator`` passed to
``forward``: first a seed for the mask, which is then drawn on the input's
device, then the stacks' dropout seeds. ``bool_mask`` overrides the
sampler. In a data-parallel run ``shard`` = (rank, world size) names the
rows of the global batch that a call holds: the mask is those rows of the
global draw and the layers fold their seeds by the rank.
``SimMIMSpatialSpectral.draw_step`` makes a training call's draws ahead of
it (the mask, then the layers' seeds), which ``forward(..., draws=)``
takes in place of ``rng``.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
from torch import nn

from maskedsst_tpu_torch.models.layers import StepDraws, linear_to
from maskedsst_tpu_torch.models.vit_rgb import ViTRGB
from maskedsst_tpu_torch.models.vit_spatial_spectral import ViTSpatialSpectral, lecun_normal_
from maskedsst_tpu_torch.models.vit_spatial_spectral_v1 import ViTSpatialSpectralV1
from maskedsst_tpu_torch.ops.fused_simmim import fused_decode_l1
from maskedsst_tpu_torch.ops.masking import (
    MaskGenerator,
    loss_weights,
    masked_indices,
    random_token_mask,
)

# JAX's reason for refusing intermediate_losses over another encoder
INTERMEDIATE_LOSSES_NEED_V1 = (
    "intermediate_losses requires the V1 encoder: the x3 factor "
    "reproduces V1's triple-representation sum "
    "(src/vit_spatial_spectral.py:723-732); the reference CRASHES "
    "on non-V1 encoders (NameError, vit_simmim_original.py:305) "
    "rather than training with a silent 3x loss scale"
)


def _draw_mask_seed(rng: Optional[torch.Generator]) -> int:
    if rng is None:
        raise ValueError("drawing a mask needs an explicit torch.Generator (rng)")
    return int(torch.randint(0, 2**62, (1,), generator=rng))


class BlockwiseToPixels(nn.Module):
    """Per-spectral-block linear decoder dim → pixels_per_patch: ``kernel``
    [g, d, p] and ``bias`` [g, p], block g decoded by kernel[g]. ``dtype``
    is the decode's compute dtype (None = the input's)."""

    def __init__(self, num_spectral_blocks: int, dim: int, pixels_per_patch: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.empty(num_spectral_blocks, dim, pixels_per_patch))
        self.bias = nn.Parameter(torch.zeros(num_spectral_blocks, pixels_per_patch))

    def init_weights(self, gen: torch.Generator) -> None:
        """flax's init: lecun_normal with fan_in = g · d (its receptive-field
        rule for a 3-D kernel), zero bias."""
        g, d, _ = self.kernel.shape
        lecun_normal_(self.kernel, g * d, gen)
        nn.init.zeros_(self.bias)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens [B, g, n, d] → predictions [B, g, n, p] in plain ops (the
        JAX decoder off the fused route): operands in ``dtype`` (None: the
        tokens'), fp32 sums rounded to it, the bias added in it."""
        dt = self.dtype or tokens.dtype
        out = torch.einsum("bgnd,gdp->bgnp", tokens.to(dt).float(),
                           self.kernel.to(dt).float()).to(dt)
        return out + self.bias.to(dt)[None, :, None, :]

    def decode_l1(self, encoded: torch.Tensor, patches_pn: torch.Tensor,
                  weights: torch.Tensor) -> torch.Tensor:
        """encoded [B, g, n, d], patches [B, g, p, n], weights [B, g·n] →
        the unnormalized Σ weights · |decode(encoded) − patches| (one fused
        op call: the CUDA kernels on the card)."""
        return fused_decode_l1(encoded.contiguous(), patches_pn.contiguous(), self.kernel,
                               self.bias, weights, self.dtype or encoded.dtype)


class SimMIMSpatialSpectral(nn.Module):
    """Args as the JAX ``SimMIMSpatialSpectral``; ``encoder`` is a
    ``ViTSpatialSpectral`` or a ``ViTSpatialSpectralV1``. The encoder's
    classifier head is dropped: the JAX SimMIM tree has no head parameters,
    and the ``state_dict`` maps one to one onto it (``encoder.*``,
    ``mask_token``, ``to_pixels.{kernel,bias}`` or
    ``to_pixels_linear.{weight,bias}``)."""

    def __init__(self, encoder: Union[ViTSpatialSpectral, ViTSpatialSpectralV1],
                 masking_ratio: float = 0.5, mask_patch_size: int = 1,
                 tube_masking: bool = False, to_pixels_per_spectral_block: bool = False,
                 intermediate_losses: bool = False, dtype: Optional[torch.dtype] = None):
        super().__init__()
        assert 0 < masking_ratio < 1, "masking ratio must be in (0, 1)"
        if not isinstance(encoder, (ViTSpatialSpectral, ViTSpatialSpectralV1)):
            raise TypeError("SimMIMSpatialSpectral takes a ViTSpatialSpectral or "
                            f"ViTSpatialSpectralV1 encoder, got {type(encoder).__name__}")
        self.is_v1 = isinstance(encoder, ViTSpatialSpectralV1)
        if intermediate_losses:
            assert self.is_v1, INTERMEDIATE_LOSSES_NEED_V1
        del encoder.head_norm, encoder.head_linear
        self.encoder = encoder
        self.masking_ratio, self.tube_masking, self.dtype = masking_ratio, tube_masking, dtype
        self.intermediate_losses = intermediate_losses
        self.per_block = to_pixels_per_spectral_block
        # blockwise encoders keep the [B, g, p, n] patches of the fused route
        self.pn_layout = not self.is_v1 and encoder.blockwise_patch_embed
        self.pixels_per_patch = encoder.pixels_per_patch
        self.num_blocks = encoder.num_spectral_patches
        side = encoder.num_spatial_patches if self.is_v1 else encoder.num_spatial_patches_sqrt
        self.num_spatial = side * side
        self.mask_token = nn.Parameter(torch.zeros(encoder.dim))
        if to_pixels_per_spectral_block:
            self.to_pixels = BlockwiseToPixels(self.num_blocks, encoder.dim,
                                               self.pixels_per_patch, dtype)
        else:
            self.to_pixels_linear = nn.Linear(encoder.dim, self.pixels_per_patch)
        self.mask_generator = None
        if mask_patch_size != 1:
            self.mask_generator = MaskGenerator(
                input_size=encoder.image_size, mask_patch_size=mask_patch_size,
                model_patch_size=encoder.patch_height, mask_ratio=masking_ratio)

    @property
    def num_tokens(self) -> int:
        return self.encoder.num_patches

    @property
    def num_masked(self) -> int:
        return int(self.masking_ratio * self.num_tokens)

    def init_weights(self, seed: int) -> "SimMIMSpatialSpectral":
        """Fresh weights from ``seed``: the encoder's init, a normal(1) mask
        token and the decoder's LeCun-normal kernel."""
        self.encoder.init_weights(seed)
        gen = torch.Generator().manual_seed(seed + 1)
        with torch.no_grad():
            self.mask_token.copy_(torch.randn(self.mask_token.shape, generator=gen))
        if self.per_block:
            self.to_pixels.init_weights(gen)
        else:
            lecun_normal_(self.to_pixels_linear.weight, self.encoder.dim, gen)
            nn.init.zeros_(self.to_pixels_linear.bias)
        return self

    def sample_mask(self, batch_size: int, device, rng: torch.Generator,
                    shard: Tuple[int, int] = (0, 1)) -> torch.Tensor:
        """Bool [B, num_tokens] in block-major order, drawn on ``device`` from
        a generator seeded by one draw of ``rng``; under ``shard`` (rank,
        world size), rank's B rows of the global [B · size] draw."""
        rank, size = shard
        gen = torch.Generator(device=device).manual_seed(_draw_mask_seed(rng))
        if self.mask_generator is None:
            masks = random_token_mask(gen, batch_size * size, self.num_tokens, self.num_masked)
        else:
            masks = self.mask_generator.batch_masks(gen, batch_size * size, self.num_blocks,
                                                    self.tube_masking)
        return masks[rank * batch_size : (rank + 1) * batch_size]

    def draw_step(self, rng: torch.Generator, img_shape, device,
                  shard: Tuple[int, int] = (0, 1)) -> StepDraws:
        """The draws of one training call on cubes of ``img_shape`` (this
        process's rows), from ``rng`` in the order ``forward`` makes them:
        the mask (on ``device``), then the encoder's dropout seeds."""
        mask = self.sample_mask(img_shape[0], device, rng, shard)
        seeds = self.encoder.layer_seeds(self.encoder.dropout_seeds(rng), shard[0])
        return StepDraws(seeds, mask=mask)

    def _tokenize(self, img: torch.Tensor, bool_mask: torch.Tensor):
        """(tokens [B, g*n, d] with the masked ones replaced, the targets:
        [B, g, p, n] on the blockwise route, else [B, g, n, p])."""
        enc, b = self.encoder, img.shape[0]
        g, n = self.num_blocks, self.num_spatial
        if self.pn_layout:
            return enc.tokenize_fused(img, mask=bool_mask.reshape(b, g, n).float(),
                                      mask_token=self.mask_token)
        if self.is_v1:
            flat = enc.to_patch(img)  # raw patches: the V1 pre-norm is in embed
            tokens = enc.embed(flat)
            pos = enc.pos_embedding[:, 1 : self.num_tokens + 1].to(tokens.dtype)
        else:
            flat = enc.to_patch_embedding.to_patch(img)  # layer-normed patches
            tokens = enc.to_patch_embedding.embed(flat)
            pos = enc.pos_embedding_for(self.num_tokens).to(tokens.dtype)
        tokens = tokens + pos
        masked = self.mask_token.to(tokens.dtype)[None, None, :] + pos
        return torch.where(bool_mask[..., None], masked, tokens), flat.reshape(b, g, n, -1)

    def forward(self, img: torch.Tensor, rng: Optional[torch.Generator] = None,
                bool_mask: Optional[torch.Tensor] = None,
                shard: Tuple[int, int] = (0, 1),
                draws: Optional[StepDraws] = None) -> torch.Tensor:
        """Cubes [B, C, H, W] → the scalar reconstruction loss (fp32) of these
        rows. The mask is ``bool_mask`` [B, num_tokens] when given, else drawn
        with ``rng``; in training, dropout seeds are drawn from ``rng`` after
        it. ``draws`` (``draw_step``): the mask and the seeds made ahead, in
        place of both. ``shard``: (rank, world size) of a data-parallel
        step."""
        enc = self.encoder
        b = img.shape[0]
        g, n = self.num_blocks, self.num_spatial
        if draws is not None:
            bool_mask = draws.mask
        elif bool_mask is None:
            bool_mask = self.sample_mask(b, img.device, rng, shard)
        tokens, patches = self._tokenize(img, bool_mask)
        if draws is None:
            encoded = enc.transformer_forward(tokens, seeds=enc.dropout_seeds(rng)[:2],
                                              rank=shard[0])
        else:
            encoded = enc.transformer_forward(tokens, rank=shard[0], layer_seeds=draws.seeds)
        if self.is_v1:
            encoded = encoded[0]  # V1's three representations are one
        encoded = encoded.reshape(b, g, n, enc.dim)
        weights = loss_weights(bool_mask, self.num_masked)
        denom = b * self.num_masked * self.pixels_per_patch
        if self.per_block and self.pn_layout:
            wsum = self.to_pixels.decode_l1(encoded, patches, weights)
        else:
            preds = (self.to_pixels(encoded) if self.per_block
                     else linear_to(encoded, self.to_pixels_linear, self.dtype or encoded.dtype))
            if self.pn_layout:
                preds = preds.transpose(-1, -2)  # [B, g, p, n], as the patches
                weights = weights.reshape(b, g, 1, n)
            else:
                weights = weights.reshape(b, g, n, 1)
            wsum = ((preds.float() - patches.float()).abs() * weights).sum()
        loss = wsum / denom / self.num_masked
        # the reference sums the V1 loss over its three representations
        return loss * 3.0 if self.intermediate_losses else loss


class SimMIM(nn.Module):
    """The legacy SimMIM wrapper over a plain ViT encoder (``ViTRGB``), as
    the JAX ``SimMIM``: uniform per-token masks at ``masking_ratio``,
    positions from the learned table's rows [1, n + 1) (the cls row
    skipped), one linear decoder of the masked tokens. The encoder's head
    is dropped (``state_dict``: ``encoder.*``, ``mask_token``,
    ``to_pixels.{weight,bias}``, as the JAX tree)."""

    def __init__(self, encoder: ViTRGB, masking_ratio: float = 0.5):
        super().__init__()
        assert 0 < masking_ratio < 1, "masking ratio must be in (0, 1)"
        del encoder.head_norm, encoder.head_linear
        self.encoder = encoder
        self.masking_ratio = masking_ratio
        self.mask_token = nn.Parameter(torch.zeros(encoder.dim))
        self.to_pixels = nn.Linear(encoder.dim, encoder.pixels_per_patch)

    @property
    def num_masked(self) -> int:
        return int(self.masking_ratio * self.encoder.num_patches)

    def init_weights(self, seed: int) -> "SimMIM":
        """Fresh weights from ``seed``: the encoder's init, a normal(1) mask
        token and the decoder's LeCun-normal kernel."""
        self.encoder.init_weights(seed)
        gen = torch.Generator().manual_seed(seed + 1)
        with torch.no_grad():
            self.mask_token.copy_(torch.randn(self.mask_token.shape, generator=gen))
        lecun_normal_(self.to_pixels.weight, self.encoder.dim, gen)
        nn.init.zeros_(self.to_pixels.bias)
        return self

    def forward(self, img: torch.Tensor, rng: Optional[torch.Generator] = None,
                bool_mask: Optional[torch.Tensor] = None):
        """Cubes [B, C, H, W] → ``(recon_loss, pred_pixel_values,
        masked_patches, masked_indices, encoded)``: the fp32 loss, the
        decoded masked tokens [B, num_masked, p], their raw patches, their
        indices [B, num_masked] and the encoded tokens [B, n, dim]. The mask
        is ``bool_mask`` [B, n] when given, else drawn with ``rng``, whose
        next draw seeds the dropout in training."""
        enc = self.encoder
        patches = enc.to_patch(img)
        b, n, _ = patches.shape
        tokens = enc.embed(patches)
        pos = enc.pos_embedding[:, 1 : n + 1].to(tokens.dtype)
        tokens = tokens + pos
        if bool_mask is None:
            gen = torch.Generator(device=img.device).manual_seed(_draw_mask_seed(rng))
            bool_mask = random_token_mask(gen, b, n, self.num_masked)
        idx = masked_indices(bool_mask, self.num_masked)
        masked = self.mask_token.to(tokens.dtype)[None, None, :] + pos
        tokens = torch.where(bool_mask[..., None], masked, tokens)
        encoded = enc.encode(tokens, enc.dropout_seeds(rng)[0])
        gather = idx[..., None]
        enc_masked = torch.gather(encoded, 1, gather.expand(-1, -1, enc.dim))
        # flax Dense without a dtype computes in the promoted type: fp32
        pred = linear_to(enc_masked, self.to_pixels,
                         torch.promote_types(enc_masked.dtype, torch.float32))
        masked_patches = torch.gather(patches, 1, gather.expand(-1, -1, patches.shape[-1]))
        loss = (pred.float() - masked_patches.float()).abs().mean() / self.num_masked
        return loss, pred, masked_patches, idx, encoded
