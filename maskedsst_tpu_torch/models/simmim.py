"""SimMIM masked pretraining objective for ViTSpatialSpectral, as the JAX
package's ``models/simmim.py`` on its production route.

The forward computes the masked-reconstruction loss of a batch of cubes:
mask → fused tokenization (pre-LN → blockwise embed → post-LN → + pos →
masked tokens replaced by the learned mask token + pos) → the factorized
transformer in block-major token order → the fused per-block decode of
every token and its L1 distance to the raw pixels, weighted to the first
``num_masked`` masked positions of each row (``ops/masking.loss_weights``)
→ ``wsum / (B · num_masked · p) / num_masked``, the reference's quirk of
dividing the mean L1 by ``num_masked`` again.

Only the configuration the recipe uses is ported: a blockwise
``ViTSpatialSpectral`` encoder with per-block decoders
(``to_pixels_per_spectral_block``). The shared ``to_pixels_linear``
decoder, ``intermediate_losses`` (V1 only), the V1 encoder and the legacy
``SimMIM`` raise ``NotImplementedError`` (ROADMAP.md, Slice E). As in the
JAX model, embedding dropout is never applied here.

Randomness comes from an explicit ``torch.Generator`` passed to
``forward``: first a seed for the mask, which is then drawn on the input's
device, then the two stacks' dropout seeds. ``bool_mask`` overrides the
sampler. In a data-parallel run ``shard`` = (rank, world size) names the
rows of the global batch that a call holds: the mask is those rows of the
global draw and the layers fold their seeds by the rank.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from maskedsst_tpu_torch.models.vit_spatial_spectral import ViTSpatialSpectral, lecun_normal_
from maskedsst_tpu_torch.ops.fused_simmim import fused_decode_l1
from maskedsst_tpu_torch.ops.masking import MaskGenerator, loss_weights, random_token_mask


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

    def decode_l1(self, encoded: torch.Tensor, patches_pn: torch.Tensor,
                  weights: torch.Tensor) -> torch.Tensor:
        """encoded [B, g, n, d], patches [B, g, p, n], weights [B, g·n] →
        the unnormalized Σ weights · |decode(encoded) − patches| (one fused
        op call: the CUDA kernels on the card)."""
        return fused_decode_l1(encoded.contiguous(), patches_pn.contiguous(), self.kernel,
                               self.bias, weights, self.dtype or encoded.dtype)


class SimMIMSpatialSpectral(nn.Module):
    """Args as the JAX ``SimMIMSpatialSpectral``. The encoder's classifier
    head is dropped: the JAX SimMIM tree has no head parameters, and the
    ``state_dict`` maps one to one onto it (``encoder.*``, ``mask_token``,
    ``to_pixels.{kernel,bias}``)."""

    def __init__(self, encoder: ViTSpatialSpectral, masking_ratio: float = 0.5,
                 mask_patch_size: int = 1, tube_masking: bool = False,
                 to_pixels_per_spectral_block: bool = False, intermediate_losses: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        assert 0 < masking_ratio < 1, "masking ratio must be in (0, 1)"
        if not isinstance(encoder, ViTSpatialSpectral):
            raise NotImplementedError(
                "SimMIM over another encoder (the V1 encoder, the legacy SimMIM) is not "
                "ported yet (ROADMAP.md, Slice E)")
        if not to_pixels_per_spectral_block:
            raise NotImplementedError(
                "the shared to_pixels_linear decoder (to_pixels_per_spectral_block=False) is "
                "not ported yet (ROADMAP.md, Slice E)")
        if intermediate_losses:
            raise NotImplementedError(
                "intermediate_losses needs the V1 encoder, which is not ported yet "
                "(ROADMAP.md, Slice E)")
        del encoder.head_norm, encoder.head_linear
        self.encoder = encoder
        self.masking_ratio, self.tube_masking, self.dtype = masking_ratio, tube_masking, dtype
        self.pixels_per_patch = encoder.to_patch_embedding.patch_dim
        self.mask_token = nn.Parameter(torch.zeros(encoder.dim))
        self.to_pixels = BlockwiseToPixels(encoder.num_spectral_patches, encoder.dim,
                                           self.pixels_per_patch, dtype)
        self.mask_generator = None
        if mask_patch_size != 1:
            self.mask_generator = MaskGenerator(
                input_size=encoder.num_spatial_patches_sqrt * encoder.patch_height,
                mask_patch_size=mask_patch_size, model_patch_size=encoder.patch_height,
                mask_ratio=masking_ratio)

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
        self.to_pixels.init_weights(gen)
        return self

    def sample_mask(self, batch_size: int, device, rng: torch.Generator,
                    shard: Tuple[int, int] = (0, 1)) -> torch.Tensor:
        """Bool [B, num_tokens] in block-major order, drawn on ``device`` from
        a generator seeded by one draw of ``rng``; under ``shard`` (rank,
        world size), rank's B rows of the global [B · size] draw."""
        rank, size = shard
        seed = int(torch.randint(0, 2**62, (1,), generator=rng))
        gen = torch.Generator(device=device).manual_seed(seed)
        if self.mask_generator is None:
            masks = random_token_mask(gen, batch_size * size, self.num_tokens, self.num_masked)
        else:
            masks = self.mask_generator.batch_masks(gen, batch_size * size,
                                                    self.encoder.num_spectral_patches,
                                                    self.tube_masking)
        return masks[rank * batch_size : (rank + 1) * batch_size]

    def forward(self, img: torch.Tensor, rng: Optional[torch.Generator] = None,
                bool_mask: Optional[torch.Tensor] = None,
                shard: Tuple[int, int] = (0, 1)) -> torch.Tensor:
        """Cubes [B, C, H, W] → the scalar reconstruction loss (fp32) of these
        rows. The mask is ``bool_mask`` [B, num_tokens] when given, else drawn
        with ``rng``; in training, dropout seeds are drawn from ``rng`` after
        it. ``shard``: (rank, world size) of a data-parallel step."""
        enc = self.encoder
        b = img.shape[0]
        g, n = enc.num_spectral_patches, enc.num_spatial_patches
        if bool_mask is None:
            if rng is None:
                raise ValueError("drawing a mask needs an explicit torch.Generator (rng)")
            bool_mask = self.sample_mask(b, img.device, rng, shard)
        tokens, patches = enc.tokenize_fused(img, mask=bool_mask.reshape(b, g, n).float(),
                                             mask_token=self.mask_token)
        encoded = enc.transformer_forward(tokens, seeds=enc.dropout_seeds(rng)[:2],
                                          rank=shard[0])
        wsum = self.to_pixels.decode_l1(encoded.reshape(b, g, n, enc.dim), patches,
                                        loss_weights(bool_mask, self.num_masked))
        return wsum / (b * self.num_masked * self.pixels_per_patch) / self.num_masked
