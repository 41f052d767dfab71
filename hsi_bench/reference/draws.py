"""The recipe's random draws, worked out again from the seed (frozen
copies of the training step's draw order, the SimMIM tube mask and the
layers' dropout hash).

One step draws from the trainer's CPU generator, in this order: the crop
origin (two ints in [0, tile - image_size), where the tiles are cropped),
a mask seed (an int in [0, 2**62)), then three dropout seeds (ints in
[0, 2**31 - 1)): the spatial stack's layer i uses seed[0] + i, the
spectral stack's seed[1] + i, as uint32. The mask is drawn on the
device from a generator seeded with the mask seed: ``mask_count`` of the
``rand_size**2`` cells of each cube chosen uniformly (the largest of
i.i.d. uniforms), upscaled to the token grid and repeated over the
spectral blocks (tube masking). A dropout site's multiplier at logical
element index i is kept when ``hash(i, seed, site) >= rate * 2**32``
and is then 1 / (1 - rate) in float32.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Optional, Tuple

import torch

M32 = 0xFFFFFFFF
SITE_ATTN, SITE_PROJ, SITE_FF_MID, SITE_FF_OUT = 1, 3, 5, 7


class Step(NamedTuple):
    xy: Optional[Tuple[int, int]]
    mask: torch.Tensor  # bool [B, g * n], block-major
    layer_seeds: List[int]  # uint32, spatial layers then spectral


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & M32


def _fmix32(h: torch.Tensor) -> torch.Tensor:
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def keep_multiplier(shape, seed: int, site: int, rate: float, device) -> torch.Tensor:
    """The float32 dropout multiplier (0 or 1 / (1 - rate)) of a site's
    tensor of ``shape`` under layer seed ``seed`` (uint32)."""
    numel = math.prod(shape)
    idx = torch.arange(numel, dtype=torch.int64, device=device)
    lo, hi = idx & M32, idx >> 32
    inner = (_mul32(torch.full_like(idx, site & M32), 0x9E3779B9)
             + _mul32(hi, 0x632BE5AB) + 0x7F4A7C15) & M32
    key = _fmix32((seed & M32) ^ _fmix32(inner))
    bits = _fmix32((_fmix32(lo ^ key) + key) & M32)
    keep = bits >= int(rate * 2**32)
    scale = float(torch.tensor(1.0 / (1.0 - rate), dtype=torch.float32))
    return (keep.to(torch.float32) * scale).reshape(shape)


def tube_mask(seed: int, batch: int, blocks: int, image_size: int, mask_patch_size: int,
              ratio: float, device) -> torch.Tensor:
    """Bool [batch, blocks * image_size**2] (patch size 1): one spatial mask
    a cube, repeated over its spectral blocks."""
    rand_size = image_size // mask_patch_size
    cells = rand_size * rand_size
    count = int(math.ceil(cells * ratio))
    gen = torch.Generator(device=device).manual_seed(seed)
    u = torch.rand(batch, cells, generator=gen, device=device)
    chosen = torch.zeros(batch, cells, dtype=torch.bool, device=device)
    chosen.scatter_(1, u.topk(count, dim=-1).indices, True)
    grid = chosen.reshape(batch, rand_size, rand_size)
    grid = grid.repeat_interleave(mask_patch_size, 1).repeat_interleave(mask_patch_size, 2)
    return grid[:, None].expand(batch, blocks, image_size, image_size).reshape(batch, -1)


def draw_step(rng: torch.Generator, cfg: dict, batch: int, tile: int, device) -> Step:
    """One training step's draws from the trainer's generator ``rng``."""
    s = int(cfg["image_size"])
    xy = None
    if tile != s:
        x0, y0 = torch.randint(0, tile - s, (2,), generator=rng).tolist()
        xy = (x0, y0)
    mask_seed = int(torch.randint(0, 2**62, (1,), generator=rng))
    blocks = int(cfg["n_bands"]) // int(cfg["band_patch_size"])
    mask = tube_mask(mask_seed, batch, blocks, s, int(cfg["mim_mask_patch_size"]),
                     float(cfg["mim_masking_ratio"]), device)
    seeds = torch.randint(0, 2**31 - 1, (3,), generator=rng).tolist()
    depth = int(cfg["transformer_depth"])
    layer_seeds = [(seeds[k] + i) & M32 for k in (0, 1) for i in range(depth)]
    return Step(xy, mask, layer_seeds)


def loss_weights(mask: torch.Tensor, num_masked: int) -> torch.Tensor:
    """1.0 on the first ``num_masked`` masked tokens of each row, else 0."""
    within = torch.cumsum(mask.to(torch.int64), dim=-1) <= num_masked
    return (mask & within).to(torch.float32)
