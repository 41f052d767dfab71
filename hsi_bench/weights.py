"""Weights and inputs made from the seed, on the device, in a few large
calls: one normal draw for all the weights, four for the tiles or cubes.

Each weight takes its scale from its role (the reference's layout,
``reference/model.py::weight_shapes``): LayerNorm scales 1 + 0.1 z,
biases 0.1 z, positional tables and the mask token z, matrices and
per-block kernels z / sqrt(fan_in), fan_in their second axis.
"""

from __future__ import annotations

import sys
import time
from collections import OrderedDict
from typing import Callable, Dict

import numpy as np
import torch

from hsi_bench.reference.model import weight_shapes

UNIT = ("pos_embedding", "pos_embed", "channel_embed", "mask_token")


def sub_seeds(seed: int, n: int) -> list:
    """``n`` independent 62-bit seeds from a run's ``--seed``."""
    state = np.random.SeedSequence(int(seed)).generate_state(n, np.uint64)
    return [int(s >> 2) for s in state]


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed))


def make(cfg: dict, kind: str, seed: int, device) -> "OrderedDict[str, torch.Tensor]":
    """Every weight of the ``kind`` model, float32 on ``device``."""
    shapes = weight_shapes(cfg, kind)
    sizes = [int(np.prod(s)) for s in shapes.values()]
    z = torch.randn(sum(sizes), generator=generator(seed, device), device=device)
    out: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    for (name, shape), part in zip(shapes.items(), z.split(sizes)):
        part = part.reshape(shape)
        last = name.rsplit(".", 1)[-1]
        if name.endswith("norm.weight"):
            t = 1.0 + 0.1 * part
        elif last == "bias" or last == "blockwise_bias":
            t = 0.1 * part
        elif last in UNIT:
            t = part
        else:
            t = part / float(shape[1]) ** 0.5
        out[name] = t.contiguous()
    return out


def load_into(model: torch.nn.Module, weights: Dict[str, torch.Tensor]) -> None:
    """Copies ``weights`` into the model's parameters, whose names and
    shapes have to be the reference's layout."""
    params = dict(model.named_parameters())
    got = {k: tuple(p.shape) for k, p in params.items()}
    want = {k: tuple(t.shape) for k, t in weights.items()}
    if got != want:
        raise ValueError(f"the model's parameters differ from the reference's layout: "
                         f"only in the model {sorted(set(got) - set(want))}, only in the "
                         f"reference {sorted(set(want) - set(got))}, shapes "
                         f"{sorted(k for k in got if k in want and got[k] != want[k])}")
    with torch.no_grad():
        for name, p in params.items():
            p.copy_(weights[name])


def cubes(shape, seed: int, device) -> torch.Tensor:
    """float32 hyperspectral cubes [N, C, H, W] on ``device``: each cube a
    smooth spectrum (a random walk over the bands) plus a spatial texture
    and pixel noise, scaled by a brightness drawn log-normally (sigma 1:
    scenes span dark water to bright soil about tenfold), so that cubes
    differ from one another as a scene's do and a batch's mean is not any
    half of it."""
    n, c, h, w = shape
    gen = generator(seed, device)
    bright = torch.exp(torch.randn(n, 1, 1, 1, generator=gen, device=device))
    spectrum = torch.randn(n, c, 1, 1, generator=gen, device=device).cumsum(1) / c**0.5
    texture = 0.5 * torch.randn(n, 1, h, w, generator=gen, device=device)
    x = torch.randn(shape, generator=gen, device=device).mul_(0.3)
    return x.add_(spectrum).add_(texture).mul_(bright)


def phases() -> Callable[[str], None]:
    """A clock whose calls print the seconds since its last call, naming
    the set-up phase just ended, on standard error."""
    last = [time.perf_counter()]

    def done(name: str) -> None:
        now = time.perf_counter()
        print(f"set-up: {name} {now - last[0]:.2f} s", file=sys.stderr)
        last[0] = now

    return done
