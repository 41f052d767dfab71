"""Rounding of matrix-product operands: the reference keeps float32; the
control rounds each operand to float8 (e4m3) with one scale a tensor, the
precision below the recipe's bfloat16, its gradient passed straight
through."""

from __future__ import annotations

import torch

FP8_MAX = 448.0  # the largest finite float8_e4m3fn


def exact(t: torch.Tensor) -> torch.Tensor:
    return t


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        scale = t.detach().abs().amax().clamp_min(1e-30) / FP8_MAX
        return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale

    @staticmethod
    def backward(ctx, g):
        return g


def fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under a per-tensor scale (amax / 448)."""
    return _Fp8.apply(t)


ROUNDINGS = {"float32": exact, "fp8": fp8}
