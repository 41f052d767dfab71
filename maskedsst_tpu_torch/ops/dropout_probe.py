"""Probes that read a fused layer's applied dropout masks out of its outputs.

The layer kernels regenerate their dropout masks from the counter-based
hash and never write them out. To hold the masks a kernel really applies,
at the logical indices it computes for each site, bit for bit against
:func:`~maskedsst_tpu_torch.ops.fused_layer.dropout_mask`, these probes pick
weights and inputs under which the masks show in what the layer returns.
They run at rate 0.5, so a kept value is doubled exactly. ``k1``, ``k3``,
``k5`` and ``k7`` are the keep bits of sites 1, 3, 5 and 7.

- Forward, sites 3, 5 and 7: no attention, projection bias 1, fc1 zero
  with bias 8 (GELU(8) = 8 exactly), fc2 the identity on the first F
  channels, fc2 bias 4, x = 0. Output (r, c) is ``2 k3 + 2 k7 (16 k5 + 4)``
  (``1 + ...`` without the projection site), exact in bf16: it gives
  every bit of sites 3 and 7, and of site 5 where site 7 keeps.
- Forward, site 1, one head at a time: q = k = 0, so attention is
  uniform; token j is the one-hot row e_j, whose LN output is alpha e_j; v
  and the projection are the identity on that head. Output (i, c) is
  ``x + (2 alpha / S) k1[i, c]`` for every query i and key c.
- Backward, sites 3, 5 and 7: the forward probe's MLP with fc2 all ones,
  dy = +-1 per row. The three bias gradients are the integer sums
  ``sum_r +-2 k3``, ``sum_r +-2 k7`` and ``sum_r +-4 n7_r k5`` (n7_r the
  row's kept count at site 7), exact in fp32 in any order: one differing
  bit moves one of them by at least 2.
- Backward, site 1 on the probabilities (dv = a_d^T dO), one head at a
  time: uniform attention, dy[i] = e_i through the identity projection, v
  the identity on that head. The LN1 input gradient of token j carries
  ``(2 / S) k1[c, j]`` on channel c < S and nothing on the channels >= S,
  which fixes the two free terms of LN1's backward, so the bits are solved
  back out of dx.

Not read: the backward's second use of the site-1 mask, on da (``da =
(dO v^T) * mask``). It reaches dx only through q and k, which uniform
attention needs to be zero; the gradient comparisons hold it.

Shapes: the forward site-3/5/7 probe needs F <= D; the site-1 probes need
S <= dim_head and S <= D - 2.
"""

from __future__ import annotations

import math
from typing import Callable, List, NamedTuple

import torch

from maskedsst_tpu_torch.ops.fused_layer import (
    LN_EPS,
    SITE_ATTN,
    SITE_FF_MID,
    SITE_FF_OUT,
    SITE_PROJ,
    LayerParams,
    dropout_mask,
)

RATE = 0.5


class MaskReading(NamedTuple):
    """One probe's verdict on an implementation."""

    what: str
    equal: bool  # the reading equals what dropout_mask predicts, exactly
    bits: int  # mask bits the reading covers
    margin: float  # decoded readings: worst distance to a code / half its step (< 0.5 reads clean)


def _base_params(d, heads, dh, f, device) -> LayerParams:
    i = heads * dh

    def z(*shape):
        return torch.zeros(*shape, device=device)

    return LayerParams(
        ln1_scale=torch.ones(d, device=device), ln1_bias=z(d), wqkv=z(d, 3 * i), wout=z(i, d),
        bout=z(d), ln2_scale=torch.ones(d, device=device), ln2_bias=z(d), w1=z(d, f), b1=z(f),
        w2=z(f, d), b2=z(d),
    )


def _head_select(params: LayerParams, head: int, dh: int) -> LayerParams:
    """v and the projection the identity on ``head``'s first min(dh, D)
    channels, everything else of the attention zero."""
    d, three_i = params.wqkv.shape
    i = three_i // 3
    n = min(dh, d)
    wqkv = torch.zeros_like(params.wqkv)
    wout = torch.zeros_like(params.wout)
    idx = torch.arange(n, device=wqkv.device)
    wqkv[idx, 2 * i + head * dh + idx] = 1.0
    wout[head * dh + idx, idx] = 1.0
    return params._replace(wqkv=wqkv, wout=wout)


def _keep(shape, seed, site, device) -> torch.Tensor:
    return dropout_mask(shape, seed, site, RATE, device) > 0


def read_layer_masks(
    fwd: Callable,
    bwd: Callable,
    b: int,
    s: int,
    d: int,
    heads: int,
    dh: int,
    f: int,
    io_dtype: torch.dtype,
    compute_dtype: torch.dtype,
    seed: int,
    device,
    gen: torch.Generator,
) -> List[MaskReading]:
    """Runs the four probes through ``fwd(x, params, *config)`` and
    ``bwd(x, dy, params, *config)`` (config as the fields of LayerConfig:
    the kernels' launchers or the plain versions) on a batch of b sequences
    of s tokens; ``gen`` (a CPU generator) draws the probes' random signs
    and inputs."""
    base = _base_params(d, heads, dh, f, device)
    n = b * s
    k3 = _keep((n, d), seed, SITE_PROJ, device)
    k5 = _keep((n, f), seed, SITE_FF_MID, device)
    k7 = _keep((n, d), seed, SITE_FF_OUT, device)
    k1 = _keep((b, heads, s, s), seed, SITE_ATTN, device)
    readings = []

    # --- forward, sites 3, 5, 7 ---------------------------------------------
    if f <= d:
        p = base._replace(bout=torch.ones(d, device=device), b1=torch.full((f,), 8.0, device=device),
                          w2=torch.eye(f, d, device=device), b2=torch.full((d,), 4.0, device=device))
        x = torch.zeros(b, s, d, device=device, dtype=io_dtype)
        y = fwd(x, p, heads, dh, compute_dtype, RATE, True, seed, True).float().reshape(n, d)
        ff = torch.full((n, d), 4.0, device=device)
        ff[:, :f] += 16.0 * k5
        want = 2.0 * k3 + 2.0 * k7 * ff
        readings.append(MaskReading(
            "forward sites 3 and 7 (every bit), 5 (where 7 keeps)", torch.equal(y, want),
            2 * n * d + int(k7[:, :f].sum()), 0.0))

    # --- backward, sites 3, 5, 7 --------------------------------------------
    p = base._replace(b1=torch.full((f,), 8.0, device=device), w2=torch.ones(f, d, device=device))
    x = torch.zeros(b, s, d, device=device, dtype=io_dtype)
    sign = torch.randint(0, 2, (n, 1), generator=gen).to(device, torch.float64) * 2 - 1
    dy = sign.expand(n, d).reshape(b, s, d).to(io_dtype)
    _, grads = bwd(x, dy.contiguous(), p, heads, dh, compute_dtype, RATE, True, seed, True)
    n7 = k7.sum(dim=1, keepdim=True).double()
    want = ((2 * sign * k3).sum(0), (4 * sign * n7 * k5).sum(0), (2 * sign * k7).sum(0))
    got = (grads.bout.double(), grads.b1.double(), grads.b2.double())
    readings.append(MaskReading(
        "backward sites 3, 5, 7 (sums of the bias gradients)",
        all(torch.equal(g, w) for g, w in zip(got, want)), 2 * n * d + n * f, 0.0))

    if s > dh or s > d - 2:
        return readings

    # --- forward, site 1, head by head ---------------------------------------
    onehot = torch.eye(s, d, device=device).expand(b, s, d).contiguous()
    var = (d - 1) / d**2
    rsig = 1.0 / math.sqrt(var + LN_EPS)
    p0 = base._replace(ln1_bias=torch.full((d,), rsig / d, device=device))
    x = onehot.to(io_dtype)
    step = 2.0 * float(torch.tensor(rsig).to(compute_dtype)) / s
    equal, margin = True, 0.0
    for h in range(heads):
        y = fwd(x, _head_select(p0, h, dh), heads, dh, compute_dtype, RATE, True, seed, False)
        code = (y.float() - x.float())[..., :s] / step  # [b, query, key]
        bits = code > 0.5
        equal &= torch.equal(bits, k1[:, h])
        margin = max(margin, float((code - bits.float()).abs().max()) * 2)
    readings.append(MaskReading("forward site 1 (every bit, head by head)", equal,
                                b * heads * s * s, margin))

    # --- backward, site 1 on the probabilities, head by head ----------------
    # a small spread makes LN1's rsig large beside dy's 1, so bf16 dx keeps the bits clear
    x = (0.125 * torch.randn(b, s, d, generator=gen)).to(device, io_dtype)
    xf = x.double().reshape(n, d)
    rs = 1.0 / torch.sqrt(xf.var(dim=1, unbiased=False, keepdim=True) + LN_EPS)
    z = (xf - xf.mean(dim=1, keepdim=True)) * rs
    dy = onehot.to(io_dtype)
    # least squares for the terms a + b z_c of LN1's backward on the channels >= s
    zt = z[:, s:]
    ones = torch.ones_like(zt)
    basis = torch.stack([ones, zt], dim=-1)  # [n, d - s, 2]
    pinv = torch.linalg.pinv(basis)  # [n, 2, d - s]
    equal, margin = True, 0.0
    for h in range(heads):
        dx, _ = bwd(x, dy, _head_select(base, h, dh), heads, dh, compute_dtype, RATE, True,
                    seed, False)
        r = (dx.double() - dy.double()).reshape(n, d) / rs
        coef = (pinv @ r[:, s:, None]).squeeze(-1)  # [n, 2]
        dh1 = r[:, :s] - coef[:, :1] - coef[:, 1:] * z[:, :s]
        code = (dh1 * s / 2).reshape(b, s, s)  # [b, key, query]
        bits = code > 0.5
        equal &= torch.equal(bits, k1[:, h].transpose(-1, -2))
        margin = max(margin, float((code - bits.double()).abs().max()) * 2)
    readings.append(MaskReading("backward site 1 on the probabilities (every bit, head by head)",
                                equal, b * heads * s * s, margin))
    return readings
