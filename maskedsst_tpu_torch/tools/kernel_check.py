"""On-card check and timing of the port's kernels.

    python -m maskedsst_tpu_torch.tools.kernel_check [--geometry enmap|houston] [--cpu]

Checks, each printed as one "ok"/"FAIL" line (exit code 1 when one fails):

- layer parity: ``fused_transformer_layer`` at [1280, 64, 96] fp32,
  [4096, 20, 96] fp32 and [4096, 5, 96] bf16 (compute in the input's type),
  its output and dx of ``sum(sin(y))`` against :func:`oracle_layer`, a
  composition of ``F.layer_norm``, matmuls, ``softmax`` and exact GELU
  written here, independent of the package's own plain versions; limits
  max|dy| < 5e-3 and max|ddx| / max|dx| < 1e-2 in fp32, 5e-2 and 5e-2 in
  bf16 (bf16 output is 2^-8 relative); with dropout 0.1 the same seed
  gives the same bits and train output differs from eval; per-layer ms of
  the forward and of forward + backward (CUDA events);
- the dropout generator through the ``dropout_sample`` kernel
  (:func:`check_dropout_prng`): values in {0, 1/(1-rate)}, the keep share
  within 0.01 of 1 - rate, the same seed giving the same bits, other seeds,
  sites and blocks differing in more than 5 % of the elements, and the
  kernel's bits equal to ``dropout_mask`` at [512, 128] and at the
  spatial attention site of a batch-64 step [1280, 8, 64, 64], also from a
  first index of 2^32 + 12345 (the hash's high-word branch);
- the SimMIM kernels (:func:`check_simmim_kernels`): ``fused_embed_mask``
  at batch 16 and ``fused_decode_l1`` at batch 32 in fp32, value and
  gradients against compositions written here: relative error < 1e-5 for
  the value, < 1e-3 for each gradient against its max;
- then each kernel's device time (torch.profiler) beside its bound and the
  share of the bound, at the batch-64 training shapes of ``--geometry``:
  EnMAP (20 spectral blocks) or Houston2018 (5); the bf16 layer forward
  as the training call makes it (dropout 0.1, x1 written), beside
  ``composition_ms``, the device time of :func:`composition_layer` (a
  yardstick only: no one PyTorch call computes the layer); the bf16 layer
  backward whole, its row kernel and its weight-gradient kernel
  (``layer_wgrad``); the embed forward at batch 256 (serving) and at the
  training batch and its backward, each beside ``composition_ms`` of
  :func:`composition_embed` (its autograd for the backward); the SimMIM
  decode + weighted L1 forward and backward, each beside ``composition_ms``
  of :func:`composition_decode` (its autograd for the backward).

``--cpu`` rehearses it through the plain versions with every batch cut
64-fold; no time is measured there.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Callable, List

import numpy as np
import torch
import torch.nn.functional as F

from maskedsst_tpu_torch.ops import dropout_sample, fused_embed, fused_layer, fused_simmim
from maskedsst_tpu_torch.ops.fused_layer import (
    LN_EPS,
    SITE_ATTN,
    LayerParams,
    dropout_mask,
    dropout_scale,
    fused_transformer_layer,
)
from maskedsst_tpu_torch.tools import add_common_args, device_name, device_of
from maskedsst_tpu_torch.utils.profiling import bound_ms, card_line, cuda_ms, device_ms

D, H, DH, MLP = 96, 8, 64, 64
INNER = H * DH
LAYER_CASES = ((1280, 64, torch.float32), (4096, 20, torch.float32), (4096, 5, torch.bfloat16))
LAYER_TOL = {torch.float32: (5e-3, 1e-2), torch.bfloat16: (5e-2, 5e-2)}
# the device kernels of one tensor-core layer backward: the row kernel, the
# weight-gradient kernel and their reductions
SPLIT_NAMES = ("fused_layer_bwd", "reduce_small", "layer_wgrad", "reduce_chunks")
# the device kernels of one embed backward: the block kernel (either form)
# and its reduction (reduce_partials, or reduce_tc_partials)
EMBED_BWD_NAMES = ("fused_embed_bwd", "reduce_partials", "reduce_tc_partials")
SERVE_BATCH = 256
ROWS, COLS, BLOCKS, RATE = 256, 128, 2, 0.1  # the TPU check's sample
BASE_HIGH = 2**32 + 12345
TRAIN_BATCH = 64
GEOMETRIES = {"enmap": 20, "houston": 5}  # spectral blocks of 10 bands
CPU_CUT = 64  # batch divisor of the --cpu rehearsal


def _cut(device) -> int:
    return 1 if torch.device(device).type == "cuda" else CPU_CUT


def attention_site(blocks: int, device) -> tuple:
    """The spatial attention site [B * blocks, heads, 64, 64] of a batch-64
    training step (cut on the CPU)."""
    return (TRAIN_BATCH * blocks // _cut(device), H, 64, 64)


def make_params(rng, device, d=D, inner=INNER, mlp=MLP) -> LayerParams:
    """LN scales 1, biases 0, weights N(0, 0.05^2), as the TPU check."""
    def mk(*shape):
        return torch.from_numpy((rng.standard_normal(shape) * 0.05).astype(np.float32)).to(device)

    def const(n, v):
        return torch.full((n,), v, dtype=torch.float32, device=device)

    return LayerParams(ln1_scale=const(d, 1.0), ln1_bias=const(d, 0.0), wqkv=mk(d, 3 * inner),
                       wout=mk(inner, d), bout=const(d, 0.0), ln2_scale=const(d, 1.0),
                       ln2_bias=const(d, 0.0), w1=mk(d, mlp), b1=const(mlp, 0.0),
                       w2=mk(mlp, d), b2=const(d, 0.0))


def oracle_layer(x: torch.Tensor, p: LayerParams, heads: int, dim_head: int) -> torch.Tensor:
    """The layer in plain fp32 torch ops, no dropout: the check's oracle."""
    x = x.float()
    b, s, d = x.shape
    inner = heads * dim_head
    h = F.layer_norm(x, (d,), p.ln1_scale, p.ln1_bias, eps=1e-5)
    q, k, v = ((t.reshape(b, s, heads, dim_head).transpose(1, 2))
               for t in (h @ p.wqkv).split(inner, dim=-1))
    a = torch.softmax((q @ k.transpose(-1, -2)) * dim_head**-0.5, dim=-1)
    o = (a @ v).transpose(1, 2).reshape(b, s, inner)
    x = x + o @ p.wout + p.bout
    h2 = F.layer_norm(x, (d,), p.ln2_scale, p.ln2_bias, eps=1e-5)
    return x + F.gelu(h2 @ p.w1 + p.b1) @ p.w2 + p.b2


def composition_layer(x: torch.Tensor, p: LayerParams, heads: int, dim_head: int,
                      rate: float) -> torch.Tensor:
    """The layer as a plain composition of PyTorch calls in x's dtype, with
    dropout ``rate`` at the four sites (PyTorch's own bits): LayerNorm, one
    matmul for QKV, ``scaled_dot_product_attention`` over [B, H, S, dh]
    (each batch element is one sequence), the out-projection, the GELU MLP.
    ``p`` in x's dtype. The yardstick that kernel_table times beside the
    forward kernel; the port never calls it."""
    b, s, d = x.shape
    q, k, v = (x_.transpose(1, 2) for x_ in (
        F.layer_norm(x, (d,), p.ln1_scale, p.ln1_bias, eps=LN_EPS) @ p.wqkv
    ).view(b, s, 3, heads, dim_head).unbind(2))
    o = F.scaled_dot_product_attention(q, k, v, dropout_p=rate).transpose(1, 2)
    x1 = x + F.dropout(o.reshape(b, s, heads * dim_head) @ p.wout + p.bout, rate)
    h = F.dropout(F.gelu(F.layer_norm(x1, (d,), p.ln2_scale, p.ln2_bias, eps=LN_EPS) @ p.w1
                         + p.b1), rate)
    return x1 + F.dropout(h @ p.w2 + p.b2, rate)


def composition_embed(patches: torch.Tensor, mask: torch.Tensor, preln_scale: torch.Tensor,
                      preln_bias: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
                      postln_scale: torch.Tensor, postln_bias: torch.Tensor, pos: torch.Tensor,
                      mask_token: torch.Tensor) -> torch.Tensor:
    """The fused embed (ops/fused_embed.py) as a plain composition of
    PyTorch calls in the parameters' dtype: LayerNorm over p (the pixels
    moved last), one einsum over the blocks, LayerNorm over d, + pos and
    ``torch.where`` for the 0/1 mask. The yardstick that kernel_table times
    beside the embed kernels (its autograd beside the backward); the port
    never calls it."""
    p, d = kernel.shape[1:]
    x = F.layer_norm(patches.to(kernel.dtype).transpose(2, 3), (p,), preln_scale, preln_bias,
                     eps=LN_EPS)
    t = torch.einsum("bgnp,gpd->bgnd", x, kernel) + bias[:, None, :]
    tokens = F.layer_norm(t, (d,), postln_scale, postln_bias, eps=LN_EPS) + pos
    return torch.where(mask[..., None] > 0.5, pos + mask_token, tokens)


def composition_decode(encoded: torch.Tensor, patches: torch.Tensor, kernel: torch.Tensor,
                       bias: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """The SimMIM decode + weighted L1 (ops/fused_simmim.py) as a plain
    composition of PyTorch calls in the kernel's dtype: one einsum over the
    blocks, + bias - patches, ``abs``, * weights, ``sum``. The yardstick
    that kernel_table times beside the decode kernels (its autograd beside
    the backward); the port never calls it."""
    b, g, n, _ = encoded.shape
    preds = torch.einsum("bgnd,gdp->bgpn", encoded.to(kernel.dtype), kernel)
    diff = preds + bias[None, :, :, None] - patches.to(kernel.dtype)
    return (diff.abs() * weights.to(kernel.dtype).reshape(b, g, 1, n)).sum()


def check_layer(check: Callable, device, rng) -> List[dict]:
    """Layer parity, dropout behaviour and per-layer times (see the module
    docstring); one row per case."""
    on_card = torch.device(device).type == "cuda"
    params = make_params(rng, device)
    rows = []
    for b, s, dtype in LAYER_CASES:
        b //= _cut(device)
        name = str(dtype).split(".")[1]
        x = torch.from_numpy(rng.standard_normal((b, s, D)).astype(np.float32)).to(device, dtype)
        y = fused_transformer_layer(x, params, H, DH, dtype)
        ferr = float((y.float() - oracle_layer(x, params, H, DH)).abs().max())
        xg = x.clone().requires_grad_(True)
        fused_transformer_layer(xg, params, H, DH, dtype).float().sin().sum().backward()
        xr = x.detach().float().clone().requires_grad_(True)
        oracle_layer(xr, params, H, DH).sin().sum().backward()
        gerr = float((xg.grad.float() - xr.grad).abs().max()) / max(float(xr.grad.abs().max()), 1e-9)
        tol = LAYER_TOL[dtype]
        check(ferr < tol[0] and gerr < tol[1],
              f"layer [{b},{s},{D}] {name}: max|dy| {ferr:.2e} < {tol[0]:.0e}, dx max|d|/max|ref| "
              f"{gerr:.2e} < {tol[1]:.0e} against the oracle")
        y1 = fused_transformer_layer(x, params, H, DH, dtype, RATE, True, 11)
        y2 = fused_transformer_layer(x, params, H, DH, dtype, RATE, True, 11)
        check(torch.equal(y1, y2) and not torch.equal(y1, y),
              f"layer [{b},{s},{D}] {name} dropout {RATE}: the same seed gives the same bits, "
              "train output differs from eval")
        row = dict(dims=[b, s, D], dtype=name, fwd_err=ferr, dx_rel_err=gerr,
                   fwd_ms=None, fwd_bwd_ms=None)
        if on_card:
            xt = x.clone().requires_grad_(True)

            def fwd_bwd():
                out = fused_transformer_layer(xt, params, H, DH, dtype, RATE, True, 7)
                torch.autograd.grad(out.float().sin().sum(), xt)

            row["fwd_ms"] = cuda_ms(lambda: fused_transformer_layer(x, params, H, DH, dtype))
            row["fwd_bwd_ms"] = cuda_ms(fwd_bwd)
            print(f"     layer [{b},{s},{D}] {name}: fwd {row['fwd_ms']:.3f} ms, fwd+bwd with "
                  f"dropout {row['fwd_bwd_ms']:.3f} ms per layer (CUDA events)", flush=True)
        rows.append(row)
        del y, y1, y2, xg, xr
    return rows


def sample(device, seed: int, site: int, base: int = 0,
           shape=(BLOCKS * ROWS, COLS)) -> torch.Tensor:
    """The TPU check's ``sample``: the site's multipliers of ``shape``
    through ``dropout_sample`` (the kernel on the card)."""
    return dropout_sample.dropout_sample(torch.empty(shape, device=device), seed, site, RATE, base)


def check_dropout_prng(check: Callable, device) -> None:
    """The dropout generator's invariants and bits (see the module
    docstring)."""
    scale = dropout_scale(RATE)
    for base in (0, BASE_HIGH):
        m = sample(device, 7, 1, base)
        keep = float((m > 0).float().mean())
        values = set(torch.unique(m).tolist())
        check(values <= {0.0, scale} and abs(keep - (1 - RATE)) < 0.01,
              f"dropout_sample base {base}: values {sorted(values)} in {{0, {scale:.7f}}}, keep "
              f"{keep:.4f} within 0.01 of {1 - RATE}")
        check(torch.equal(m, sample(device, 7, 1, base)),
              f"dropout_sample base {base}: the same seed gives the same bits")
        for what, other in (("seed 8 vs 7", sample(device, 8, 1, base)),
                            ("site 3 vs 1", sample(device, 7, 3, base)),
                            ("block 1 vs 0", None)):
            diff = float((m[:ROWS] != m[ROWS:]).float().mean() if other is None
                         else (other != m).float().mean())
            check(diff > 0.05, f"dropout_sample base {base}: {what} differ in {diff:.3f} > 0.05")
        want = dropout_sample.dropout_sample_reference(m.numel(), 7, 1, RATE, base, device)
        if base == 0:
            want = dropout_mask(m.shape, 7, 1, RATE, device).reshape(-1)
        check(torch.equal(m.reshape(-1), want),
              f"dropout_sample [{BLOCKS * ROWS},{COLS}] base {base} == "
              f"{'dropout_mask' if base == 0 else 'hash_bits at base + arange'}, bit for bit")
    shape = attention_site(GEOMETRIES["enmap"], device)
    for base in (0, BASE_HIGH):
        m = sample(device, 1064, SITE_ATTN, base, shape)
        if base == 0:
            want = dropout_mask(shape, 1064, SITE_ATTN, RATE, device)
        else:
            want = dropout_sample.dropout_sample_reference(m.numel(), 1064, SITE_ATTN, RATE, base,
                                                           device).view(shape)
        check(torch.equal(m, want), f"dropout_sample {list(shape)} (attention site) base {base} "
                                    "== the plain hash, bit for bit")
        del m, want


def _relerr(got, want) -> float:
    return max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-9)
               for a, b in zip(got, want))


def _t(rng, device, *shape, scale=1.0, base=0.0):
    return torch.from_numpy((base + scale * rng.standard_normal(shape)).astype(np.float32)).to(device)


def check_simmim_kernels(check: Callable, device, rng) -> None:
    """fused_embed_mask and fused_decode_l1 in fp32 against compositions
    written here (see the module docstring)."""
    b, g, p, n, d = 16, 20, 10, 64, 96
    pat = _t(rng, device, b, g, p, n)
    mask = torch.from_numpy(rng.integers(0, 2, (b, g, n)).astype(np.float32)).to(device)
    params = [_t(rng, device, p, base=1.0, scale=0.1), _t(rng, device, p, scale=0.1),
              _t(rng, device, g, p, d, scale=0.05), _t(rng, device, g, d, scale=0.1),
              _t(rng, device, d, base=1.0, scale=0.1), _t(rng, device, d, scale=0.1),
              _t(rng, device, g, n, d, scale=0.02), _t(rng, device, d, scale=0.02)]

    def emb_oracle(prs, prb, k, bias, pls, plb, pos, mtok):
        mu = pat.mean(dim=2, keepdim=True)
        z = (pat - mu) * torch.rsqrt(((pat - mu) ** 2).mean(dim=2, keepdim=True) + 1e-5)
        xln = z * prs[None, None, :, None] + prb[None, None, :, None]
        t = torch.einsum("bgpn,gpd->bgnd", xln, k) + bias[None, :, None, :]
        tok = F.layer_norm(t, (d,), pls, plb, eps=1e-5) + pos[None]
        return torch.where(mask[..., None] > 0.5, mtok + pos[None], tok)

    def value_and_grads(fn, args):
        args = [a.clone().requires_grad_(True) for a in args]
        value = fn(*args)
        grads = torch.autograd.grad(value, args)
        return float(value.detach()), grads

    vf, gf = value_and_grads(
        lambda *a: (fused_embed.fused_embed_mask(pat, mask, *a, torch.float32) ** 2).sum(), params)
    vx, gx = value_and_grads(lambda *a: (emb_oracle(*a) ** 2).sum(), params)
    rel, gerr = abs(vf - vx) / abs(vx), _relerr(gf, gx)
    check(rel < 1e-5 and gerr < 1e-3, f"fused_embed_mask [{b},{g},{p},{n}]->{d} fp32: value "
                                      f"rel {rel:.2e} < 1e-5, gradients rel {gerr:.2e} < 1e-3")

    b2 = 32
    enc = _t(rng, device, b2, g, n, d)
    pat2 = _t(rng, device, b2, g, p, n)
    kd, bd = _t(rng, device, g, d, p, scale=0.05), _t(rng, device, g, p, scale=0.1)
    w = torch.from_numpy(rng.integers(0, 2, (b2, g * n)).astype(np.float32)).to(device)

    def dec_oracle(enc, kd, bd):
        preds = torch.einsum("bgnd,gdp->bgpn", enc, kd) + bd[None, :, :, None]
        return ((preds - pat2).abs() * w.reshape(b2, g, 1, n)).sum()

    vf, gf = value_and_grads(
        lambda e, k, bb: fused_simmim.fused_decode_l1(e, pat2, k, bb, w, torch.float32), [enc, kd, bd])
    vx, gx = value_and_grads(dec_oracle, [enc, kd, bd])
    rel, gerr = abs(vf - vx) / abs(vx), _relerr(gf, gx)
    check(rel < 1e-5 and gerr < 1e-3, f"fused_decode_l1 [{b2},{g},{n},{d}]->{p} fp32: value "
                                      f"rel {rel:.2e} < 1e-5, gradients rel {gerr:.2e} < 1e-3")


# --- each kernel's work, the one home of the bounds that this tool and
# chip_smoke.py report: {"fwd": (bytes, operations), "bwd": ...}, the bytes
# of each input read once and each output written once; ``item`` is the
# byte width of the compute dtype (activations, matmul weights, outputs) ---

def layer_cost(b: int, s: int, item: int, d: int = D, inner: int = INNER,
               mlp: int = MLP) -> dict:
    """(bytes, operations) of one fused layer over [b, s, d]. "fwd": reads x
    and the weights (fp32 LN parameters and biases), writes y. "bwd", the
    FMA form: also reads dy, writes dx and the fp32 parameter gradients,
    for three times the forward's operations. The tensor-core form's split:
    "bwd_tc", the whole (as "bwd", and reads the forward's fp32 x1);
    "rows", its row kernel (writes the small vectors' gradients and the
    weight gradients' bf16 operands, and leaves the weight-gradient
    operations out); "wgrad", its weight-gradient kernel
    (:func:`wgrad_cost`)."""
    tokens = b * s
    flops = tokens * (2 * d * 3 * inner + 2 * 2 * s * inner + 2 * inner * d + 2 * 2 * d * mlp)
    wbytes = (d * 3 * inner + inner * d + 2 * d * mlp) * item + 4 * (6 * d + mlp)
    grads = 2 * d + d * 3 * inner + inner * d + 3 * d + d * mlp + mlp + mlp * d + d
    bwd = 3 * tokens * d * item + wbytes + 4 * grads
    wg_bytes, wg_flops = wgrad_cost(tokens, d, inner, mlp)
    weights = d * (4 * inner + 2 * mlp)  # the four weight gradients' entries
    operands = 2 * tokens * (4 * inner + 2 * mlp + 4 * d)
    return {"fwd": (2 * tokens * d * item + wbytes, flops),
            "bwd": (bwd, 3 * flops),
            "bwd_tc": (bwd + 4 * tokens * d, 3 * flops),
            "rows": (bwd + 4 * tokens * d - 4 * weights + operands, 3 * flops - wg_flops),
            "wgrad": (wg_bytes, wg_flops)}


def wgrad_cost(n: int, d: int = D, inner: int = INNER, mlp: int = MLP) -> tuple:
    """(bytes, operations) of ``layer_wgrad`` over n rows: it reads the bf16
    operands (h1, dqkv, o, dp1, h2, du, gd, dp2: 2 (4I + 2F + 4D) bytes a
    row) and writes the four fp32 weight gradients, d (4I + 2F) entries,
    each an n-term sum of products."""
    m = 4 * inner + 2 * mlp
    return 2 * n * (m + 4 * d) + 4 * d * m, 2 * n * d * m


def embed_cost(b: int, g: int, p: int, n: int, d: int, item: int) -> dict:
    """The fused embed of fp32 patches [b, g, p, n] and mask [b, g, n] into
    tokens [b, g, n, d]: the forward also reads the kernel, the fp32 LN
    parameters, bias, pos and mask token; the backward reads dtok and the
    parameters but pos and the mask token, and writes the eight fp32
    gradients."""
    tokens = b * g * n
    data = 4 * b * g * p * n + 4 * b * g * n + g * p * d * item + tokens * d * item
    fwd = data + 4 * (2 * p + g * d + 2 * d + g * n * d + d)
    bwd = data + 4 * (2 * p + g * d + 2 * d) + 4 * (2 * p + g * p * d + g * d + 2 * d
                                                    + g * n * d + d)
    return {"fwd": (fwd, tokens * 2 * p * d), "bwd": (bwd, tokens * 6 * p * d)}


def decode_cost(b: int, g: int, n: int, d: int, p: int, item: int) -> dict:
    """The per-block decode + weighted L1 of encoded [b, g, n, d] against
    fp32 patches: the forward reads them, the kernel, the fp32 bias and
    weights and writes one sum; the backward also writes d encoded and the
    fp32 kernel and bias gradients."""
    tokens = b * g * n
    fwd = tokens * d * item + tokens * p * 4 + g * d * p * item + g * p * 4 + tokens * 4 + 4
    return {"fwd": (fwd, 2 * tokens * d * p + 5 * tokens * p),
            "bwd": (fwd + tokens * d * item + 4 * (g * d * p + g * p),
                    6 * tokens * d * p + 5 * tokens * p)}


def dropout_sample_cost(numel: int) -> tuple:
    """``numel`` fp32 multipliers written; the hash's integer work is not
    counted against a floating-point peak."""
    return 4 * numel, 0


def dropout_sample_cases(device, blocks: int = GEOMETRIES["enmap"]) -> List[dict]:
    """Device ms of the ``dropout_sample`` kernel and of its plain version on
    the card, with the bound (bytes written), at the TPU check's [512, 128]
    and the attention site of a batch-64 step."""
    cases = []
    for label, shape in (("tpu_check", (BLOCKS * ROWS, COLS)),
                         ("attention_site", attention_site(blocks, device))):
        out = torch.empty(shape, device=device)
        numel = out.numel()
        ms = device_ms(lambda: dropout_sample._launch(out, 1064, SITE_ATTN, RATE),
                       names=("dropout_sample",))
        plain = device_ms(lambda: dropout_sample.dropout_sample_reference(
            numel, 1064, SITE_ATTN, RATE, 0, device))
        nbytes, flops = dropout_sample_cost(numel)
        bms, by = bound_ms(nbytes, flops, "float32")
        got = dropout_sample._launch(out, 1064, SITE_ATTN, RATE)
        err = float((got.reshape(-1) - dropout_sample.dropout_sample_reference(
            numel, 1064, SITE_ATTN, RATE, 0, device)).abs().max())
        cases.append(dict(shape=label, dims=list(shape), dtype="float32", max_abs_err=err, ms=ms,
                          plain_ms=plain, bound_ms=bms, bound_by=by, bytes=nbytes))
        print(f"     dropout_sample {label} {list(shape)}: device ms {ms:.4f}, plain {plain:.4f}, "
              f"bound {bms:.4f} ({by}), share of bound {bms / ms:.1%}", flush=True)
        del out, got
    return cases


def kernel_table(device, geometry: str = "enmap") -> List[dict]:
    """Each kernel's device ms (torch.profiler) at the batch-64 bf16
    training shapes of ``geometry`` (the embed forward at batch 256 too),
    its bound and share of bound."""
    gen = torch.Generator().manual_seed(0)
    g, p, n, b = GEOMETRIES[geometry], 10, 64, TRAIN_BATCH
    bf = torch.bfloat16
    params = make_params(np.random.default_rng(0), device)
    cfg = (H, DH, bf, RATE, True, 1000, True)
    rows = []

    def row(kernel, label, dims, fn, names, cost, dtype="bfloat16"):
        ms = device_ms(fn, names=names)
        bms, by = bound_ms(*cost, dtype)
        rows.append(dict(kernel=kernel, shape=label, dims=dims, dtype=dtype, ms=ms, bound_ms=bms,
                         bound_by=by, share_of_bound=bms / ms))
        print(f"     {geometry} {kernel} {label} {dims} {dtype}: device ms {ms:.4f}, bound "
              f"{bms:.4f} ({by}), share of bound {bms / ms:.1%}", flush=True)

    def r(*shape, base=0.0, scale=0.1):
        return (base + scale * torch.randn(*shape, generator=gen)).to(device)

    comp_params = LayerParams(*(t.to(bf) for t in params))
    for label, bb, s in (("spatial", b * g, 64), ("spectral", b * n, g)):
        x = torch.randn(bb, s, D, generator=gen).to(device, bf)
        dy = torch.randn(bb, s, D, generator=gen).to(device, bf)
        cost = layer_cost(bb, s, 2)
        # the forward as the training call makes it: it writes x1, from
        # which the backward's split (row kernel + layer_wgrad) starts
        x1 = torch.empty(x.shape, dtype=torch.float32, device=device)
        row("fused_layer_fwd", label, [bb, s, D],
            lambda: fused_layer._launch(x, params, *cfg, x1=x1), ("fused_layer_fwd",),
            cost["fwd"])
        comp = device_ms(lambda: composition_layer(x, comp_params, H, DH, RATE))
        rows[-1]["composition_ms"] = comp
        print(f"     {geometry} fused_layer_fwd {label}: composition_ms {comp:.4f} (LN, matmul, "
              f"scaled_dot_product_attention, GELU MLP, dropout {RATE}; kernel "
              f"{rows[-1]['ms']:.4f})", flush=True)

        def bwd():
            return fused_layer._launch_bwd(x, dy, params, *cfg, x1=x1)

        for kernel, names, part in (
                ("fused_layer_bwd", SPLIT_NAMES, "bwd_tc"),
                ("fused_layer_bwd rows", ("fused_layer_bwd", "reduce_small"), "rows"),
                ("layer_wgrad", ("layer_wgrad", "reduce_chunks"), "wgrad")):
            row(kernel, label, [bb, s, D], bwd, names, cost[part])
        del x, dy, x1
    def embed_args(bb):
        mask = (torch.rand(bb, g, n, generator=gen) < 0.7).float().to(device)
        return (torch.randn(bb, g, p, n, generator=gen).to(device), mask, r(p, base=1.0), r(p),
                r(g, p, D, scale=p**-0.5), r(g, D), r(D, base=1.0), r(D), r(g, n, D, scale=1.0),
                r(D, scale=1.0))

    def composition_row(fn, what):
        comp = device_ms(fn)
        rows[-1]["composition_ms"] = comp
        print(f"     {geometry} {rows[-1]['kernel']} {rows[-1]['shape']}: composition_ms "
              f"{comp:.4f} ({what}; kernel {rows[-1]['ms']:.4f})", flush=True)

    # the embed at batch 256 (serving), then at the training batch
    for label, bb in (("embed b256", SERVE_BATCH), ("embed", b)):
        args = embed_args(bb)
        cparams = [a.to(bf).requires_grad_() for a in args[2:]]
        row("fused_embed_fwd", label, [bb, g, p, n, D], lambda: fused_embed._launch(*args, bf),
            ("fused_embed_fwd",), embed_cost(bb, g, p, n, D, 2)["fwd"])
        with torch.no_grad():
            composition_row(lambda: composition_embed(*args[:2], *cparams),
                            "LN, einsum, LN, + pos, where")
    dtok = torch.randn(b, g, n, D, generator=gen).to(device, bf)
    row("fused_embed_bwd", "embed", [b, g, p, n, D],
        lambda: fused_embed._launch_bwd(*args, dtok, bf), EMBED_BWD_NAMES,
        embed_cost(b, g, p, n, D, 2)["bwd"])
    tokens = composition_embed(*args[:2], *cparams)
    composition_row(lambda: torch.autograd.grad(tokens, cparams, dtok, retain_graph=True),
                    "the composition's autograd")
    patches = args[0]
    enc = torch.randn(b, g, n, D, generator=gen).to(device, bf)
    kern, bias = r(g, D, p, scale=D**-0.5), r(g, p)
    weights = (torch.rand(b, g * n, generator=gen) < 0.7).float().to(device)
    gout = torch.tensor(1e-6, device=device)
    dargs = (enc, patches, kern, bias, weights)
    cost = decode_cost(b, g, n, D, p, 2)
    row("fused_simmim_fwd", "simmim", [b, g, n, D, p], lambda: fused_simmim._launch(*dargs, bf),
        ("fused_simmim_fwd", "sum_partials"), cost["fwd"])
    cenc, ckern, cbias = cdargs = [t.to(bf).clone().requires_grad_() for t in (enc, kern, bias)]
    with torch.no_grad():
        composition_row(lambda: composition_decode(cenc, patches, ckern, cbias, weights),
                        "einsum, + bias - patches, abs, * weights, sum")
    row("fused_simmim_bwd", "simmim", [b, g, n, D, p],
        lambda: fused_simmim._launch_bwd(*dargs, gout, bf), ("fused_simmim_bwd", "reduce_partials"),
        cost["bwd"])
    loss = composition_decode(cenc, patches, ckern, cbias, weights)
    composition_row(lambda: torch.autograd.grad(loss, cdargs, gout.to(bf), retain_graph=True),
                    "the composition's autograd")
    out = torch.empty(attention_site(g, device), device=device)
    row("dropout_sample", "attention_site", list(out.shape),
        lambda: dropout_sample._launch(out, 1064, SITE_ATTN, RATE), ("dropout_sample",),
        dropout_sample_cost(out.numel()), dtype="float32")
    return rows


def run(check: Callable, device="cuda", geometry: str = "enmap") -> dict:
    """Every check of the tool through ``check(cond, msg)``, then (on the
    card) the kernels' times; returns the rows."""
    rng = np.random.default_rng(0)
    out = {"layers": check_layer(check, device, rng)}
    check_dropout_prng(check, device)
    check_simmim_kernels(check, device, rng)
    if torch.device(device).type == "cuda":
        out["kernels"] = kernel_table(device, geometry)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--geometry", choices=sorted(GEOMETRIES), default="enmap",
                    help="the training shapes of the kernel times")
    add_common_args(ap)
    args = ap.parse_args(argv)
    device = device_of(args)
    failures = []

    def check(cond: bool, msg: str) -> None:
        print(("ok   " if cond else "FAIL ") + msg, flush=True)
        if not cond:
            failures.append(msg)

    result = run(check, device, args.geometry)
    card = card_line() if device == "cuda" else "cpu (plain versions; nothing timed)"
    print(card)
    print(json.dumps({"kernel_check": {"device": device_name(device), "geometry": args.geometry,
                                       "failures": len(failures), **result}}))
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
