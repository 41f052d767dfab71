#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (maskedsst_tpu_torch) on one NVIDIA GPU.

Run from the repo root on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py

Phases:
  0. build: compiles every CUDA kernel (layer and embed, forward and
     backward) from csrc/ with nvcc for sm_90a into build/kernels/ (one nvcc
     per source, in parallel);
  1. forward kernels vs plain: each forward kernel against its plain
     PyTorch version on the card, at the serving shapes (batch 256) in fp32
     (TF32 off) and bf16, plus the Houston spectral shape (seq 5) for the
     layer; max |error|, CUDA-event medians of kernel and plain version, and
     the bound;
  1b. backward kernels vs plain, at the training shapes of batch 64 (layer
     spatial [1280, 64, 96], spectral [4096, 20, 96], Houston [4096, 5, 96]
     at dropout 0 and 0.1; embed [64, 20, 10, 64] -> 96), fp32 and bf16:
     the error per gradient, the dropout masks that the forward and
     backward kernels apply, read out of their outputs by the probes of
     ops/dropout_probe.py and held bit for bit against dropout_mask, two
     calls giving the same gradient bits, timings and bounds; plus the
     forward's times with dropout;
  2. serving path: the EnMAP-DFC classifier (configs/finetune_config_enmap.yaml
     + configs/config.yaml, seeded weights) in bf16 and fp32 behind
     Predictor(batch_size=256) answers requests of N = 300, 256, 1, 0 cubes;
     checks shapes, finiteness, agreement with the same model run through
     the plain versions on the card, and the kernels' launch counts; then
     measures cubes/s;
  3. training path: Finetuner on the same config with SyntheticCubeDataset
     tiles, (a) the recipe (dropout 0.1, embedding dropout 0.1: the plain
     embed route) and (b) embedding dropout 0 (the fused embed route), in
     bf16, a few steps at batch 2 then 20 at batch 64; checks finite
     losses, the exact launches of all four kernels at every step, one
     step's gradients against the same step through the plain versions on
     the card (same seeds, so the same masks) per tensor relative to the
     tensor's own largest value, and that the loss falls over 30 steps;
     then measures steps/s and cubes/s at batch 64 in bf16 and fp32.

Prints every check and measurement as it goes, the card's name and power
limit, a JSON line of the kernels, and as its last line {"ok": true,
"device": {...}}; redirect standard output to keep the record. Exits
non-zero, printing no result, when a phase fails or when there is no CUDA
device.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}  # fp32 without tensor cores; bf16 dense
BATCH = 256
TRAIN_BATCH = 64
REQUESTS = (300, 256, 1, 0)
SEED = 0
# Tolerances on max |kernel - plain| / max(1, |plain|), elementwise. fp32: the
# two differ only in summation order and fast-math intrinsics (~1e-6 per
# layer). bf16: both round every matmul operand to bf16 at the same points, but
# a one-ulp difference before a rounding flips that bf16 value (2^-8 relative)
# and the output itself is bf16.
TOL_OP = {"float32": 1e-4, "bfloat16": 3e-2}
TOL_MODEL = {"float32": 1e-3, "bfloat16": 1e-1}
# One training step's gradients against the same step through the plain
# versions: max |kernel - plain| / max |plain|, per tensor (the gradients of
# a mean loss are far below 1, so max(1, .) would hide a wrong leaf). The
# bf16 limit is 2.5x the largest reading of sound runs (6e-3 on an H100,
# PERF.md) and below what a fault reads in most leaves: 1 for a zeroed leaf;
# for the step with other dropout masks, printed beside each check.
TOL_STEP = {"float32": 1e-4, "bfloat16": 1.5e-2}
LIBRARY_NONE = {
    "fused_layer_fwd": "no single PyTorch call computes the layer: its inner width "
    "(8 x 64 = 512) differs from dim 96, so nn.TransformerEncoderLayer does not fit",
    "fused_layer_bwd": "no single PyTorch call computes the fused layer backward "
    "(recompute, dropout masks and all 11 parameter gradients)",
    "fused_embed_fwd": "no single PyTorch call computes the per-block pre-LN, "
    "product, post-LN, + pos and mask select",
    "fused_embed_bwd": "no single PyTorch call computes the per-block embed backward "
    "with its two LNs and the mask select",
}

failures: list = []


def check(cond: bool, msg: str) -> None:
    print(("ok   " if cond else "FAIL ") + msg, flush=True)
    if not cond:
        failures.append(msg)


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median CUDA-event time of one call, in ms."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def rel_err(got, want) -> tuple:
    """(max |got - want|, max |got - want| / max(1, |want|))."""
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    return float(diff.max()), float((diff / want.abs().clamp_min(1.0)).max())


def bound_ms(nbytes: float, flops: float, dtype: str) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def random_layer_params(gen, d, heads, dh, f, device):
    import torch

    from maskedsst_tpu_torch.ops.fused_layer import LayerParams

    i = heads * dh

    def w(*shape):
        return (torch.randn(*shape, generator=gen) / math.sqrt(shape[0])).to(device)

    def vec(n, base=0.0):
        return (base + 0.1 * torch.randn(n, generator=gen)).to(device)

    return LayerParams(
        ln1_scale=vec(d, 1.0), ln1_bias=vec(d), wqkv=w(d, 3 * i), wout=w(i, d), bout=vec(d),
        ln2_scale=vec(d, 1.0), ln2_bias=vec(d), w1=w(d, f), b1=vec(f), w2=w(f, d), b2=vec(d),
    )


def phase_layer(gen):
    """fused_layer_fwd against reference_layer at the serving shapes."""
    import torch

    from maskedsst_tpu_torch.ops import fused_layer

    d, heads, dh, f = 96, 8, 64, 64
    i = heads * dh
    params = random_layer_params(gen, d, heads, dh, f, "cuda")
    cases = []
    for label, b, s in (("spatial", BATCH * 20, 64), ("spectral", BATCH * 64, 20),
                        ("houston_spectral", BATCH * 64, 5)):
        x32 = torch.randn(b, s, d, generator=gen).cuda()
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[1]
            x = x32.to(dtype)
            got = fused_layer.fused_transformer_layer(x, params, heads, dh, dtype)
            want = fused_layer.reference_layer(x, params, heads, dh, dtype)
            torch.cuda.synchronize()
            abs_err, err = rel_err(got, want)
            check(bool(torch.isfinite(got.float()).all()) and err <= TOL_OP[name],
                  f"fused_layer_fwd {label} [{b},{s},{d}] {name}: max|d| {abs_err:.3e}, "
                  f"max|d|/max(1,|ref|) {err:.3e} <= {TOL_OP[name]:.0e}")
            ms = cuda_ms(lambda: fused_layer.fused_transformer_layer(x, params, heads, dh, dtype))
            plain = cuda_ms(lambda: fused_layer.reference_layer(x, params, heads, dh, dtype))
            tokens = b * s
            flops = tokens * (2 * d * 3 * i + 2 * 2 * s * i + 2 * i * d + 2 * 2 * d * f)
            item = x.element_size()
            nbytes = 2 * tokens * d * item + (d * 3 * i + i * d + 2 * d * f) * item + 4 * (6 * d + f)
            bms, by = bound_ms(nbytes, flops, name)
            cases.append(dict(shape=label, dims=[b, s, d], dtype=name, max_abs_err=abs_err,
                              rel_err=err, ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by,
                              flops=flops, bytes=nbytes))
            print(f"     ms {ms:.4f} plain_ms {plain:.4f} bound_ms {bms:.4f} ({by}) "
                  f"-> {flops / ms / 1e9:.2f} TFLOP/s", flush=True)
            del got, want
    return cases


def phase_embed(gen):
    """fused_embed_fwd against fused_embed_mask_reference at [256, 20, 10, 64]."""
    import torch

    from maskedsst_tpu_torch.ops import fused_embed

    b, g, p, n, d = BATCH, 20, 10, 64, 96
    patches = torch.randn(b, g, p, n, generator=gen).cuda()
    mask = (torch.rand(b, g, n, generator=gen) < 0.7).float().cuda()

    def r(*shape, base=0.0, scale=0.1):
        return (base + scale * torch.randn(*shape, generator=gen)).cuda()

    args = (patches, mask, r(p, base=1.0), r(p), r(g, p, d, scale=p**-0.5), r(g, d),
            r(d, base=1.0), r(d), r(g, n, d, scale=1.0), r(d, scale=1.0))
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        got = fused_embed.fused_embed_mask(*args, dtype)
        want = fused_embed.fused_embed_mask_reference(*args, dtype)
        torch.cuda.synchronize()
        abs_err, err = rel_err(got, want)
        check(got.dtype == want.dtype and bool(torch.isfinite(got.float()).all())
              and err <= TOL_OP[name],
              f"fused_embed_fwd [{b},{g},{p},{n}]->{d} {name} (random mask, nonzero mask_token): "
              f"max|d| {abs_err:.3e}, max|d|/max(1,|ref|) {err:.3e} <= {TOL_OP[name]:.0e}")
        ms = cuda_ms(lambda: fused_embed.fused_embed_mask(*args, dtype))
        plain = cuda_ms(lambda: fused_embed.fused_embed_mask_reference(*args, dtype))
        tokens = b * g * n
        flops = tokens * 2 * p * d
        out_item = 2 if dtype == torch.bfloat16 else 4
        nbytes = (patches.numel() * 4 + mask.numel() * 4 + tokens * d * out_item
                  + g * p * d * out_item + 4 * (2 * p + g * d + 2 * d + g * n * d + d))
        bms, by = bound_ms(nbytes, flops, name)
        cases.append(dict(shape="embed", dims=[b, g, p, n, d], dtype=name, max_abs_err=abs_err,
                          rel_err=err, ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by,
                          flops=flops, bytes=nbytes))
        print(f"     ms {ms:.4f} plain_ms {plain:.4f} bound_ms {bms:.4f} ({by}) "
              f"-> {nbytes / ms / 1e6:.1f} GB/s", flush=True)
    return cases


def grad_err(got, want) -> tuple:
    """(max |got - want|, that over max(1, max |want|)): per tensor."""
    diff = float((got.float() - want.float()).abs().max())
    return diff, diff / max(1.0, float(want.float().abs().max()))


def phase_layer_bwd(gen):
    """fused_layer_bwd against reference_layer_bwd at the training shapes,
    the masks bit for bit, determinism, and the forward's times with
    dropout."""
    import torch

    from maskedsst_tpu_torch.ops import dropout_probe, fused_layer
    from maskedsst_tpu_torch.ops.fused_layer import LayerParams

    d, heads, dh, f = 96, 8, 64, 64
    i = heads * dh
    params = random_layer_params(gen, d, heads, dh, f, "cuda")
    names = ("dx",) + LayerParams._fields
    bwd_cases, fwd_cases = [], []
    for label, b, s in (("spatial", TRAIN_BATCH * 20, 64), ("spectral", TRAIN_BATCH * 64, 20),
                        ("houston_spectral", TRAIN_BATCH * 64, 5)):
        x32 = torch.randn(b, s, d, generator=gen).cuda()
        dy32 = torch.randn(b, s, d, generator=gen).cuda()
        seed = 1000 + s
        tokens = b * s
        fwd_flops = tokens * (2 * d * 3 * i + 2 * 2 * s * i + 2 * i * d + 2 * 2 * d * f)
        count = 2 * d + d * 3 * i + i * d + 3 * d + d * f + f + f * d + d
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[1]
            x, dy = x32.to(dtype), dy32.to(dtype)
            # the masks the kernels apply, read out of their outputs
            for r in dropout_probe.read_layer_masks(
                    fused_layer._launch, fused_layer._launch_bwd, b, s, d, heads, dh, f, dtype,
                    dtype, 2**31 + seed, "cuda", gen):
                check(r.equal and r.margin < 0.5,
                      f"dropout masks {label} {name}, {r.what}: {r.bits} bits read from the "
                      f"kernels == dropout_mask, bit for bit (decode margin {r.margin:.3f})")
            torch.cuda.empty_cache()
            item = x.element_size()
            wbytes = (d * 3 * i + i * d + 2 * d * f) * item + 4 * (6 * d + f)
            for rate in (0.0, 0.1):
                cfg = (heads, dh, dtype, rate, rate > 0, seed, True)
                # the forward with dropout: its time, and that it keeps the
                # plain version's masks
                if rate:
                    got = fused_layer.fused_transformer_layer(x, params, *cfg)
                    want = fused_layer.reference_layer(x, params, *cfg)
                    abs_err, err = rel_err(got, want)
                    check(bool(torch.isfinite(got.float()).all()) and err <= TOL_OP[name],
                          f"fused_layer_fwd dropout 0.1 {label} [{b},{s},{d}] {name}: "
                          f"max|d| {abs_err:.3e}, rel {err:.3e} <= {TOL_OP[name]:.0e}")
                    del got, want
                    ms = cuda_ms(lambda: fused_layer.fused_transformer_layer(x, params, *cfg),
                                 reps=10)
                    bms, by = bound_ms(2 * tokens * d * item + wbytes, fwd_flops, name)
                    fwd_cases.append(dict(shape=f"{label}_train", dims=[b, s, d], dtype=name,
                                          dropout=rate,
                                          ms=ms, bound_ms=bms, bound_by=by))
                    print(f"     fused_layer_fwd dropout 0.1 ms {ms:.4f} bound_ms {bms:.4f} "
                          f"({by})", flush=True)
                dx, grads = fused_layer._launch_bwd(x, dy, params, *cfg)
                want_dx, want = fused_layer.reference_layer_bwd(x, dy, params, *cfg)
                torch.cuda.synchronize()
                errs = {}
                for gname, g, w in zip(names, (dx, *grads), (want_dx, *want)):
                    abs_err, err = grad_err(g, w)
                    errs[gname] = err
                    check(bool(torch.isfinite(g.float()).all()) and err <= TOL_OP[name],
                          f"fused_layer_bwd {label} [{b},{s},{d}] {name} dropout {rate} "
                          f"{gname}: max|d| {abs_err:.3e}, rel {err:.3e} <= {TOL_OP[name]:.0e}")
                dx2, grads2 = fused_layer._launch_bwd(x, dy, params, *cfg)
                check(torch.equal(dx, dx2) and all(torch.equal(a, c) for a, c in zip(grads, grads2)),
                      f"fused_layer_bwd {label} {name} dropout {rate}: two calls give "
                      f"bit-identical dx and parameter gradients")
                del dx, grads, want_dx, want, dx2, grads2
                ms = cuda_ms(lambda: fused_layer._launch_bwd(x, dy, params, *cfg), reps=5,
                             warmup=1)
                plain = cuda_ms(lambda: fused_layer.reference_layer_bwd(x, dy, params, *cfg),
                                reps=5, warmup=1)
                flops = 3 * fwd_flops
                nbytes = 3 * tokens * d * item + wbytes + 4 * count
                bms, by = bound_ms(nbytes, flops, name)
                bwd_cases.append(dict(shape=label, dims=[b, s, d], dtype=name, dropout=rate,
                                      max_abs_err=max(errs.values()), rel_err=errs, ms=ms,
                                      plain_ms=plain, bound_ms=bms, bound_by=by, flops=flops,
                                      bytes=nbytes))
                print(f"     fused_layer_bwd {label} {name} dropout {rate}: ms {ms:.4f} "
                      f"plain_ms {plain:.4f} bound_ms {bms:.4f} ({by}) -> "
                      f"{flops / ms / 1e9:.2f} TFLOP/s", flush=True)
                torch.cuda.empty_cache()
    return bwd_cases, fwd_cases


def phase_embed_bwd(gen):
    """fused_embed_bwd against fused_embed_mask_reference_bwd at [64, 20, 10, 64]."""
    import torch

    from maskedsst_tpu_torch.ops import fused_embed

    b, g, p, n, d = TRAIN_BATCH, 20, 10, 64, 96
    names = ("preln_scale", "preln_bias", "kernel", "bias", "postln_scale", "postln_bias",
             "pos", "mask_token")
    patches = torch.randn(b, g, p, n, generator=gen).cuda()
    mask = (torch.rand(b, g, n, generator=gen) < 0.7).float().cuda()

    def r(*shape, base=0.0, scale=0.1):
        return (base + scale * torch.randn(*shape, generator=gen)).cuda()

    args = (patches, mask, r(p, base=1.0), r(p), r(g, p, d, scale=p**-0.5), r(g, d),
            r(d, base=1.0), r(d), r(g, n, d, scale=1.0), r(d, scale=1.0))
    dtok32 = torch.randn(b, g, n, d, generator=gen).cuda()
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        dtok = dtok32.to(fused_embed._out_dtype(dtype))
        got = fused_embed._launch_bwd(*args, dtok, dtype)
        want = fused_embed.fused_embed_mask_reference_bwd(*args, dtok, dtype)
        torch.cuda.synchronize()
        errs = {}
        for gname, gv, wv in zip(names, got, want):
            abs_err, err = grad_err(gv, wv)
            errs[gname] = err
            check(bool(torch.isfinite(gv).all()) and err <= TOL_OP[name],
                  f"fused_embed_bwd [{b},{g},{p},{n}]->{d} {name} {gname}: max|d| {abs_err:.3e}, "
                  f"rel {err:.3e} <= {TOL_OP[name]:.0e}")
        again = fused_embed._launch_bwd(*args, dtok, dtype)
        check(all(torch.equal(a, c) for a, c in zip(got, again)),
              f"fused_embed_bwd {name}: two calls give bit-identical gradients")
        ms = cuda_ms(lambda: fused_embed._launch_bwd(*args, dtok, dtype))
        plain = cuda_ms(lambda: fused_embed.fused_embed_mask_reference_bwd(*args, dtok, dtype))
        tokens = b * g * n
        flops = tokens * 6 * p * d
        nbytes = (patches.numel() * 4 + mask.numel() * 4 + tokens * d * dtok.element_size()
                  + g * p * d * (2 if dtype == torch.bfloat16 else 4)
                  + 4 * (2 * p + g * d + 2 * d)
                  + 4 * (2 * p + g * p * d + g * d + 2 * d + g * n * d + d))
        bms, by = bound_ms(nbytes, flops, name)
        cases.append(dict(shape="embed", dims=[b, g, p, n, d], dtype=name,
                          max_abs_err=max(errs.values()), rel_err=errs, ms=ms, plain_ms=plain,
                          bound_ms=bms, bound_by=by, flops=flops, bytes=nbytes))
        print(f"     fused_embed_bwd {name}: ms {ms:.4f} plain_ms {plain:.4f} bound_ms "
              f"{bms:.4f} ({by}) -> {nbytes / ms / 1e6:.1f} GB/s", flush=True)
    return cases


@contextlib.contextmanager
def plain_versions():
    """Route the model's two fused ops to their plain versions (still on the
    card, forward and backward), for the main paths' reference runs."""
    from maskedsst_tpu_torch.models import layers
    from maskedsst_tpu_torch.ops import fused_embed, fused_layer

    saved = layers.fused_transformer_layer, layers.fused_embed_mask
    layers.fused_transformer_layer = fused_layer.plain_transformer_layer
    layers.fused_embed_mask = fused_embed.plain_embed_mask
    try:
        yield
    finally:
        layers.fused_transformer_layer, layers.fused_embed_mask = saved


def phase_main(card: str):
    """The serving path: Predictor over the EnMAP-DFC classifier."""
    import torch

    from maskedsst_tpu_torch.config import get_finetune_config
    from maskedsst_tpu_torch.ops import fused_embed, fused_layer
    from maskedsst_tpu_torch.serve import Predictor
    from maskedsst_tpu_torch.train.factory import build_finetune_model

    config = get_finetune_config("configs/finetune_config_enmap.yaml", "configs/config.yaml",
                                 seed=SEED)
    rng = np.random.default_rng(SEED)
    requests = {n: rng.standard_normal((n, config.n_bands, 8, 8)).astype(np.float32)
                for n in REQUESTS}
    batches = sum(math.ceil(n / BATCH) for n in REQUESTS)
    depth = config.transformer_depth
    launches = {}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[1]
        model, _ = build_finetune_model(config, dtype=dtype, device="cuda")
        pred = Predictor(model, batch_size=BATCH)

        fused_embed.launches = 0
        fused_layer.launches = 0
        outs = {n: pred(x) for n, x in requests.items()}
        torch.cuda.synchronize()
        counts = {"fused_embed_fwd": fused_embed.launches, "fused_layer_fwd": fused_layer.launches}
        launches[name] = counts

        want_counts = {"fused_embed_fwd": batches, "fused_layer_fwd": 2 * depth * batches}
        check(counts == want_counts, f"main path {name}: launches {counts} == {want_counts}")
        for n, out in outs.items():
            check(out.shape == (n, config.n_classes, 8, 8) and bool(np.isfinite(out).all()),
                  f"main path {name}: N={n} -> shape {out.shape}, finite")
        with plain_versions():
            refs = {n: pred(x) for n, x in requests.items() if n}
        for n, ref in refs.items():
            diff = np.abs(outs[n] - ref)
            err = float((diff / np.maximum(1.0, np.abs(ref))).max())
            check(err <= TOL_MODEL[name],
                  f"main path {name}: N={n} logits vs plain versions on the card: "
                  f"max|d| {float(diff.max()):.3e}, max|d|/max(1,|ref|) {err:.3e} "
                  f"<= {TOL_MODEL[name]:.0e}")

        x = rng.standard_normal((8 * BATCH, config.n_bands, 8, 8)).astype(np.float32)
        pred(x)  # warm-up
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            pred(x)
            walls.append(time.perf_counter() - t0)
        rate = x.shape[0] / statistics.median(walls)
        print(f"     serving {name}: {rate:.1f} cubes/s (N={x.shape[0]}, batch {BATCH}, "
              f"median of 3, host clock incl. transfers) on {card}", flush=True)
        del model, pred
        torch.cuda.empty_cache()
    return launches


def launch_counts() -> dict:
    from maskedsst_tpu_torch.ops import fused_embed, fused_layer

    return {"fused_layer_fwd": fused_layer.launches, "fused_layer_bwd": fused_layer.bwd_launches,
            "fused_embed_fwd": fused_embed.launches, "fused_embed_bwd": fused_embed.bwd_launches}


def reset_counts() -> None:
    from maskedsst_tpu_torch.ops import fused_embed, fused_layer

    fused_layer.launches = fused_layer.bwd_launches = 0
    fused_embed.launches = fused_embed.bwd_launches = 0


def step_grads(trainer, img, label, seed):
    """Loss and parameter gradients of one forward/backward of the trainer's
    model (no update), its dropout seeds drawn from a generator at seed."""
    import torch

    from maskedsst_tpu_torch.train.losses import cross_entropy

    img, label = trainer._to_device(img, label)
    img, label = trainer._prep(img, label, xy=(5, 9))
    model = trainer.model
    model.train()
    model.zero_grad(set_to_none=True)
    logits = model(img, rng=torch.Generator().manual_seed(seed))
    loss = cross_entropy(logits, label, ignore_index=trainer.config.ignored_label)
    loss.backward()
    grads = {n: q.grad.detach().clone() for n, q in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return float(loss.detach()), grads


def profile_step(trainer, tiles, steps: int = 3) -> dict:
    """Device time by kernel over a few training steps (torch.profiler with
    CUDA activity), against the host clock of the same steps; an empty
    result when the profiler records no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        trainer.train_step(tiles["img"], tiles["label"])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            trainer.train_step(tiles["img"], tiles["label"])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    rows = []
    for e in prof.key_averages():
        # device-side events only (kernels, copies): the host ops that
        # launched them carry the same time and would count it twice
        if "CUDA" not in str(getattr(e, "device_type", "")):
            continue
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0.0)
        if dev_us > 0:
            rows.append((e.key, dev_us / 1e3 / steps, e.count / steps))
    if not rows:
        return {}
    rows.sort(key=lambda r: -r[1])
    device_ms = sum(r[1] for r in rows)
    groups = {}
    for key, ms, _ in rows:
        group = next((g for g in ("fused_layer_bwd", "fused_layer_fwd", "fused_embed_bwd",
                                  "fused_embed_fwd", "reduce_partials", "Memcpy") if g in key),
                     "other")
        groups[group] = groups.get(group, 0.0) + ms
    return {"steps": steps, "wall_ms_per_step": wall_ms, "device_ms_per_step": device_ms,
            "busy_share": device_ms / wall_ms, "groups_ms_per_step": groups,
            "by_name": [{"name": k[:120], "ms_per_step": ms, "calls_per_step": n}
                        for k, ms, n in rows]}


def phase_train(card: str):
    """The training path: Finetuner on the EnMAP-DFC config, both routes."""
    import torch

    from maskedsst_tpu_torch.config import get_finetune_config
    from maskedsst_tpu_torch.data.pipeline import DataLoader
    from maskedsst_tpu_torch.data.synthetic import SyntheticCubeDataset
    from maskedsst_tpu_torch.train.factory import build_finetune_model
    from maskedsst_tpu_torch.train.finetuner import Finetuner

    base = get_finetune_config("configs/finetune_config_enmap.yaml", "configs/config.yaml",
                               seed=SEED)
    data = SyntheticCubeDataset(num_tiles=TRAIN_BATCH, n_bands=base.n_bands,
                                n_classes=base.n_classes, seed=SEED)
    tiles = next(iter(DataLoader(data, TRAIN_BATCH, shuffle=False)))
    depth = base.transformer_depth
    routes = {"recipe": 0.1, "emb_dropout_0": 0.0}
    per_step_want = {
        "recipe": {"fused_layer_fwd": 2 * depth, "fused_layer_bwd": 2 * depth,
                   "fused_embed_fwd": 0, "fused_embed_bwd": 0},
        "emb_dropout_0": {"fused_layer_fwd": 2 * depth, "fused_layer_bwd": 2 * depth,
                          "fused_embed_fwd": 1, "fused_embed_bwd": 1},
    }
    per_step_seen = {}

    def trainer_for(emb_rate, dtype, batch):
        cfg = base.copy()
        cfg.transformer_emb_dropout = emb_rate
        cfg.batch_size = batch
        model, kw = build_finetune_model(cfg, dtype=dtype, device="cuda")
        return Finetuner(cfg, model, **kw)

    # --- the main path, counted: both routes in bf16 ------------------------
    reset_counts()
    for route, emb_rate in routes.items():
        losses, seen = [], []
        for batch, steps in ((2, 3), (TRAIN_BATCH, 20)):
            trainer = trainer_for(emb_rate, torch.bfloat16, batch)
            for k in range(steps):
                before = launch_counts()
                lo = (k * batch) % TRAIN_BATCH
                m = trainer.train_step(tiles["img"][lo : lo + batch],
                                       tiles["label"][lo : lo + batch])
                torch.cuda.synchronize()
                after = launch_counts()
                per_step = {n: after[n] - before[n] for n in after}
                losses.append(float(m["loss"]))
                if per_step not in seen:
                    seen.append(per_step)
            del trainer
        check(seen == [per_step_want[route]],
              f"train {route} bf16: launches at every one of {len(losses)} steps "
              f"{seen} == {per_step_want[route]}")
        check(all(math.isfinite(v) for v in losses),
              f"train {route} bf16: {len(losses)} losses finite (last {losses[-1]:.4f})")
        per_step_seen[route] = seen[0]
    main_counts = launch_counts()
    for name, n in main_counts.items():
        check(n > 0, f"training path: {name} launched {n} times")
    torch.cuda.empty_cache()

    # --- one step's gradients against the plain versions (same seeds) -------
    def rel_to_max(got, want):
        scale = float(want.abs().max())
        diff = float((got - want).abs().max())
        return diff / scale if scale > 0 else diff  # an all-zero gradient must stay zero

    for route, emb_rate in routes.items():
        for dtype in (torch.bfloat16, torch.float32):
            name = str(dtype).split(".")[1]
            trainer = trainer_for(emb_rate, dtype, TRAIN_BATCH)
            loss_k, g_k = step_grads(trainer, tiles["img"], tiles["label"], seed=77)
            with plain_versions():
                loss_p, g_p = step_grads(trainer, tiles["img"], tiles["label"], seed=77)
                # a fault to hold the limit against: the step with other dropout masks
                _, g_f = step_grads(trainer, tiles["img"], tiles["label"], seed=78)
            errs = {n: rel_to_max(g_k[n], ref) for n, ref in g_p.items()}
            faults = sorted(rel_to_max(g_f[n], ref) for n, ref in g_p.items())
            caught = sum(v > TOL_STEP[name] for v in faults)
            worst = max(errs, key=errs.get)
            check(abs(loss_k - loss_p) <= TOL_MODEL[name] * max(1.0, abs(loss_p)),
                  f"train {route} {name} step: loss {loss_k:.6f} vs plain {loss_p:.6f}")
            check(errs[worst] <= TOL_STEP[name],
                  f"train {route} {name} step: each of {len(errs)} gradients vs plain versions "
                  f"on the card, worst {worst} max|d|/max|ref| {errs[worst]:.3e} <= "
                  f"{TOL_STEP[name]:.1e} (other dropout masks read {faults[-1]:.3e} at worst, "
                  f"{faults[len(faults) // 2]:.3e} median, {caught} leaves above the limit; "
                  f"a zeroed leaf reads 1)")
            del trainer, g_k, g_p, g_f
            torch.cuda.empty_cache()

    # --- the loss falls over 30 steps (recipe, bf16, batch 64) ---------------
    trainer = trainer_for(0.1, torch.bfloat16, TRAIN_BATCH)
    losses = [float(trainer.train_step(tiles["img"], tiles["label"])["loss"]) for _ in range(30)]
    first, last = sum(losses[:5]) / 5, sum(losses[-5:]) / 5
    check(last < first, f"train recipe bf16: mean loss of steps 1-5 {first:.4f} > steps 26-30 "
                        f"{last:.4f}")
    del trainer

    # --- steps/s and cubes/s at batch 64 ------------------------------------
    for name, dtype, emb_rate in (("bfloat16", torch.bfloat16, 0.1),
                                  ("float32", torch.float32, 0.1),
                                  ("bfloat16_emb_dropout_0", torch.bfloat16, 0.0)):
        trainer = trainer_for(emb_rate, dtype, TRAIN_BATCH)
        for _ in range(2):  # warm-up
            trainer.train_step(tiles["img"], tiles["label"])
        torch.cuda.synchronize()
        walls = []
        for _ in range(7):
            t0 = time.perf_counter()
            trainer.train_step(tiles["img"], tiles["label"])
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        step_s = statistics.median(walls)
        prof = profile_step(trainer, tiles)
        if prof:
            print(f"     profile {name}: {prof['device_ms_per_step']:.2f} ms of device time in a "
                  f"{prof['wall_ms_per_step']:.2f} ms step (busy {prof['busy_share']:.1%}); "
                  "by kernel: " + ", ".join(f"{g} {ms:.2f} ms"
                                            for g, ms in prof["groups_ms_per_step"].items()),
                  flush=True)
        else:
            print(f"     profile {name}: the profiler recorded no device time (not measured)",
                  flush=True)
        print(f"     training {name}: {1 / step_s:.3f} steps/s, {TRAIN_BATCH / step_s:.1f} cubes/s "
              f"(batch {TRAIN_BATCH}, median of 7 steps, host clock incl. the copy of the "
              f"crops to the card) on {card}", flush=True)
        del trainer
        torch.cuda.empty_cache()
    return main_counts, per_step_seen


def kernel_entry(name, source, replaces, cases, launches, **extra):
    """One kernel's JSON entry: times of one launch averaged over the main
    paths' bf16 shapes (the serving and training dtype; the layer backward
    at the recipe's dropout 0.1), every case kept under "cases"."""
    main = [c for c in cases if c["dtype"] == "bfloat16"
            and c["shape"] in ("spatial", "spectral", "embed") and c.get("dropout", 0.1) == 0.1]

    def mean(key):
        return sum(c[key] for c in main) / len(main)

    return dict(
        name=name, route="cuda", source=source, replaces=replaces, launches=launches,
        max_abs_err=max(c["max_abs_err"] for c in main), ms=mean("ms"),
        plain_ms=mean("plain_ms"), bound_ms=mean("bound_ms"),
        bound_by=main[0]["bound_by"], library_ms=None, library_note=LIBRARY_NONE[name],
        **extra, cases=cases,
    )


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke test runs "
              "only on a CUDA card", file=sys.stderr)
        return 1
    root = os.path.dirname(os.path.abspath(__file__))
    os.chdir(root)
    sys.path.insert(0, root)
    # fails here when the repo (the maskedsst_tpu_torch package) is not beside this file
    from maskedsst_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"device: {kind} ({card}), torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)

    t0 = time.perf_counter()
    _build.build()
    print(f"phase 0 build: {', '.join(_build.KERNELS)} in {time.perf_counter() - t0:.1f} s",
          flush=True)

    gen = torch.Generator().manual_seed(SEED)
    print("phase 1 forward kernels vs plain versions", flush=True)
    layer_cases = phase_layer(gen)
    embed_cases = phase_embed(gen)
    print("phase 1b backward kernels vs plain versions (training shapes, batch 64)", flush=True)
    layer_bwd_cases, layer_drop_cases = phase_layer_bwd(gen)
    embed_bwd_cases = phase_embed_bwd(gen)

    print("phase 2 serving path: Predictor over the EnMAP-DFC classifier", flush=True)
    serving = phase_main(card)

    print("phase 3 training path: Finetuner over the EnMAP-DFC classifier", flush=True)
    t3 = time.perf_counter()
    counts, per_step = phase_train(card)
    print(f"phase 3 took {time.perf_counter() - t3:.1f} s", flush=True)

    batches = sum(math.ceil(n / BATCH) for n in REQUESTS)

    def steps_of(name):
        return {route: c[name] for route, c in per_step.items()}

    kernels = [
        kernel_entry("fused_layer_fwd", "maskedsst_tpu_torch/csrc/fused_layer_fwd.cu",
                     "maskedsst_tpu/ops/fused_layer.py:443", layer_cases + layer_drop_cases,
                     counts["fused_layer_fwd"], launches_per_step=steps_of("fused_layer_fwd"),
                     launches_serving=serving["bfloat16"]["fused_layer_fwd"],
                     launches_per_serving_batch=serving["bfloat16"]["fused_layer_fwd"] // batches),
        kernel_entry("fused_layer_bwd", "maskedsst_tpu_torch/csrc/fused_layer_bwd.cu",
                     "maskedsst_tpu/ops/fused_layer.py:476", layer_bwd_cases,
                     counts["fused_layer_bwd"], launches_per_step=steps_of("fused_layer_bwd")),
        kernel_entry("fused_embed_fwd", "maskedsst_tpu_torch/csrc/fused_embed_fwd.cu",
                     "maskedsst_tpu/ops/fused_embed.py:89", embed_cases,
                     counts["fused_embed_fwd"], launches_per_step=steps_of("fused_embed_fwd"),
                     launches_serving=serving["bfloat16"]["fused_embed_fwd"],
                     launches_per_serving_batch=serving["bfloat16"]["fused_embed_fwd"] // batches),
        kernel_entry("fused_embed_bwd", "maskedsst_tpu_torch/csrc/fused_embed_bwd.cu",
                     "maskedsst_tpu/ops/fused_embed.py:102", embed_bwd_cases,
                     counts["fused_embed_bwd"], launches_per_step=steps_of("fused_embed_bwd")),
    ]
    if failures:
        print(f"chip_smoke: {len(failures)} check(s) failed:", file=sys.stderr)
        for msg in failures:
            print("  " + msg, file=sys.stderr)
        return 1
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
