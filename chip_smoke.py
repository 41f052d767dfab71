#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (maskedsst_tpu_torch) on one NVIDIA GPU.

Run from the repo root on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py

Phases:
  0. build: compiles every CUDA kernel of the serving path from csrc/ with
     nvcc for sm_90a into build/kernels/ (one nvcc per source, in parallel);
  1. kernels vs plain: each kernel against its plain PyTorch version on the
     card, at the serving shapes (batch 256) in fp32 (TF32 off) and bf16,
     plus the Houston spectral shape (seq 5) for the layer; max |error|,
     CUDA-event medians of kernel and plain version, and the bound;
  2. main path: the EnMAP-DFC classifier (configs/finetune_config_enmap.yaml
     + configs/config.yaml, seeded weights) in bf16 and fp32 behind
     Predictor(batch_size=256) answers requests of N = 300, 256, 1, 0 cubes;
     checks shapes, finiteness, agreement with the same model run through
     the plain versions on the card, and the kernels' launch counts; then
     measures cubes/s.

Prints the card's name and power limit, a JSON line of the kernels, and as
its last line {"ok": true, "device": {...}}. Exits non-zero, printing no
result, when a phase fails or when there is no CUDA device.
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
REQUESTS = (300, 256, 1, 0)
SEED = 0
# Tolerances on max |kernel - plain| / max(1, |plain|), elementwise. fp32: the
# two differ only in summation order and fast-math intrinsics (~1e-6 per
# layer). bf16: both round every matmul operand to bf16 at the same points, but
# a one-ulp difference before a rounding flips that bf16 value (2^-8 relative)
# and the output itself is bf16.
TOL_OP = {"float32": 1e-4, "bfloat16": 3e-2}
TOL_MODEL = {"float32": 1e-3, "bfloat16": 1e-1}
LIBRARY_NONE = {
    "fused_layer_fwd": "no single PyTorch call computes the layer: its inner width "
    "(8 x 64 = 512) differs from dim 96, so nn.TransformerEncoderLayer does not fit",
    "fused_embed_fwd": "no single PyTorch call computes the per-block pre-LN, "
    "product, post-LN, + pos and mask select",
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


@contextlib.contextmanager
def plain_versions():
    """Route the model's two fused ops to their plain versions (still on the
    card), for the main path's reference run."""
    from maskedsst_tpu_torch.models import layers
    from maskedsst_tpu_torch.ops import fused_embed, fused_layer

    saved = layers.fused_transformer_layer, layers.fused_embed_mask
    layers.fused_transformer_layer = (
        lambda x, p, heads, dim_head, compute_dtype, *_: fused_layer.reference_layer(
            x, p, heads, dim_head, compute_dtype))
    layers.fused_embed_mask = fused_embed.fused_embed_mask_reference
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
    results = {}
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
        results[name] = rate
        print(f"     serving {name}: {rate:.1f} cubes/s (N={x.shape[0]}, batch {BATCH}, "
              f"median of 3, host clock incl. transfers) on {card}", flush=True)
        del model, pred
        torch.cuda.empty_cache()
    return launches, results


def kernel_entry(name, source, replaces, cases, launches):
    """One kernel's JSON entry: times of one launch averaged over the main
    path's bf16 shapes (the serving dtype), every case kept under "cases"."""
    main = [c for c in cases if c["dtype"] == "bfloat16" and c["shape"] != "houston_spectral"]

    def mean(key):
        return sum(c[key] for c in main) / len(main)

    return dict(
        name=name, route="cuda", source=source, replaces=replaces, launches=launches,
        max_abs_err=max(c["max_abs_err"] for c in main), ms=mean("ms"),
        plain_ms=mean("plain_ms"), bound_ms=mean("bound_ms"),
        bound_by=main[0]["bound_by"], library_ms=None, library_note=LIBRARY_NONE[name],
        cases=cases,
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
    print("phase 1 kernels vs plain versions", flush=True)
    layer_cases = phase_layer(gen)
    embed_cases = phase_embed(gen)

    print("phase 2 main path: Predictor over the EnMAP-DFC classifier", flush=True)
    launches, _ = phase_main(card)

    kernels = [
        kernel_entry("fused_layer_fwd", "maskedsst_tpu_torch/csrc/fused_layer_fwd.cu",
                     "maskedsst_tpu/ops/fused_layer.py:443", layer_cases,
                     launches["bfloat16"]["fused_layer_fwd"]),
        kernel_entry("fused_embed_fwd", "maskedsst_tpu_torch/csrc/fused_embed_fwd.cu",
                     "maskedsst_tpu/ops/fused_embed.py:89", embed_cases,
                     launches["bfloat16"]["fused_embed_fwd"]),
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
