#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (maskedsst_tpu_torch) on one NVIDIA GPU.

Run from the repo root on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py

Phases:
  0. build: compiles every CUDA kernel (layer, embed and SimMIM decode,
     forward and backward, the layer's weight gradients, the dropout
     sample) from csrc/ with
     nvcc for sm_90a into build/kernels/ (one nvcc per source, in
     parallel);
  1. forward kernels vs plain: each forward kernel against its plain
     PyTorch version on the card, at the serving shapes (batch 256) in fp32
     (TF32 off) and bf16, plus the Houston spectral shape (seq 5) for the
     layer; max |error|, CUDA-event medians of kernel and plain version
     (the embed forward's device time beside its kernel's), and the bound;
  1b. backward kernels vs plain, at the training shapes of batch 64 (layer
     spatial [1280, 64, 96], spectral [4096, 20, 96], Houston [4096, 5, 96]
     in fp32 and bf16, Houston spatial [320, 64, 96] in bf16, at dropout 0
     and 0.1; embed [64, 20, 10, 64] and Houston's [64, 5, 10, 64] -> 96,
     every gradient, fp32 and bf16): the error per gradient, the dropout
     masks that the forward and backward kernels apply, read out of their
     outputs by the probes of ops/dropout_probe.py and held bit for bit
     against dropout_mask, two calls giving the same gradient bits, timings
     and bounds; in bf16 (the tensor-core form) also the row kernel's dx,
     operands and small vectors against its plain version and layer_wgrad
     against its plain version, each repeated bit for bit, and the device
     time of the whole backward, the row kernel and layer_wgrad beside
     their bounds; plus the forward at dropout 0 and 0.1 against its plain
     version, in bf16 as the training call (the tensor-core form, which
     also writes x1 for the backward) with that x1 against the plain x1 and
     the call's device time at dropout 0.1 beside its bound and the share
     of the bound;
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
     then measures steps/s and cubes/s at batch 64 in bf16 and fp32;
  1c. SimMIM decode + weighted-L1 kernels (forward and backward) vs plain,
     at the recipe shape (batch 64, 20 blocks, 64 tokens, dim 96, 10
     pixels), Houston's 5 blocks, a batch of 61 and dim 16, fp32 and bf16,
     with a tube mask's loss weights and an all-zero weight row: the loss
     relative to |plain|, each gradient relative to its own max|plain|,
     two calls giving the same bits, device times (torch.profiler: the
     kernels take microseconds) and bounds;
  4. pretraining path: Pretrainer on configs/pretrain_config.yaml +
     configs/config.yaml with SyntheticCubeDataset tiles (640, unlabeled)
     in DeviceTileStores on the card, steps through the store path; checks
     the exact launches of all six kernels at every step (a few at batch
     2, 20 at batch 64, bf16), one validation pass and its launches per
     chunk, one step's loss and gradients against the same step through
     the plain versions on the card (same crop, mask and dropout seeds),
     and that the loss falls over 60 steps; then measures steps/s,
     cubes/s and the peak of allocated device memory at batch 64 in bf16
     and fp32 with a torch.profiler breakdown;
  5. tools (maskedsst_tpu_torch.tools): kernel_check run in full at the
     Houston2018 shapes, its checks counted here: layer parity against its
     own oracle, the SimMIM kernels, and the dropout-sample kernel
     (csrc/dropout_sample.cu, the drop_mult of the layer kernels drawn
     alone) held to the dropout invariants and bit for bit to dropout_mask
     at [512, 128] and [1280, 8, 64, 64], also from index 2^32 + 12345; its
     launches on this path, none on the model paths; the kernels' device
     times at the Houston shapes (phases 1b and 1c time the EnMAP ones) and
     kernel #7's against its plain version; Houston2018 pretraining at full
     width (50 bands, 5 blocks; batch 64, bf16) from bench_geometries: exact
     launches of all six kernels at each of 20 steps, steps/s over three
     windows of 10 steps with a profile, then one step's loss and gradients
     against the plain versions on fresh weights and on the trained ones:
     fp32 every gradient within TOL_STEP; bf16 on fresh weights every
     gradient within TOL_STEP of the plain bf16 step or, above it, no
     further from the fp32 plain step than 1.5x the plain bf16 step (d
     pos_embedding, the sum of 64 tokens' gradients, takes whole the flips
     of the L1's sign that one bf16 rounding makes; printed with the same
     distance under a smooth L1); bf16 on trained weights, where either
     bf16 route sits percents from fp32 in many leaves, every gradient
     nearer the plain bf16 step than other dropout masks are, both routes'
     distances from fp32 printed;
     serving_bench at batch 256 and a 1-cube request; bf16_soak at 32 steps
     per leg (both finite, step-1 losses within 1e-2);
  6. checkpoint path (train/checkpoint.py, io/torch_import.py): (a) phase
     4's 640 tiles and recipe (bf16, batch 64, the store path, 9 steps an
     epoch): a control run of 2 epochs + 3 steps, and a run stopped by a
     max_steps break mid-epoch 1, whose model_*_at_step12.pt a new
     Pretrainer resumes to the control's budget: every parameter, AdamW
     moment and step, state.step, the generator and the scheduler equal
     bit for bit, each resumed step launching phase 4's counts, every
     kernel #1-#6 launched; the checkpoint's size, save and restore
     seconds; (b) load_pretrained_params of that file into the EnMAP-DFC
     classifier (bf16, embedding dropout 0): every carried encoder tensor
     equal to the checkpoint's, the rest equal to a seeded model's; 10
     finetune steps at batch 64 with phase 3's launches each, finite and
     falling losses, steps/s; a mid-epoch finetune resume equal bit for
     bit to its control; (c) the finetuned model through .pt, the export
     tool's .pth and the importer: Predictor(batch_size=256) logits equal
     bit for bit;
  7. real data path (native/, etl/pack_tiles.py, data/resolve.py, the
     Finetuner's device store): (a) the packer writes 512 seeded labeled
     EnMAP-DFC tiles [200, 64, 64] (labels -1..7, 1.68 GB) and 256
     unlabeled ones to .msts files; the native reader's gather, crops and
     labels, raw and standardized, equal the numpy reader bit for bit, and
     its tiles/s and MB/s beside the host's CPUs and load; (b) get_dataset -> split_dataset ->
     Finetuner.fit from the labeled store at batch 64 (embedding dropout
     0, 2 epochs) and at the recipe's batch 2 (1 epoch), each on the
     device store and streamed from the host from the same weights and
     seed: phase 3's launches at every store step, per-step losses and the
     final state equal bit for bit, validation on the card against host
     windows (accuracies exact, loss within 1e-5), steps/s of both paths
     from whole-epoch timing; a store-path resume mid-epoch bit for bit
     against its control; (c) pretraining from the unlabeled store through
     get_dataset, phase 4's launches at each of 10 steps, finite losses,
     the supervised path refusing that store; (d) Houston2018 on an
     injected scene [50, 1202, 4768]: the 22,350 fixed train patches on
     the device store, the recipe's random patches streamed (no store),
     10 steps each at batch 32 with the layer kernels' launches; (e) the
     finetune and pretrain drivers in process on a config whose train
     paths are the stores, 20 steps each, each writing its _at_step20
     checkpoint;
  8. drivers (data/pipeline.py's prefetch thread, utils/tracking.py, the
     finetune_sweep and inference_example entry points): (a) phase 7's
     labeled .msts finetuned at batch 64 (2 epochs) and 2 (1 epoch) on the
     device store, streamed with prefetch 2 and with prefetch 0, and at
     batch 64 also read sample by sample (prefetch 2 and 0): per-step
     losses, parameters, Adam moments and the generator equal bit for bit,
     phase 3's launches a step, the threads back to their count after
     fit, steps/s of each path; (b) Houston2018's random patches streamed
     with prefetch 2, 0, 0, 2 from the same seeds, 100 steps each: bit for
     bit, no producer thread left 1 s after each max_steps break
     mid-epoch, steps/s of each run; (c)
     the pretraining driver with --log-grad-norm and --jsonl (bf16 20
     steps, fp32 10): the boundary rows' keys, grad_norm finite and > 0
     and each the mean of its window, every step's norm within 1e-6 of the
     fp64 norm of that step's gradients before the clamp, phase 4's
     launches a step; (d) finetune_sweep from (c)'s checkpoint with --set
     overrides: the learned positions and the block kernel carried bit for
     bit, a fresh head, phase 3's launches a step; (e) inference_example
     --tiles 8 from (d)'s checkpoint in fp32: #1 and #3 launched once per
     window batch of a tile, the logits within 1e-3 of the same model's
     plain versions on the CPU, the argmax equal wherever the top-2 margin
     exceeds 1e-3;
  9. data-parallel training (parallel/mesh.py, through the cases of
     tools/dist_worker.py; each held against its one-process run in this
     process): (a) two ranks sharing the card over Gloo pretrain the EnMAP
     recipe at dropout 0 from a store of 64 seeded tiles, global batch 64
     (32 rows a rank), 3 steps in bf16 and in fp32: the ranks' parameters,
     gradients and train states equal bit for bit after every step, every
     rank launching phase 4's counts at every step, the loss of every step
     and the gradients and parameters of the first (every step in fp32)
     within the limits of ``dp_hold_steps``, steps/s of a rank beside one
     process's; (b) the recipe's dropout 0.1: rank 0's layer seeds the one
     process's, rank 1's folded by + 668265261 (int32 wrap), and a finetune
     step at embedding dropout 0.1 whose rank-0 keep mask is the first half
     of the one-process draw; (c) EnMAP-DFC finetuning from the store in
     bf16 on index batches of 63 (padded), 64 and 61 rows, loss, metrics
     and gradients against one process, validation at batches of 31; (d)
     checkpoints: rank 0 writes them and the tracker's JSONL, rank 1 writes
     nothing, a two-rank resume equals its control bit for bit, a
     one-process checkpoint resumes in two ranks and the two-rank one in
     one process; (e) NCCL at world size min(device_count, 2): on one card
     its step bit-equal to the step without a process group, steps/s of
     both; (f) the pretraining driver under ``torch.distributed.run
     --nproc_per_node 2`` (Gloo), 3 synthetic steps, both ranks' lines and
     rank 0's two checkpoints;
 10. the other models and SimMIM options (models/vit_rgb.py,
     vit_spatial_spectral_v1.py, layers.py::PatchEmbed, simmim.py) at the
     repo's full widths: (a) the layer kernels at S = 65, ViTRGB's
     cls-token sequence past the 64 rows of the other paths: each form's
     shared-memory plan (ops/fused_layer.py::launch_plan) within the
     card's limit, the forward at batch 256 and the backward at [64, 65,
     96] as phases 1 and 1b hold them (fp32 and bf16, dropout 0 and 0.1,
     the masks, the row kernel and layer_wgrad, repeats, device times and
     bounds); (b) ViTRGB on the EnMAP-DFC config (method_name ViTRGB)
     behind Predictor(batch_size=256) in bf16 and fp32: 4 layer forwards a
     batch and no other kernel, logits against the plain versions,
     cubes/s; (c) its Finetuner at batch 64 (dropout and embedding dropout
     0.1): every step's launches (bf16 4/4/4, fp32 4/4/0 of forward, row or
     FMA backward, layer_wgrad), one step's gradients against the plain
     step, the loss falling over 30 steps, steps/s in bf16 and fp32; (d)
     the EnMAP pretraining recipe with blockwise_patch_embed and
     to_pixels_per_spectral_block off, from the store and streamed: 8/8/8
     layer launches a step and none of #3-#6, one step's loss and
     gradients against the plain step, the loss falling over 60 steps,
     steps/s; (e) SimMIM over ViTSpatialSpectralV1 at the same widths with
     intermediate_losses: its loss exactly 3x the loss without, one step
     against the plain step; (f) the legacy SimMIM over ViTRGB (S = 64, no
     cls token): its five outputs' shapes, one step against the plain
     step;
 11. the DeepHyperX zoo and the HyperX benchmark (models/zoo.py, hyperx/,
     no CUDA kernel of the port's: convolutions, pools, GRU and LRN are
     torch / cuDNN calls): (a) tools/zoo_check.py over the 12 nets at their
     factory geometry and batch (20 classes, 50 bands, chen 100 at 27x27,
     sharma 64x64): 4 steps, finite and moving losses, finite eval logits,
     ms a step and device-busy ms; a held step of each (dropout off,
     BatchNorm training) on the card against the CPU's from the same
     weights on a batch of 8, fp32 with TF32 off: loss 1e-4 of |ref|, each
     gradient 1e-4 of its max|ref|, or, where a cancelling sum leaves it
     near zero, no further from a float64 CPU step than NEARER_FP32 x the
     CPU fp32 step or within 1e-4 of the net's largest gradient; (b) li on the
     EnMAP-DFC config (200 bands, 7x7 windows of 8x8 crops of 64x64 tiles,
     8 classes, 16 planes): Finetuner.fit from the device store at batch
     64 with the SGD recipe and class weights (steps/s, a store step's
     idle share), Predictor at batch 256 (cubes/s), a .pt resume bit for
     bit against its control, a .pth export and import serving the same
     logits bit for bit, and the finetune driver with a li config; (c)
     hyperx.main on a synthetic scene (li 20 epochs, liu and mou 3) with
     --out-dir none and a JSON record, OA above chance, and the inference
     CLI on li's checkpoint (its functions alone where PIL does not import;
     the sklearn baseline only where sklearn does); every kernel count 0
     over the phase ("launches_zoo");
 12. the JAX package's .msgpack checkpoints (io/flax_msgpack.py,
     io/flax_checkpoint.py) and serving over several devices: (a) two bf16
     pretraining steps at batch 64 on the EnMAP recipe written by
     write_flax_checkpoint as the JAX pretrainer writes them (optax clip +
     AdamW, flat moments), the file read back leaf for leaf equal to the
     writing state, a new Pretrainer resumed from it (parameters, moments
     and steps bit for bit) for 3 steps launching phase 4's counts; (b)
     load_pretrained_params of that file into the EnMAP-DFC classifier equal
     to the .pt route's, 3 finetune steps launching phase 3's counts, the
     finetune state written as .msgpack (Adam, head / rest groups) and
     resumed with its moments bit for bit ("launches_flax_checkpoint": (a)
     and (b)); (c) Predictor(batch_size=256, devices=["cuda:0", "cuda:0"])
     over 300 cubes equal bit for bit to one device at 128, and over the
     default devices (every card) equal to one device at its slice,
     the launches of #1 and #3 ("launches_multi_device"), cubes/s of both
     beside phase 2's; (d) liu and sharma with seeded BatchNorm statistics
     through HyperXTrainer.save / restore as .msgpack (params and
     batch_stats): eval logits equal bit for bit;
 13. tensor parallelism over attention heads (parallel/mesh.py's grid,
     parallel/sharding_rules.py, ops/tp_layer.py, the tensor_parallel case
     of tools/dist_worker.py), each run held against its one-process run
     in this process: (a) tp = 2, dp = 1, two Gloo ranks sharing cuda:0 on
     the EnMAP pretraining recipe at full width (batch 64), 3 steps in
     bf16 at dropout 0.1 and in fp32 (TF32 off) at dropout 0: the whole
     (replicated) leaves bit-equal on both ranks, each rank's launches at
     every step (#1, #2, layer_wgrad 0; #3-#6 1; #7 32 at dropout 0.1,
     four sites a layer), the loss and gradients of every fp32 step and the
     first bf16 step within dp_hold_steps' limits of the one-process step
     on the fused kernels (a bf16 leaf above TOL_STEP held by its distance
     from the one-process fp32 step, phase 5's rule), the parameters too in
     fp32 (printed in bf16), each rank's shards bit-equal to their slices
     of every rank's gathered tensors, steps/s beside one process's and
     phase 4's;
     (b) a 2 x 2 grid of four Gloo ranks on cuda:0, 2 bf16 steps at
     dropout 0 held as (a); (c) tp = 2 over NCCL where there are two cards
     (else one line says why not); (d) kernel #7's strided form at the
     attention site's local heads [1280, 4, 64, 64] and the GELU site's
     columns [81920, 32]: bit for bit against its plain version and the
     slice of dropout_mask, device ms beside its bound; (e) the gathered
     state of (a) through .pt and .msgpack into one-process models: the
     parameters bit for bit, the two eval losses equal; (f) a Pretrainer
     and a Finetuner on a grid of model size 2 raise; (g) a li finetune
     state (SGD momentum, head / rest groups) written as .msgpack after 2
     steps and resumed on the card for 2 more: parameters, momentum
     buffers, step and the float32 rates equal the 4-step control bit for
     bit;
  14. the trainers' superstep (train/superstep.py: steps_per_call store
     steps as one CUDA graph, replayed once a chunk), each graphed run
     held to the same run in single steps from one seed, bit for bit
     (every parameter, AdamW moment and step, state.step, the generator,
     every step's metrics), with each step's launches (a replay counted by
     its capture) equal to eager's: (a) the EnMAP SimMIM pretraining
     recipe in bf16 at batch 64, dropout 0.1, 1,024 train tiles of 64 x 64
     in the store, 48 steps at k 16 (the first chunk eager, then a capture
     and replays); (b) EnMAP-DFC finetuning in bf16 at batch 64,
     embedding dropout 0.1, k 8, 3 epochs of 16 steps with the plateau
     scheduler cutting the rates at every epoch end, so that each epoch
     captures anew; (c) fp32 pretraining (the FMA forms) at k 4, two
     chunks; (d) a k-16 run saved at step 24 as .pt and .msgpack and
     resumed to 48 (the .pt against (a)'s run, the .msgpack against the
     .pt's resume under the .msgpack's generator and float32 rates); (e)
     eager single steps against graphed chunks in turns (eager, graph,
     graph, eager) on EnMAP pretraining, Houston2018 pretraining and
     EnMAP-DFC finetuning, windows of 16 steps: steps/s, device busy,
     span and idle share (torch.profiler), the capture's time, its pool's
     memory, the peak allocated memory of each route.

Prints every check and measurement as it goes, the card's name and power
limit, a JSON line of the kernels, and as its last line {"ok": true,
"device": {...}}; redirect standard output to keep the record. Exits
non-zero, printing no result, when a phase fails or when there is no CUDA
device.
"""

from __future__ import annotations

import contextlib
import functools
import json
import math
import os
import shutil
import statistics
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
# the timing policy and the kernels' costs live in the package; these
# imports fail when the repo (the maskedsst_tpu_torch package) is not
# beside this file
from maskedsst_tpu_torch.ops import launch_counts  # noqa: E402
from maskedsst_tpu_torch.ops import reset_launch_counts as reset_counts  # noqa: E402
from maskedsst_tpu_torch.tools.kernel_check import (  # noqa: E402
    SPLIT_NAMES,
    decode_cost,
    embed_cost,
    layer_cost,
)
from maskedsst_tpu_torch.utils.profiling import (  # noqa: E402
    bound_ms,
    card_line,
    cuda_ms,
    device_ms,
    profile_step,
)
from tests.quiet_tracker import QuietTracker  # noqa: E402

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
    "layer_wgrad": "no single PyTorch call computes the four weight-gradient products (four "
    "shapes, two stored transposed); plain_ms is their chunked matmul composition",
    "fused_embed_fwd": "no single PyTorch call computes the per-block pre-LN, "
    "product, post-LN, + pos and mask select",
    "fused_embed_bwd": "no single PyTorch call computes the per-block embed backward "
    "with its two LNs and the mask select",
    "fused_simmim_fwd": "no single PyTorch call computes a per-block decode fused with a "
    "weighted L1 sum; plain_ms is the einsum + abs + weighted-sum composition",
    "fused_simmim_bwd": "no single PyTorch call computes the per-block decode's backward "
    "with the sign of the weighted L1; plain_ms is the einsum composition",
    "dropout_sample": "no PyTorch call computes this hash: torch.rand and torch.bernoulli "
    "draw other bits (Philox), so none gives the same function; plain_ms is the int64 hash",
}
# The SimMIM loss is one sum over 819,200 terms: held relative to |plain|;
# fp32 differs in summation order only, bf16 in one-ulp flips of a few
# products' operands.
TOL_LOSS = {"float32": 1e-5, "bfloat16": 1e-3}
# Accuracies of the same rows computed in batches of other sizes: in bf16 a
# one-ulp flip of a logit can flip a near-tied pixel's argmax (CPU rehearsal
# of phase 9: 4 pixels of 262,144 validation pixels), one pixel of a
# 4,096-pixel training batch reads 2.4e-4.
TOL_METRIC = {"float32": 2e-5, "bfloat16": 1e-3}

failures: list = []


def check(cond: bool, msg: str) -> None:
    print(("ok   " if cond else "FAIL ") + msg, flush=True)
    if not cond:
        failures.append(msg)


def rel_err(got, want) -> tuple:
    """(max |got - want|, max |got - want| / max(1, |want|))."""
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    return float(diff.max()), float((diff / want.abs().clamp_min(1.0)).max())


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


SERVING_SHAPES = (("spatial", BATCH * 20, 64), ("spectral", BATCH * 64, 20),
                  ("houston_spectral", BATCH * 64, 5))


def phase_layer(gen, shapes=SERVING_SHAPES):
    """fused_layer_fwd against reference_layer at the serving shapes
    (label, sequences, S)."""
    import torch

    from maskedsst_tpu_torch.ops import fused_layer

    d, heads, dh, f = 96, 8, 64, 64
    i = heads * dh
    params = random_layer_params(gen, d, heads, dh, f, "cuda")
    cases = []
    for label, b, s in shapes:
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
            nbytes, flops = layer_cost(b, s, x.element_size(), d, i, f)["fwd"]
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
        dms = device_ms(lambda: fused_embed.fused_embed_mask(*args, dtype),
                        names=("fused_embed_fwd",))
        plain = cuda_ms(lambda: fused_embed.fused_embed_mask_reference(*args, dtype))
        nbytes, flops = embed_cost(b, g, p, n, d, got.element_size())["fwd"]
        bms, by = bound_ms(nbytes, flops, name)
        cases.append(dict(shape="embed", dims=[b, g, p, n, d], dtype=name, max_abs_err=abs_err,
                          rel_err=err, ms=ms, device_ms=dms, plain_ms=plain, bound_ms=bms,
                          bound_by=by, flops=flops, bytes=nbytes))
        print(f"     ms {ms:.4f} (CUDA events; device time {dms:.4f}) plain_ms {plain:.4f} "
              f"bound_ms {bms:.4f} ({by}) -> {nbytes / ms / 1e6:.1f} GB/s", flush=True)
    return cases


def grad_err(got, want) -> tuple:
    """(max |got - want|, that over max(1, max |want|)): per tensor."""
    diff = float((got.float() - want.float()).abs().max())
    return diff, diff / max(1.0, float(want.float().abs().max()))


def check_layer_split(x, dy, params, cfg, tag):
    """The tensor-core backward's two kernels at x's shape: the row kernel
    (dx, the weight gradients' bf16 operands, the small vectors) against
    its plain version, layer_wgrad against its plain version on the row
    kernel's operands, two calls of each giving the same bits. Returns
    layer_wgrad's error."""
    import torch

    from maskedsst_tpu_torch.ops import fused_layer, layer_wgrad

    b, s, d = x.shape
    heads, dh = cfg[0], cfg[1]
    i, f, n = heads * dh, params.w1.shape[1], b * s
    x1 = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    fused_layer._launch(x, params, *cfg, x1=x1)
    dx, ops, grads = fused_layer.layer_bwd_rows(x, dy, params, *cfg, x1=x1)
    dx2, ops2, grads2 = fused_layer.layer_bwd_rows(x, dy, params, *cfg, x1=x1)
    want_dx, want_ops, partials = fused_layer.layer_bwd_rows_reference(
        x, dy, params, *cfg, nparts=fused_layer._nparts(b, s, x.device))
    got, want = (layer_wgrad.split_operands(t, n, d, i, f) for t in (ops, want_ops))
    views = layer_wgrad.split_grads(grads, d, i, f)
    small = partials.sum(dim=0).split([views[k].numel() for k in fused_layer.SMALL])
    errs = {"dx": grad_err(dx, want_dx)[1]}
    errs.update({k: grad_err(got[k], want[k])[1] for k in layer_wgrad.OPERANDS})
    errs.update({k: grad_err(views[k], w)[1] for k, w in zip(fused_layer.SMALL, small)})
    worst = max(errs, key=errs.get)
    same = torch.equal(dx, dx2) and torch.equal(ops, ops2) and all(
        torch.equal(views[k], layer_wgrad.split_grads(grads2, d, i, f)[k])
        for k in fused_layer.SMALL)
    check(errs[worst] <= TOL_OP["bfloat16"] and same,
          f"fused_layer_bwd row kernel {tag}: dx, {len(layer_wgrad.OPERANDS)} operands and "
          f"{len(fused_layer.SMALL)} small vectors vs its plain version, worst {worst} "
          f"{errs[worst]:.3e} <= {TOL_OP['bfloat16']:.0e}; two calls bit-identical {same}")
    del dx2, ops2, grads2, want_ops, want_dx
    w1 = torch.empty_like(grads)
    w2 = torch.empty_like(grads)
    layer_wgrad.layer_wgrad(ops, n, d, i, f, w1)
    layer_wgrad.layer_wgrad(ops, n, d, i, f, w2)
    chunk_rows, nchunks = layer_wgrad.chunking(n, i, f)
    ref = layer_wgrad.layer_wgrad_reference(got, chunk_rows)
    v1, v2 = layer_wgrad.split_grads(w1, d, i, f), layer_wgrad.split_grads(w2, d, i, f)
    werrs = {k: grad_err(v1[k], ref[k]) for k in ref}
    wworst = max(werrs, key=lambda k: werrs[k][1])
    wsame = all(torch.equal(v1[k], v2[k]) for k in ref)
    check(werrs[wworst][1] <= TOL_OP["float32"] and wsame,
          f"layer_wgrad {tag}: {nchunks} chunks of {chunk_rows} rows, the four weight gradients "
          f"vs its plain version on the row kernel's operands, worst {wworst} max|d| "
          f"{werrs[wworst][0]:.3e}, rel {werrs[wworst][1]:.3e} <= {TOL_OP['float32']:.0e} "
          f"(fp32 sums of bf16 operands); two calls bit-identical {wsame}")
    plain_ms = cuda_ms(lambda: layer_wgrad.layer_wgrad_reference(got, chunk_rows), reps=3,
                       warmup=1)
    return x1, werrs[wworst][0], plain_ms


TRAINING_SHAPES = (("spatial", TRAIN_BATCH * 20, 64, ("float32", "bfloat16")),
                   ("spectral", TRAIN_BATCH * 64, 20, ("float32", "bfloat16")),
                   ("houston_spectral", TRAIN_BATCH * 64, 5, ("float32", "bfloat16")),
                   ("houston_spatial", TRAIN_BATCH * 5, 64, ("bfloat16",)))


def phase_layer_bwd(gen, shapes=TRAINING_SHAPES):
    """fused_layer_bwd against reference_layer_bwd at the training shapes
    (label, sequences, S, dtypes), the tensor-core form's two kernels
    against their plain versions, the masks bit for bit, determinism, and
    the forward's times with dropout."""
    import torch

    from maskedsst_tpu_torch.ops import dropout_probe, fused_layer
    from maskedsst_tpu_torch.ops.fused_layer import LayerParams

    d, heads, dh, f = 96, 8, 64, 64
    i = heads * dh
    params = random_layer_params(gen, d, heads, dh, f, "cuda")
    names = ("dx",) + LayerParams._fields
    bwd_cases, fwd_cases, wgrad_cases = [], [], []
    for label, b, s, dtype_names in shapes:
        dtypes = tuple(getattr(torch, n) for n in dtype_names)
        x32 = torch.randn(b, s, d, generator=gen).cuda()
        dy32 = torch.randn(b, s, d, generator=gen).cuda()
        seed = 1000 + s
        for dtype in dtypes:
            name = str(dtype).split(".")[1]
            x, dy = x32.to(dtype), dy32.to(dtype)
            cost = layer_cost(b, s, x.element_size(), d, i, f)
            # the masks the kernels apply, read out of their outputs
            for r in dropout_probe.read_layer_masks(
                    fused_layer._launch, fused_layer._launch_bwd, b, s, d, heads, dh, f, dtype,
                    dtype, 2**31 + seed, "cuda", gen):
                check(r.equal and r.margin < 0.5,
                      f"dropout masks {label} {name}, {r.what}: {r.bits} bits read from the "
                      f"kernels == dropout_mask, bit for bit (decode margin {r.margin:.3f})")
            torch.cuda.empty_cache()
            for rate in (0.0, 0.1):
                cfg = (heads, dh, dtype, rate, rate > 0, seed, True)
                tag = f"{label} [{b},{s},{d}] {name} dropout {rate}"
                # the forward at the training shape: against the plain
                # version (the masks included); in bf16 (the tensor-core
                # form) the training call, which also writes x1, its x1
                # against the plain x1 and its device time with dropout
                x1f = (torch.empty(x.shape, dtype=torch.float32, device="cuda")
                       if dtype == torch.bfloat16 else None)
                got = fused_layer._launch(x, params, *cfg, x1=x1f)
                want = fused_layer.reference_layer(x, params, *cfg)
                abs_err, err = rel_err(got, want)
                check(bool(torch.isfinite(got.float()).all()) and err <= TOL_OP[name],
                      f"fused_layer_fwd dropout {rate} {label} [{b},{s},{d}] {name}: "
                      f"max|d| {abs_err:.3e}, rel {err:.3e} <= {TOL_OP[name]:.0e}")
                if x1f is not None:
                    x1_abs, x1_err = rel_err(x1f, fused_layer.reference_x1(x, params, *cfg))
                    check(bool(torch.isfinite(x1f).all()) and x1_err <= TOL_OP[name],
                          f"fused_layer_fwd x1 {tag}: max|d| {x1_abs:.3e}, rel {x1_err:.3e} <= "
                          f"{TOL_OP[name]:.0e}")
                del got, want
                if rate:
                    ms = cuda_ms(lambda: fused_layer.fused_transformer_layer(x, params, *cfg),
                                 reps=10)
                    bms, by = bound_ms(*cost["fwd"], name)
                    case = dict(shape=f"{label}_train", dims=[b, s, d], dtype=name,
                                dropout=rate, ms=ms, bound_ms=bms, bound_by=by)
                    print(f"     fused_layer_fwd dropout 0.1 ms {ms:.4f} bound_ms {bms:.4f} "
                          f"({by})", flush=True)
                    if x1f is not None:
                        dms = device_ms(lambda: fused_layer._launch(x, params, *cfg, x1=x1f),
                                        reps=10, names=("fused_layer_fwd",))
                        case.update(device_ms=dms, share_of_bound=bms / dms)
                        print(f"     device ms, fused_layer_fwd {tag}, training call (x1 "
                              f"written): {dms:.4f}, bound {bms:.4f} ({by}), share of bound "
                              f"{bms / dms:.1%}", flush=True)
                    fwd_cases.append(case)
                del x1f
                # the tensor-core form (bf16) is the row kernel + layer_wgrad,
                # started from the x1 its forward writes
                x1 = None
                if dtype == torch.bfloat16:
                    x1, wgrad_err, wgrad_plain = check_layer_split(x, dy, params, cfg, tag)
                dx, grads = fused_layer._launch_bwd(x, dy, params, *cfg, x1=x1)
                want_dx, want = fused_layer.reference_layer_bwd(x, dy, params, *cfg)
                torch.cuda.synchronize()
                errs = {}
                for gname, g, w in zip(names, (dx, *grads), (want_dx, *want)):
                    abs_err, err = grad_err(g, w)
                    errs[gname] = err
                    check(bool(torch.isfinite(g.float()).all()) and err <= TOL_OP[name],
                          f"fused_layer_bwd {tag} "
                          f"{gname}: max|d| {abs_err:.3e}, rel {err:.3e} <= {TOL_OP[name]:.0e}")
                dx2, grads2 = fused_layer._launch_bwd(x, dy, params, *cfg, x1=x1)
                check(torch.equal(dx, dx2) and all(torch.equal(a, c) for a, c in zip(grads, grads2)),
                      f"fused_layer_bwd {label} {name} dropout {rate}: two calls give "
                      f"bit-identical dx and parameter gradients")
                del dx, grads, want_dx, want, dx2, grads2

                def bwd():
                    return fused_layer._launch_bwd(x, dy, params, *cfg, x1=x1)

                ms = cuda_ms(bwd, reps=5, warmup=1)
                plain = cuda_ms(lambda: fused_layer.reference_layer_bwd(x, dy, params, *cfg),
                                reps=5, warmup=1)
                whole = "bwd_tc" if x1 is not None else "bwd"
                nbytes, flops = cost[whole]
                bms, by = bound_ms(nbytes, flops, name)
                case = dict(shape=label, dims=[b, s, d], dtype=name, dropout=rate,
                            max_abs_err=max(errs.values()), rel_err=errs, ms=ms,
                            plain_ms=plain, bound_ms=bms, bound_by=by, flops=flops,
                            bytes=nbytes)
                print(f"     fused_layer_bwd {label} {name} dropout {rate}: ms {ms:.4f} "
                      f"plain_ms {plain:.4f} bound_ms {bms:.4f} ({by}) -> "
                      f"{flops / ms / 1e9:.2f} TFLOP/s", flush=True)
                if x1 is not None and rate:
                    # device time of the whole backward and of each kernel
                    parts = {}
                    for part, what, kn in (
                            ("bwd_tc", "whole backward", SPLIT_NAMES),
                            ("rows", "row kernel", ("fused_layer_bwd", "reduce_small")),
                            ("wgrad", "layer_wgrad", ("layer_wgrad", "reduce_chunks"))):
                        dms = device_ms(bwd, reps=10, names=kn)
                        pbms, pby = bound_ms(*cost[part], name)
                        parts[part] = (dms, pbms, pby)
                        print(f"     device ms, {tag}, {what} (with its reduction): {dms:.4f}, "
                              f"bound {pbms:.4f} ({pby})", flush=True)
                    case.update(device_ms=parts["bwd_tc"][0], rows_device_ms=parts["rows"][0],
                                rows_bound_ms=parts["rows"][1])
                    wbms, wby = parts["wgrad"][1], parts["wgrad"][2]
                    wgrad_cases.append(dict(shape=label, dims=[b * s, d, i, f], dtype=name,
                                            dropout=rate, max_abs_err=wgrad_err,
                                            ms=parts["wgrad"][0], plain_ms=wgrad_plain,
                                            bound_ms=wbms, bound_by=wby))
                bwd_cases.append(case)
                del x1
                torch.cuda.empty_cache()
    return bwd_cases, fwd_cases, wgrad_cases


def phase_embed_bwd(gen):
    """fused_embed_bwd against fused_embed_mask_reference_bwd at the EnMAP
    [64, 20, 10, 64] and Houston2018 [64, 5, 10, 64] training shapes, every
    gradient, d pos included."""
    import torch

    from maskedsst_tpu_torch.ops import fused_embed

    p, n, d = 10, 64, 96
    names = ("preln_scale", "preln_bias", "kernel", "bias", "postln_scale", "postln_bias",
             "pos", "mask_token")
    cases = []
    for label, b, g in (("embed", TRAIN_BATCH, 20), ("houston_embed", TRAIN_BATCH, 5)):
        patches = torch.randn(b, g, p, n, generator=gen).cuda()
        mask = (torch.rand(b, g, n, generator=gen) < 0.7).float().cuda()

        def r(*shape, base=0.0, scale=0.1):
            return (base + scale * torch.randn(*shape, generator=gen)).cuda()

        args = (patches, mask, r(p, base=1.0), r(p), r(g, p, d, scale=p**-0.5), r(g, d),
                r(d, base=1.0), r(d), r(g, n, d, scale=1.0), r(d, scale=1.0))
        dtok32 = torch.randn(b, g, n, d, generator=gen).cuda()
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
                      f"fused_embed_bwd [{b},{g},{p},{n}]->{d} {name} {gname}: max|d| "
                      f"{abs_err:.3e}, rel {err:.3e} <= {TOL_OP[name]:.0e}")
            again = fused_embed._launch_bwd(*args, dtok, dtype)
            check(all(torch.equal(a, c) for a, c in zip(got, again)),
                  f"fused_embed_bwd {label} {name}: two calls give bit-identical gradients")
            ms = cuda_ms(lambda: fused_embed._launch_bwd(*args, dtok, dtype))
            plain = cuda_ms(lambda: fused_embed.fused_embed_mask_reference_bwd(*args, dtok, dtype))
            nbytes, flops = embed_cost(b, g, p, n, d, dtok.element_size())["bwd"]
            bms, by = bound_ms(nbytes, flops, name)
            cases.append(dict(shape=label, dims=[b, g, p, n, d], dtype=name,
                              max_abs_err=max(errs.values()), rel_err=errs, ms=ms, plain_ms=plain,
                              bound_ms=bms, bound_by=by, flops=flops, bytes=nbytes))
            print(f"     fused_embed_bwd {label} {name}: ms {ms:.4f} plain_ms {plain:.4f} "
                  f"bound_ms {bms:.4f} ({by}) -> {nbytes / ms / 1e6:.1f} GB/s", flush=True)
    return cases


def rel_to_max(got, want) -> float:
    """max |got - want| / max |want|, per tensor (an all-zero reference must
    stay zero)."""
    scale = float(want.float().abs().max())
    diff = float((got.float() - want.float()).abs().max())
    return diff / scale if scale > 0 else diff


def phase_simmim(gen):
    """fused_simmim_fwd/bwd against their plain versions: the recipe shape,
    Houston's 5 blocks, a batch of 61, dim 16; fp32 and bf16."""
    import torch

    from maskedsst_tpu_torch.ops import fused_simmim
    from maskedsst_tpu_torch.ops.masking import MaskGenerator, loss_weights

    fwd_cases, bwd_cases = [], []
    mask_gen = MaskGenerator(8, 4, 1, 0.7)
    for label, b, g, p, n, d in (("simmim", TRAIN_BATCH, 20, 10, 64, 96),
                                 ("houston", TRAIN_BATCH, 5, 10, 64, 96),
                                 ("batch_61", 61, 20, 10, 64, 96),
                                 ("dim_16", TRAIN_BATCH, 20, 10, 64, 16)):
        enc32 = torch.randn(b, g, n, d, generator=gen).cuda()
        patches = torch.randn(b, g, p, n, generator=gen).cuda()
        kernel = (torch.randn(g, d, p, generator=gen) / math.sqrt(d)).cuda()
        bias = (0.1 * torch.randn(g, p, generator=gen)).cuda()
        cgen = torch.Generator(device="cuda").manual_seed(SEED + b + g + d)
        bool_mask = mask_gen.batch_masks(cgen, b, g, True)
        weights = loss_weights(bool_mask, int(0.7 * g * n))
        weights[0] = 0.0  # an all-zero weight row
        # the recipe's cotangent: 1 / (B * num_masked * p) / num_masked
        gout = torch.tensor(1.0 / (b * int(0.7 * g * n) * p) / int(0.7 * g * n), device="cuda")
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[1]
            enc = enc32.to(dtype)
            args = (enc, patches, kernel, bias, weights)
            cost = decode_cost(b, g, n, d, p, enc.element_size())
            form = "tensor-core form" if fused_simmim._tc_form(dtype, p, d) else "FMA form"
            got = fused_simmim._launch(*args, dtype)
            want = fused_simmim.fused_decode_l1_reference(*args, dtype)
            again = fused_simmim._launch(*args, dtype)
            torch.cuda.synchronize()
            abs_err = abs(float(got) - float(want))
            err = abs_err / abs(float(want))
            check(math.isfinite(float(got)) and err <= TOL_LOSS[name],
                  f"fused_simmim_fwd {label} [{b},{g},{n},{d}]->{p} {name}: loss {float(got):.6e} "
                  f"vs plain {float(want):.6e}, rel {err:.3e} <= {TOL_LOSS[name]:.0e}")
            check(torch.equal(got, again), f"fused_simmim_fwd {label} {name}: two calls give "
                                           "bit-identical losses")
            # device time: a CUDA-event time of a launch this short measures
            # the host's path through the wrapper
            ms = device_ms(lambda: fused_simmim._launch(*args, dtype),
                           names=("fused_simmim_fwd", "sum_partials"))
            plain = device_ms(lambda: fused_simmim.fused_decode_l1_reference(*args, dtype))
            event_ms = cuda_ms(lambda: fused_simmim._launch(*args, dtype))
            check(math.isfinite(ms) and math.isfinite(plain),
                  f"fused_simmim_fwd {label} {name}: the profiler measured device time")
            nbytes, flops = cost["fwd"]
            bms, by = bound_ms(nbytes, flops, name)
            fwd_cases.append(dict(shape=label, dims=[b, g, n, d, p], dtype=name, form=form,
                                  max_abs_err=abs_err, rel_err=err, ms=ms, plain_ms=plain,
                                  bound_ms=bms, bound_by=by, flops=flops, bytes=nbytes,
                                  event_ms=event_ms))
            print(f"     fused_simmim_fwd {label} {name} ({form}): device ms {ms:.4f} "
                  f"plain {plain:.4f} bound_ms {bms:.4f} ({by}) -> {nbytes / ms / 1e6:.1f} "
                  f"GB/s; CUDA-event ms of one call {event_ms:.4f}", flush=True)

            got = fused_simmim._launch_bwd(*args, gout, dtype)
            want = fused_simmim.fused_decode_l1_reference_bwd(*args, gout, dtype)
            again = fused_simmim._launch_bwd(*args, gout, dtype)
            torch.cuda.synchronize()
            errs, abs_errs = {}, {}
            for gname, gv, wv in zip(("encoded", "kernel", "bias"), got, want):
                errs[gname] = rel_to_max(gv, wv)
                abs_errs[gname] = float((gv.float() - wv.float()).abs().max())
                check(bool(torch.isfinite(gv.float()).all()) and errs[gname] <= TOL_OP[name],
                      f"fused_simmim_bwd {label} [{b},{g},{n},{d}]->{p} {name} d{gname}: "
                      f"max|d| {abs_errs[gname]:.3e}, max|d|/max|ref| {errs[gname]:.3e} "
                      f"<= {TOL_OP[name]:.0e}")
            check(all(torch.equal(a, c) for a, c in zip(got, again)),
                  f"fused_simmim_bwd {label} {name}: two calls give bit-identical gradients")
            del got, want, again
            ms = device_ms(lambda: fused_simmim._launch_bwd(*args, gout, dtype),
                           names=("fused_simmim_bwd", "reduce_partials"))
            plain = device_ms(lambda: fused_simmim.fused_decode_l1_reference_bwd(*args, gout,
                                                                                 dtype))
            event_ms = cuda_ms(lambda: fused_simmim._launch_bwd(*args, gout, dtype))
            check(math.isfinite(ms) and math.isfinite(plain),
                  f"fused_simmim_bwd {label} {name}: the profiler measured device time")
            nbytes, flops = cost["bwd"]
            bms, by = bound_ms(nbytes, flops, name)
            bwd_cases.append(dict(shape=label, dims=[b, g, n, d, p], dtype=name, form=form,
                                  max_abs_err=max(abs_errs.values()), rel_err=errs, ms=ms,
                                  plain_ms=plain, bound_ms=bms, bound_by=by, flops=flops,
                                  bytes=nbytes, event_ms=event_ms))
            print(f"     fused_simmim_bwd {label} {name} ({form}): device ms {ms:.4f} "
                  f"plain {plain:.4f} bound_ms {bms:.4f} ({by}) -> {nbytes / ms / 1e6:.1f} "
                  f"GB/s; CUDA-event ms of one call {event_ms:.4f}", flush=True)
        torch.cuda.empty_cache()
    return fwd_cases, bwd_cases


@contextlib.contextmanager
def plain_versions():
    """Route the models' three fused ops to their plain versions (still on
    the card, forward and backward), for the main paths' reference runs."""
    from maskedsst_tpu_torch.models import layers, simmim
    from maskedsst_tpu_torch.ops import fused_embed, fused_layer, fused_simmim

    saved = layers.fused_transformer_layer, layers.fused_embed_mask, simmim.fused_decode_l1
    layers.fused_transformer_layer = fused_layer.plain_transformer_layer
    layers.fused_embed_mask = fused_embed.plain_embed_mask
    simmim.fused_decode_l1 = fused_simmim.plain_decode_l1
    try:
        yield
    finally:
        layers.fused_transformer_layer, layers.fused_embed_mask, simmim.fused_decode_l1 = saved


def phase_main(card: str):
    """The serving path: Predictor over the EnMAP-DFC classifier. Returns
    the launches and the cubes/s of each dtype."""
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
    launches, rates = {}, {}
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
        rates[name] = rate
        print(f"     serving {name}: {rate:.1f} cubes/s (N={x.shape[0]}, batch {BATCH}, "
              f"median of 3, host clock incl. transfers) on {card}", flush=True)
        del model, pred
        torch.cuda.empty_cache()
    return launches, rates


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
                   "layer_wgrad": 2 * depth, "fused_embed_fwd": 0, "fused_embed_bwd": 0,
                   "fused_simmim_fwd": 0, "fused_simmim_bwd": 0},
        "emb_dropout_0": {"fused_layer_fwd": 2 * depth, "fused_layer_bwd": 2 * depth,
                          "layer_wgrad": 2 * depth,
                          "fused_embed_fwd": 1, "fused_embed_bwd": 1,
                          "fused_simmim_fwd": 0, "fused_simmim_bwd": 0},
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
    for name in ("fused_layer_fwd", "fused_layer_bwd", "layer_wgrad", "fused_embed_fwd",
                 "fused_embed_bwd"):
        check(main_counts[name] > 0, f"training path: {name} launched {main_counts[name]} times")
    torch.cuda.empty_cache()

    # --- one step's gradients against the plain versions (same seeds) -------
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
        prof = profile_step(lambda: trainer.train_step(tiles["img"], tiles["label"]))
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


@functools.lru_cache(maxsize=1)
def pretrain_tiles(n_bands: int):
    """The 640 unlabeled synthetic tiles of phases 4 and 6 (made once: each
    sample is cached by the dataset)."""
    from maskedsst_tpu_torch.data.synthetic import SyntheticCubeDataset

    return SyntheticCubeDataset(num_tiles=10 * TRAIN_BATCH, n_bands=n_bands, labeled=False,
                                seed=SEED)


def pretrain_step_grads(trainer, img, bool_mask, seed):
    """Loss and parameter gradients of one forward/backward of the
    pretrainer's model (no clamp, no update) on a given crop and mask, its
    dropout seeds drawn from a generator at seed."""
    import torch

    model = trainer.model
    model.train()
    model.zero_grad(set_to_none=True)
    loss = model(img, rng=torch.Generator().manual_seed(seed), bool_mask=bool_mask)
    loss.backward()
    grads = {n: q.grad.detach().clone() for n, q in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return float(loss.detach()), grads


def phase_pretrain(card: str):
    """The pretraining path: Pretrainer on the pretrain config, tiles in
    DeviceTileStores on the card."""
    import torch

    from maskedsst_tpu_torch.config import get_pretrain_config
    from maskedsst_tpu_torch.data.device_store import DeviceTileStore, IndexBatcher
    from maskedsst_tpu_torch.data.pipeline import split_dataset
    from maskedsst_tpu_torch.train.pretrainer import Pretrainer, largest_divisor

    base = get_pretrain_config("configs/pretrain_config.yaml", "configs/config.yaml", seed=SEED)
    t0 = time.perf_counter()
    data = pretrain_tiles(base.n_bands)
    val_ds, train_ds = split_dataset(data, base.train_fraction, base.data_fraction, SEED)
    train_store = DeviceTileStore(train_ds, "cuda")
    val_store = DeviceTileStore(val_ds, "cuda")
    store = train_store.arrays["img"]
    check(store.is_cuda and val_store.arrays["img"].is_cuda and len(val_store) >= TRAIN_BATCH,
          f"pretrain: {len(train_store)} train and {len(val_store)} val tiles "
          f"{tuple(store.shape[1:])} resident on the card "
          f"({time.perf_counter() - t0:.1f} s to make and upload)")
    batches = IndexBatcher(len(train_store), TRAIN_BATCH, shuffle=True, drop_last=True,
                           seed=SEED)
    idx_all = batches.take(60)
    depth = base.transformer_depth
    per_step_want = {"fused_layer_fwd": 2 * depth, "fused_layer_bwd": 2 * depth,
                     "layer_wgrad": 2 * depth, "fused_embed_fwd": 1, "fused_embed_bwd": 1,
                     "fused_simmim_fwd": 1, "fused_simmim_bwd": 1}

    def trainer_for(dtype, batch):
        cfg = base.copy()
        cfg.batch_size = batch
        return Pretrainer(cfg, dtype=dtype, device="cuda")

    # --- (a) the main path, counted: bf16, the store path ---------------------
    reset_counts()
    losses, seen = [], []
    for batch, steps in ((2, 3), (TRAIN_BATCH, 20)):
        trainer = trainer_for(torch.bfloat16, batch)
        for k in range(steps):
            before = launch_counts()
            m = trainer.train_step_idx(store, idx_all[k][:batch])
            torch.cuda.synchronize()
            after = launch_counts()
            per_step = {n: after[n] - before[n] for n in after}
            losses.append(float(m["loss"]))
            if per_step not in seen:
                seen.append(per_step)
        if batch == TRAIN_BATCH:
            main_trainer = trainer
        else:
            del trainer
    main_counts = launch_counts()
    check(seen == [per_step_want],
          f"pretrain bf16: launches at every one of {len(losses)} steps {seen} == "
          f"{per_step_want}")
    check(all(math.isfinite(v) for v in losses),
          f"pretrain bf16: {len(losses)} losses finite (last {losses[-1]:.6e})")
    for name, n in main_counts.items():
        check(n > 0, f"pretraining path: {name} launched {n} times")

    # --- (b) one validation pass (the val store's first batch) ---------------
    val_idx = next(iter(IndexBatcher(len(val_store), TRAIN_BATCH, shuffle=False,
                                     drop_last=True)))
    tiles = val_store.arrays["img"][torch.as_tensor(val_idx, device="cuda")]
    windows = TRAIN_BATCH * (64 // base.image_size) ** 2
    chunks = windows // largest_divisor(windows, 512)
    before = launch_counts()
    vloss = float(main_trainer._step_val(tiles, seed=7))
    torch.cuda.synchronize()
    after = launch_counts()
    val_counts = {n: after[n] - before[n] for n in after}
    val_want = {"fused_layer_fwd": 2 * depth * chunks, "fused_layer_bwd": 0, "layer_wgrad": 0,
                "fused_embed_fwd": chunks, "fused_embed_bwd": 0,
                "fused_simmim_fwd": chunks, "fused_simmim_bwd": 0}
    check(math.isfinite(vloss) and val_counts == val_want,
          f"pretrain validation: {windows} windows in {chunks} chunks, loss {vloss:.6e} finite, "
          f"launches {val_counts} == {chunks} x (8 / 0 / 0 / 1 / 0 / 1 / 0)")
    del main_trainer, tiles
    torch.cuda.empty_cache()

    # --- (c) one step's gradients against the plain versions (same crop,
    # mask and dropout seeds) ---------------------------------------------------
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[1]
        trainer = trainer_for(dtype, TRAIN_BATCH)
        img = trainer._gather_crop(store, torch.as_tensor(idx_all[0], device="cuda"), (5, 9),
                                   base.image_size)
        bool_mask = trainer.model.sample_mask(TRAIN_BATCH, "cuda", torch.Generator().manual_seed(3))
        loss_k, g_k = pretrain_step_grads(trainer, img, bool_mask, seed=77)
        with plain_versions():
            loss_p, g_p = pretrain_step_grads(trainer, img, bool_mask, seed=77)
            # a fault to hold the limit against: the step with other dropout masks
            _, g_f = pretrain_step_grads(trainer, img, bool_mask, seed=78)
        errs = {n: rel_to_max(g_k[n], ref) for n, ref in g_p.items()}
        faults = sorted(rel_to_max(g_f[n], ref) for n, ref in g_p.items())
        caught = sum(v > TOL_STEP[name] for v in faults)
        worst = max(errs, key=errs.get)
        print(f"     pretrain {name} step: the five largest gradient errors "
              + ", ".join(f"{n} {errs[n]:.3e}" for n in sorted(errs, key=errs.get)[-5:]),
              flush=True)
        check(abs(loss_k - loss_p) <= TOL_LOSS[name] * abs(loss_p),
              f"pretrain {name} step: loss {loss_k:.8e} vs plain {loss_p:.8e} "
              f"(rel {abs(loss_k - loss_p) / abs(loss_p):.3e} <= {TOL_LOSS[name]:.0e})")
        check(errs[worst] <= TOL_STEP[name],
              f"pretrain {name} step: each of {len(errs)} gradients vs plain versions on the "
              f"card, worst {worst} max|d|/max|ref| {errs[worst]:.3e} <= {TOL_STEP[name]:.1e} "
              f"(other dropout masks read {faults[-1]:.3e} at worst, "
              f"{faults[len(faults) // 2]:.3e} median, {caught} leaves above the limit; "
              f"a zeroed leaf reads 1)")
        del trainer, g_k, g_p, g_f, img
        torch.cuda.empty_cache()

    # --- (d) the loss falls over 60 steps (bf16, batch 64). The recipe (lr
    # 8e-3, no warm-up) rises for its first ~25 steps before it falls, in
    # the JAX package's own soak too (SOAK_r05.json: 1.275e-3 at step 0,
    # 1.378e-3 at 16, 0.972e-3 at 32), so 30 steps can end inside the rise
    # (one such window read 1.40e-3 -> 3.19e-3 on an H100) --------------------
    trainer = trainer_for(torch.bfloat16, TRAIN_BATCH)
    losses = [float(trainer.train_step_idx(store, idx)["loss"]) for idx in idx_all[:60]]
    first, last = sum(losses[:5]) / 5, sum(losses[-5:]) / 5
    print("     pretrain bf16 losses, every 5th step from 1: "
          + " ".join(f"{v:.3e}" for v in losses[::5]), flush=True)
    check(last < first, f"pretrain bf16: mean loss of steps 1-5 {first:.6e} > steps 56-60 "
                        f"{last:.6e}")
    del trainer

    # --- (e) steps/s and cubes/s at batch 64 ----------------------------------
    rates = {}
    for name, dtype in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
        trainer = trainer_for(dtype, TRAIN_BATCH)
        it = iter(idx_all)

        def step():
            return trainer.train_step_idx(store, next(it))

        for _ in range(2):  # warm-up
            step()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        walls = []
        for _ in range(7):
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        step_s = statistics.median(walls)
        print(f"     pretraining {name}: peak allocated device memory over 7 steps "
              f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB (the store, weights and "
              f"optimizer state included)", flush=True)
        prof = profile_step(step)
        if prof:
            print(f"     profile pretrain {name}: {prof['device_ms_per_step']:.2f} ms of device "
                  f"time in a {prof['wall_ms_per_step']:.2f} ms step (busy "
                  f"{prof['busy_share']:.1%}); by kernel: "
                  + ", ".join(f"{g} {ms:.3f} ms" for g, ms in prof["groups_ms_per_step"].items()),
                  flush=True)
        else:
            print(f"     profile pretrain {name}: the profiler recorded no device time "
                  "(not measured)", flush=True)
        rates[name] = 1 / step_s
        print(f"     pretraining {name}: {1 / step_s:.3f} steps/s, {TRAIN_BATCH / step_s:.1f} "
              f"cubes/s (batch {TRAIN_BATCH}, median of 7 steps, store path: crop gathered on "
              f"the card) on {card}", flush=True)
        del trainer
        torch.cuda.empty_cache()
    return main_counts, seen[0], rates


def states_equal(a, b) -> list:
    """The names of what differs, bit for bit, between two TrainStates:
    step, generator, each parameter, each optimizer moment and step, and
    the optimizer's hyperparameters."""
    import torch

    diff = [] if a.step == b.step else ["step"]
    if not torch.equal(a.rng.get_state(), b.rng.get_state()):
        diff.append("rng")
    sa, sb = a.model.state_dict(), b.model.state_dict()
    diff += [k for k in sa if not torch.equal(sa[k], sb[k])]
    oa, ob = a.optimizer.state_dict(), b.optimizer.state_dict()
    if oa["param_groups"] != ob["param_groups"]:
        diff.append("optimizer param_groups")
    for i, st in oa["state"].items():
        diff += [f"optimizer state {i} {k}" for k, v in st.items()
                 if not torch.equal(v, ob["state"][i][k])]
    return diff


def chunk_steps(before: dict, after: dict, out: dict, chunk: bool):
    """One call's launches and metrics as per-step entries: a step's, or a
    superstep chunk's (``train_chunk_idx``: [k] metric vectors) split into k
    steps, its launches shared evenly (a remainder, which no chunk of equal
    steps leaves, stays on its first step, where a per-step check sees it)."""
    delta = {n: after[n] - before[n] for n in after}
    if not chunk:
        return [delta], [out]
    k = next(iter(out.values())).shape[0]
    steps = [{n: d // k for n, d in delta.items()} for _ in range(k)]
    for n, d in delta.items():
        steps[0][n] += d % k
    return steps, [{name: v[i] for name, v in out.items()} for i in range(k)]


def step_methods(name: str):
    """(method, is a chunk) pairs to wrap for a step method ``name``: the
    store path's single step goes with its superstep chunk."""
    return [(name, False)] + ([("train_chunk_idx", True)] if name == "train_step_idx" else [])


def counting_steps(trainer, name: str, seen: list):
    """Wraps the trainer's step method ``name`` (with ``train_step_idx`` its
    chunk method too) so that each step records its launches (a synchronize
    after each call; the numbers are unchanged)."""
    import torch

    for method, chunk in step_methods(name):
        def counted(*args, _step=getattr(trainer, method), _chunk=chunk, **kwargs):
            before = launch_counts()
            out = _step(*args, **kwargs)
            torch.cuda.synchronize()
            seen.extend(chunk_steps(before, launch_counts(), out, _chunk)[0])
            return out

        setattr(trainer, method, counted)


def phase_checkpoint(card: str, pretrain_per_step: dict, finetune_per_step: dict):
    """The checkpoint path: pretraining interrupted by a max_steps break and
    resumed in a new trainer, bit for bit against an uninterrupted run; the
    encoder carried into the EnMAP-DFC classifier; finetune steps and a
    finetune resume; the reference .pth round trip through Predictor."""
    import tempfile

    import torch

    from maskedsst_tpu_torch.config import get_finetune_config, get_pretrain_config
    from maskedsst_tpu_torch.data.pipeline import DataLoader, split_dataset
    from maskedsst_tpu_torch.data.synthetic import SyntheticCubeDataset
    from maskedsst_tpu_torch.io.torch_import import (
        import_vit_spatial_spectral,
        load_torch_checkpoint,
    )
    from maskedsst_tpu_torch.serve import Predictor
    from maskedsst_tpu_torch.tools.export_torch_checkpoint import export_checkpoint
    from maskedsst_tpu_torch.train.checkpoint import restore_params, save_checkpoint
    from maskedsst_tpu_torch.train.factory import build_finetune_model, load_pretrained_params
    from maskedsst_tpu_torch.train.finetuner import Finetuner
    from maskedsst_tpu_torch.train.pretrainer import Pretrainer

    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    out: dict = {}
    try:
        # --- (a) pretraining: control vs interrupted + resumed (bf16, batch
        # 64, the store path; 576 train tiles: 9 steps an epoch) ------------
        cfg = get_pretrain_config("configs/pretrain_config.yaml", "configs/config.yaml",
                                  seed=SEED)
        data = pretrain_tiles(cfg.n_bands)
        spe = int(len(data) * cfg.train_fraction) // TRAIN_BATCH
        budget, stop = 2 * spe + 3, spe + 3

        def pretrainer():
            return Pretrainer(cfg.copy(), dtype=torch.bfloat16, device="cuda")

        control = pretrainer()
        hist_c = control.fit(data, epochs=3, max_steps=budget, tracker=QuietTracker(),
                             save_checkpoints=False)
        interrupted = pretrainer()
        interrupted.fit(data, epochs=3, max_steps=stop, tracker=QuietTracker("pre"),
                        models_dir=tmp)
        path = os.path.join(tmp, "pre", f"model_{cfg.encoder_name}_at_step{stop}.pt")
        check(os.path.exists(path) and os.path.exists(
                  os.path.join(tmp, "pre", f"model_{cfg.encoder_name}_ep0.pt")),
              f"checkpoint: the max_steps break at step {stop} wrote {os.path.basename(path)} "
              f"(and model_{cfg.encoder_name}_ep0.pt at the end of epoch 0)")
        saves = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            save_checkpoint(os.path.join(tmp, "timed.pt"), interrupted.state, interrupted.config,
                            extra=interrupted._scheduler_extra())
            saves.append(time.perf_counter() - t0)
        del interrupted

        resumed = pretrainer()
        restores = []
        for _ in range(3):  # restoring the same file again leaves the same state
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            at = resumed.resume(path)
            torch.cuda.synchronize()
            restores.append(time.perf_counter() - t0)
        save_s, restore_s = statistics.median(saves), statistics.median(restores)
        on_card = all(p.is_cuda for p in resumed.model.parameters()) and all(
            v.is_cuda for st in resumed.state.optimizer.state.values() for k, v in st.items()
            if k != "step")
        mib = os.path.getsize(path) / 2**20
        print(f"     checkpoint {os.path.basename(path)}: {mib:.2f} MiB "
              f"({resumed.num_params:,} parameters, two AdamW moments, step, generator), saved "
              f"in {save_s:.3f} s, restored onto the card in {restore_s:.3f} s (medians of 3, "
              f"host clock, synchronized; the page cache holds the file) on {card}", flush=True)
        out["pretrain_ckpt_mib"], out["save_s"], out["restore_s"] = mib, save_s, restore_s
        check(at == stop and on_card,
              f"checkpoint: resume at step {at} == {stop}, parameters and moments on the card")

        seen: list = []
        counting_steps(resumed, "train_step_idx", seen)
        reset_counts()
        hist_r = resumed.fit(data, epochs=3, max_steps=budget, tracker=QuietTracker(),
                             save_checkpoints=False)
        torch.cuda.synchronize()
        out["pretrain_resume"] = launch_counts()
        steps = budget - stop
        check(len(seen) == steps and all(c == pretrain_per_step for c in seen),
              f"checkpoint: each of the resumed run's {len(seen)} steps launched phase 4's "
              f"{pretrain_per_step}")
        for name, n in out["pretrain_resume"].items():
            check(n > 0, f"checkpoint path (pretraining resume): {name} launched {n} times")
        diff = states_equal(control.state, resumed.state)
        same_sched = control.scheduler.state_dict() == resumed.scheduler.state_dict()
        check(not diff and same_sched and hist_r["val_loss"] == hist_c["val_loss"][1:],
              f"checkpoint: pretraining resumed at step {stop} == uninterrupted to {budget}, "
              f"bit for bit: {sum(1 for _ in control.model.parameters())} parameters, their "
              f"AdamW moments and steps, state.step, the generator, the scheduler "
              f"(differ: {diff[:6] or 'none'}; scheduler equal {same_sched}; validation "
              f"losses {hist_r['val_loss']} vs {hist_c['val_loss'][1:]})")
        del control, resumed
        torch.cuda.empty_cache()

        # --- (b) finetuning from that checkpoint (EnMAP-DFC classifier, bf16,
        # embedding dropout 0: all of kernels #1-#4 run) --------------------
        ft = get_finetune_config("configs/finetune_config_enmap.yaml", "configs/config.yaml",
                                 seed=SEED)
        ft.transformer_emb_dropout = 0.0
        ft.batch_size = TRAIN_BATCH

        def finetuner(pretrained: bool):
            model, kw = build_finetune_model(ft, dtype=torch.bfloat16, device="cuda")
            fresh = {k: v.clone() for k, v in model.state_dict().items()}
            if pretrained:
                model.load_state_dict(load_pretrained_params(path, ft, model, seed=ft.seed))
            return Finetuner(ft.copy(), model, **kw), fresh

        trainer, fresh = finetuner(True)
        ckpt = restore_params(path, "cuda")
        got = trainer.model.state_dict()
        carried = [k for k in got if f"encoder.{k}" in ckpt and not k.startswith("head_linear.")]
        skipped = sorted(k[len("encoder."):] for k in ckpt
                         if k.startswith("encoder.") and k[len("encoder."):] not in got)
        kept_fresh = sorted(k for k in got if k not in carried)
        check(len(carried) > 0 and all(torch.equal(got[k], ckpt[f"encoder.{k}"]) for k in carried)
              and all(torch.equal(got[k], fresh[k]) for k in kept_fresh),
              f"checkpoint: {len(carried)} encoder tensors carried into the classifier bit for "
              f"bit; fresh and equal to a seeded model: {kept_fresh}; skipped (the recipes' "
              f"positions differ): {skipped}")
        data_ft = SyntheticCubeDataset(num_tiles=160, n_bands=ft.n_bands, n_classes=ft.n_classes,
                                       seed=SEED)
        tiles = next(iter(DataLoader(data_ft, TRAIN_BATCH, shuffle=False)))
        seen = []
        counting_steps(trainer, "train_step", seen)
        reset_counts()
        walls, losses = [], []
        for _ in range(10):
            t0 = time.perf_counter()
            losses.append(float(trainer.train_step(tiles["img"], tiles["label"])["loss"]))
            walls.append(time.perf_counter() - t0)
        out["finetune"] = launch_counts()
        check(all(c == finetune_per_step for c in seen),
              f"checkpoint: each of 10 finetune steps from the checkpoint launched "
              f"{finetune_per_step}")
        for name in ("fused_layer_fwd", "fused_layer_bwd", "layer_wgrad", "fused_embed_fwd",
                     "fused_embed_bwd"):
            check(out["finetune"][name] > 0,
                  f"checkpoint path (finetuning): {name} launched {out['finetune'][name]} times")
        first, last = sum(losses[:3]) / 3, sum(losses[-3:]) / 3
        check(all(math.isfinite(v) for v in losses) and last < first,
              f"checkpoint: finetune losses finite, mean of steps 1-3 {first:.4f} > 8-10 "
              f"{last:.4f} ({' '.join(f'{v:.4f}' for v in losses)})")
        out["finetune_steps_per_s"] = 1 / statistics.median(walls[2:])
        print(f"     finetuning from the checkpoint: {out['finetune_steps_per_s']:.3f} steps/s "
              f"(batch {TRAIN_BATCH}, bf16, median of steps 3-10, host clock incl. the copy "
              f"to the card and a synchronize) on {card}", flush=True)

        # mid-epoch finetune resume against a control (128 train tiles: 2
        # steps an epoch; the interrupted run stops in epoch 1)
        val_ds, train_ds = split_dataset(data_ft, ft.train_fraction, ft.data_fraction, SEED)
        fspe = -(-len(train_ds) // TRAIN_BATCH)
        fbudget, fstop = 2 * fspe + 1, fspe + 1
        control, _ = finetuner(True)
        control.fit(train_ds, val_ds, epochs=3, max_steps=fbudget, tracker=QuietTracker(),
                    save_checkpoints=False)
        interrupted, _ = finetuner(True)
        hist_i = interrupted.fit(train_ds, val_ds, epochs=3, max_steps=fstop,
                                 tracker=QuietTracker("ft"), models_dir=tmp)
        fpath = os.path.join(tmp, "ft", f"{ft.method_name}_at_step{fstop}.pt")
        resumed, _ = finetuner(False)
        at = resumed.resume(fpath)
        best = resumed._resume_extra.get("best_val_acc")
        resumed.fit(train_ds, val_ds, epochs=3, max_steps=fbudget, tracker=QuietTracker(),
                    save_checkpoints=False)
        diff = states_equal(control.state, resumed.state)
        same_sched = control.scheduler.state_dict() == resumed.scheduler.state_dict()
        check(at == fstop and best == hist_i["best_val_acc"] and not diff and same_sched,
              f"checkpoint: finetuning resumed from {os.path.basename(fpath)} (best_val_acc "
              f"{best}) == uninterrupted to step {fbudget}, bit for bit (differ: "
              f"{diff[:6] or 'none'}; scheduler equal {same_sched})")
        del control, interrupted, resumed
        torch.cuda.empty_cache()

        # --- (c) the reference format: the finetuned model through a .pth --
        pt = os.path.join(tmp, "finetuned.pt")
        save_checkpoint(pt, trainer.state, trainer.config)
        pth = os.path.join(tmp, "finetuned.pth")
        n = export_checkpoint(pt, pth)
        back, _ = build_finetune_model(ft, dtype=torch.bfloat16, device="cuda")
        back.load_state_dict(import_vit_spatial_spectral(
            load_torch_checkpoint(pth)["model_state_dict"], back))
        x = np.random.default_rng(SEED).standard_normal((300, ft.n_bands, 8, 8)).astype(np.float32)
        a = Predictor(trainer.model, batch_size=BATCH)(x)
        b = Predictor(back, batch_size=BATCH)(x)
        check(a.shape == b.shape and np.array_equal(a, b),
              f"checkpoint: finetuned model -> .pt -> export tool -> .pth ({n} reference-keyed "
              f"tensors) -> import: Predictor(batch_size={BATCH}) logits of 300 cubes equal bit "
              f"for bit ({a.shape})")
    finally:
        import shutil

        shutil.rmtree(tmp, ignore_errors=True)
    return out



def recording_steps(trainer, name: str, seen: list, metrics: list):
    """Wraps the trainer's step method ``name`` (with ``train_step_idx`` its
    chunk method too) so that each step records its launches (counted on
    the host as they are made, a chunk's split by ``chunk_steps``) and its
    metrics, with no synchronize: the trainer's own epoch timing stays as
    it is."""
    for method, chunk in step_methods(name):
        def recorded(*args, _step=getattr(trainer, method), _chunk=chunk, **kwargs):
            before = launch_counts()
            out = _step(*args, **kwargs)
            steps, outs = chunk_steps(before, launch_counts(), out, _chunk)
            seen.extend(steps)
            metrics.extend(outs)
            return out

        setattr(trainer, method, recorded)


def same_bits(a: np.ndarray, b: np.ndarray) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(
        np.ascontiguousarray(a).view(np.uint8), np.ascontiguousarray(b).view(np.uint8))


def phase_real_data(card: str, per_step: dict, store_dir: str):
    """The real data path: the .msts packer and reader, finetuning from a
    packed store through get_dataset (the device-store path against the
    streaming path, validation on the card, a store-path resume),
    pretraining from an unlabeled store, Houston2018 on an injected
    full-size scene, and both drivers on the stores. The labeled store is
    packed into ``store_dir`` (phase 8 reads it; the caller removes it)."""
    import glob
    import shutil
    import tempfile

    import torch
    import yaml

    from maskedsst_tpu_torch import finetune as finetune_driver
    from maskedsst_tpu_torch import pretrain as pretrain_driver
    from maskedsst_tpu_torch.config import get_finetune_config, get_pretrain_config
    from maskedsst_tpu_torch.data.constants import ENMAP_MEANS_CLIPPED, ENMAP_STDS_CLIPPED
    from maskedsst_tpu_torch.data.device_store import DeviceTileStore, IndexBatcher
    from maskedsst_tpu_torch.data.houston2018 import Houston2018Dataset
    from maskedsst_tpu_torch.data.pipeline import DataLoader, split_dataset
    from maskedsst_tpu_torch.data.resolve import get_dataset, tile_size
    from maskedsst_tpu_torch.etl import pack_tiles as packer
    from maskedsst_tpu_torch.native import PackedTileStore
    from maskedsst_tpu_torch.train.factory import build_finetune_model
    from maskedsst_tpu_torch.train.finetuner import Finetuner
    from maskedsst_tpu_torch.train.pretrainer import Pretrainer

    tmp = tempfile.mkdtemp(prefix="chip_smoke_real_")
    out: dict = {}
    try:
        # --- (a) pack and read: 512 labeled EnMAP-DFC tiles, 256 unlabeled --
        t0 = time.perf_counter()
        # the packer's synthetic tiles are seeded by 0
        labeled = packer.main(["--synthetic", "--synthetic-tiles", "512", "--n-bands", "200",
                               "--out", os.path.join(store_dir, "dfc.msts")])
        unlabeled = packer.main(["--synthetic", "--synthetic-tiles", "256", "--n-bands", "200",
                                 "--unlabeled", "--out", os.path.join(tmp, "enmap.msts")])
        print(f"     packed {labeled} ({os.path.getsize(labeled) / 1e9:.2f} GB) and {unlabeled} "
              f"({os.path.getsize(unlabeled) / 1e9:.2f} GB) in {time.perf_counter() - t0:.1f} s "
              "(tiles made and written)", flush=True)
        std = (ENMAP_MEANS_CLIPPED[:200], ENMAP_STDS_CLIPPED[:200])
        native, plain = PackedTileStore(labeled), PackedTileStore(labeled, native=False)
        nstd = PackedTileStore(labeled, standardize=std)
        pstd = PackedTileStore(labeled, standardize=std, native=False)
        rng = np.random.default_rng(SEED)
        idx = rng.permutation(512)[:128]
        xs, ys = rng.integers(0, 64 - 8 + 1, 128), rng.integers(0, 64 - 8 + 1, 128)
        labels = native.gather_labels(np.arange(512))
        reads = {
            "gather": same_bits(native.gather(idx), plain.gather(idx)),
            "gather_crop": same_bits(native.gather_crop(idx, xs, ys, 8),
                                     plain.gather_crop(idx, xs, ys, 8)),
            "gather_labels": same_bits(native.gather_labels(idx), plain.gather_labels(idx)),
            "standardized gather": same_bits(nstd.gather(idx), pstd.gather(idx)),
            "standardized gather_crop": same_bits(nstd.gather_crop(idx, xs, ys, 8),
                                                  pstd.gather_crop(idx, xs, ys, 8)),
        }
        check(all(reads.values()) and (native.num_tiles, native.bands, native.height,
                                       native.width) == (512, 200, 64, 64)
              and labels.min() == -1 and labels.max() == 7,
              f"real data: {native.num_tiles} tiles [200, 64, 64], DFC labels in "
              f"{labels.min()}..{labels.max()}; the native reader equals the numpy reader bit "
              f"for bit on 128 tiles (crops 8x8 at seeded origins): {reads}")
        order = rng.permutation(512)
        tile_mb = 200 * 64 * 64 * 4 / 1e6
        for name, st in ((f"native reader ({native.threads} threads)", native),
                         ("numpy reader", plain)):
            st.gather(order[:64])  # warm-up (the page cache holds the file)
            t = time.perf_counter()
            for lo in range(0, 512, 64):
                st.gather(order[lo : lo + 64])
            dt = time.perf_counter() - t
            print(f"     {name}: {512 / dt:.1f} tiles/s, {512 * tile_mb / dt:.1f} MB/s (gather "
                  f"of 8 shuffled batches of 64 whole tiles, host clock) on the host of {card}: "
                  f"{os.cpu_count()} CPUs, {len(os.sched_getaffinity(0))} for this process, "
                  f"load averages {os.getloadavg()}", flush=True)
        del native, plain, nstd, pstd

        # --- (b) finetuning from the .msts through get_dataset ---------------
        ft = get_finetune_config("configs/finetune_config_enmap.yaml", "configs/config.yaml",
                                 seed=SEED)
        ft.train_path = labeled
        dataset = get_dataset(ft, supervised=True)
        check(isinstance(dataset, PackedTileStore) and tile_size(dataset) == 64,
              f"real data: get_dataset resolves {os.path.basename(labeled)} to a "
              f"PackedTileStore of {len(dataset)} labeled 64x64 tiles")
        val_ds, train_ds = split_dataset(dataset, ft.train_fraction, ft.data_fraction, SEED)

        def finetuner(batch, emb_rate, device_data):
            cfg = ft.copy()
            cfg.batch_size, cfg.transformer_emb_dropout = batch, emb_rate
            cfg.device_data = device_data
            cfg.max_steps = 0  # the config's budget: a validation at every epoch end
            model, kw = build_finetune_model(cfg, dtype=torch.bfloat16, device="cuda")
            return Finetuner(cfg, model, tile_size=64, **kw)

        reset_counts()
        for batch, route, epochs in ((TRAIN_BATCH, "emb_dropout_0", 2), (2, "recipe", 1)):
            emb_rate = 0.0 if route == "emb_dropout_0" else 0.1
            runs = {}
            for device_data in (True, False):
                trainer = finetuner(batch, emb_rate, device_data)
                seen, metrics = [], []
                recording_steps(trainer, "train_step_idx" if device_data else "train_step",
                                seen, metrics)
                hist = trainer.fit(train_ds, val_ds, epochs=epochs, max_steps=10**9,
                                   tracker=QuietTracker(), save_checkpoints=False)
                runs[device_data] = trainer, hist, seen, [float(m["loss"]) for m in metrics]
            store, h_store, seen, losses = runs[True]
            stream, h_stream, _, s_losses = runs[False]
            steps = epochs * -(-len(train_ds) // batch)
            tag = f"real data finetune batch {batch} ({route}, bf16)"
            check(h_store["device_store"] and not h_stream["device_store"] and len(seen) == steps
                  and all(c == per_step[route] for c in seen),
                  f"{tag}: {len(seen)} store-path steps ({len(train_ds)} train tiles, the last "
                  f"batch of each epoch padded with -1), each launching phase 3's "
                  f"{per_step[route]}; the streaming run built no store")
            diff = states_equal(store.state, stream.state)
            check(losses == s_losses and all(math.isfinite(v) for v in losses) and not diff,
                  f"{tag}: store path == streaming path bit for bit: {len(losses)} per-step "
                  f"losses (last {losses[-1]:.6f}), every parameter and Adam moment, the "
                  f"generator (differ: {diff[:6] or 'none'})")
            vs, vh = h_store["val"], h_stream["val"]
            check(len(vs) == len(vh) == epochs and all(
                      a["acc"] == b["acc"] and a["macro_acc"] == b["macro_acc"]
                      and abs(a["loss"] - b["loss"]) <= 1e-5 * abs(b["loss"])
                      for a, b in zip(vs, vh)),
                  f"{tag}: validation on the card (_eval_sums_idx) == host windows: acc "
                  f"{[v['acc'] for v in vs]}, macro {[v['macro_acc'] for v in vs]} exactly, "
                  f"loss {[v['loss'] for v in vs]} vs {[v['loss'] for v in vh]} within 1e-5")
            rate = {k: h["throughput"]["steps_per_s"] for k, h in (("store", h_store),
                                                                    ("streaming", h_stream))}
            out[f"finetune_b{batch}_steps_per_s"] = rate
            print(f"     {tag}: store path {rate['store']:.2f} steps/s, streaming path "
                  f"{rate['streaming']:.2f} steps/s ({steps} steps, whole epochs timed with one "
                  f"synchronize each, validation excluded; the streamed batches read from the "
                  f".msts on the host) on {card}", flush=True)
            if batch == TRAIN_BATCH:
                val_store = DeviceTileStore(val_ds, "cuda")
                on_card = store.validate(IndexBatcher(len(val_store), 2, shuffle=False), val_store)
                host = store.validate(DataLoader(val_ds, 2, shuffle=False, pad_to_multiple=2))
                check(on_card["acc"] == host["acc"] and on_card["macro_acc"] == host["macro_acc"]
                      and abs(on_card["loss"] - host["loss"]) <= 1e-5 * abs(host["loss"]),
                      f"{tag}: the trained model's validation of {len(val_ds)} tiles on the "
                      f"card {on_card} == host windows {host} (loss within 1e-5)")
                del val_store
            del store, stream, runs
            torch.cuda.empty_cache()

        # a mid-epoch resume on the store path against its control
        spe = -(-len(train_ds) // TRAIN_BATCH)
        budget, stop = 2 * spe + 3, spe + 3
        control = finetuner(TRAIN_BATCH, 0.0, True)
        control.fit(train_ds, val_ds, epochs=3, max_steps=budget, tracker=QuietTracker(),
                    save_checkpoints=False)
        interrupted = finetuner(TRAIN_BATCH, 0.0, True)
        interrupted.fit(train_ds, val_ds, epochs=3, max_steps=stop, tracker=QuietTracker("ft"),
                        models_dir=tmp)
        resumed = finetuner(TRAIN_BATCH, 0.0, True)
        at = resumed.resume(os.path.join(tmp, "ft", f"{ft.method_name}_at_step{stop}.pt"))
        hist = resumed.fit(train_ds, val_ds, epochs=3, max_steps=budget, tracker=QuietTracker(),
                           save_checkpoints=False)
        diff = states_equal(control.state, resumed.state)
        same_sched = control.scheduler.state_dict() == resumed.scheduler.state_dict()
        check(at == stop and hist["device_store"] and not diff and same_sched,
              f"real data: the store path resumed at step {stop} == uninterrupted to {budget}, "
              f"bit for bit (differ: {diff[:6] or 'none'}; scheduler equal {same_sched})")
        del control, interrupted, resumed
        torch.cuda.empty_cache()

        # --- (c) pretraining from the unlabeled .msts -------------------------
        pc = get_pretrain_config("configs/pretrain_config.yaml", "configs/config.yaml",
                                 seed=SEED)
        pc.train_path = unlabeled
        pdata = get_dataset(pc, supervised=False)
        ft_unlabeled = ft.copy()
        ft_unlabeled.train_path = unlabeled
        try:
            get_dataset(ft_unlabeled, supervised=True)
            refused = "nothing"
        except ValueError as exc:
            refused = str(exc)
        check(isinstance(pdata, PackedTileStore) and not pdata.has_labels
              and "unlabeled tile store" in refused,
              f"real data: {os.path.basename(unlabeled)} resolves to an unlabeled store of "
              f"{len(pdata)} tiles; the supervised path raises ({refused})")
        trainer = Pretrainer(pc, dtype=torch.bfloat16, tile_size=tile_size(pdata), device="cuda")
        seen, metrics = [], []
        recording_steps(trainer, "train_step_idx", seen, metrics)
        trainer.fit(pdata, max_steps=10, tracker=QuietTracker(), save_checkpoints=False)
        losses = [float(m["loss"]) for m in metrics]
        check(len(seen) == 10 and all(c == per_step["pretrain"] for c in seen)
              and all(math.isfinite(v) for v in losses),
              f"real data pretraining (bf16, batch {pc.batch_size}): 10 store-path steps, each "
              f"launching phase 4's {per_step['pretrain']}, losses finite (last "
              f"{losses[-1]:.6e})")
        del trainer
        torch.cuda.empty_cache()

        # --- (d) Houston2018 on an injected full-size scene -------------------
        t0 = time.perf_counter()
        hrng = np.random.default_rng(SEED)
        scene = hrng.standard_normal((50, 1202, 4768), dtype=np.float32)
        scene[48:] = 0.0  # the zero padding from 48 to 50 bands
        gt = hrng.integers(-1, 20, (1202, 4768))
        hc = get_finetune_config("configs/finetune_config_houston2018.yaml",
                                 "configs/config.yaml", seed=SEED)
        fixed = Houston2018Dataset("", "", patch_size=8, fix_train_patches=True, img=scene,
                                   label=gt)
        drawn = Houston2018Dataset("", "", patch_size=8, fix_train_patches=False,
                                   drop_unlabeled=True, img=scene, label=gt, seed=SEED)
        print(f"     Houston2018 scene [50, 1202, 4768] fp32 ({scene.nbytes / 1e9:.2f} GB) made "
              f"and patched in {time.perf_counter() - t0:.1f} s", flush=True)
        check(len(fixed) == 22350 and not fixed.stochastic and drawn.stochastic,
              f"houston2018: {len(fixed)} fixed 8x8 train patches (rows 601:, columns 596:2980), "
              f"the random-patch set stochastic")
        for name, ds, want_store in (("fixed patches", fixed, True),
                                     ("random patches", drawn, False)):
            val, train = split_dataset(ds, hc.train_fraction, hc.data_fraction, SEED)
            cfg = hc.copy()
            model, kw = build_finetune_model(cfg, dtype=torch.bfloat16, device="cuda")
            trainer = Finetuner(cfg, model, tile_size=tile_size(ds), **kw)
            seen, metrics = [], []
            recording_steps(trainer, "train_step_idx" if want_store else "train_step",
                            seen, metrics)
            t0 = time.perf_counter()
            hist = trainer.fit(train, val, epochs=1, max_steps=10, tracker=QuietTracker(),
                               save_checkpoints=False)
            losses = [float(m["loss"]) for m in metrics]
            where = (f"the device store ({len(train)} patches, "
                     f"{len(train) * (50 * 8 * 8 * 4 + 8 * 8 * 8) / 1e9:.2f} GB)" if want_store
                     else "streamed, no store built")
            check(hist["device_store"] is want_store and len(seen) == 10
                  and all(c == per_step["recipe"] for c in seen)
                  and all(math.isfinite(v) for v in losses),
                  f"houston2018 {name} (batch {cfg.batch_size}, bf16): {where}; 10 steps each "
                  f"launching {per_step['recipe']}, losses finite (last {losses[-1]:.4f}); fit "
                  f"took {time.perf_counter() - t0:.1f} s")
            del trainer, model
            torch.cuda.empty_cache()
        del scene, gt, fixed, drawn

        # --- (e) the drivers on the stores ------------------------------------
        with open("configs/config.yaml") as f:
            general = yaml.safe_load(f)
        general["data"]["dfc"]["train_path"] = labeled
        general["data"]["enmap"]["train_path"] = unlabeled
        config = os.path.join(tmp, "config.yaml")
        with open(config, "w") as f:
            yaml.safe_dump(general, f)
        models = os.path.join(tmp, "models")
        for name, main, argv, ckpt in (
                ("finetune", finetune_driver.main,
                 ["enmap", "--config", config, "--steps", "20", "--checkpoint", "none"],
                 "ViTSpatialSpectral_at_step20.pt"),
                ("pretrain", pretrain_driver.main, ["--config", config, "--steps", "20"],
                 "model_ViTSpatialSpectral_at_step20.pt")):
            t0 = time.perf_counter()
            log_path = os.path.join(tmp, f"{name}.log")
            with open(log_path, "w") as log, contextlib.redirect_stdout(log):
                main(argv + ["--models-dir", os.path.join(models, name)])
            with open(log_path) as log:
                final = [line.strip() for line in log if line.startswith("FINAL")]
            found = glob.glob(os.path.join(models, name, "*", ckpt))
            check(len(found) == 1 and len(final) == 1,
                  f"real data: the {name} driver ({' '.join(argv).replace(config, '<tmp yaml>')}) "
                  f"trained from its .msts, wrote {ckpt} and printed '{final}' in "
                  f"{time.perf_counter() - t0:.1f} s")
        out["counts"] = launch_counts()
        out["labeled"] = labeled
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for name, n in out["counts"].items():
        check(n > 0, f"real data path: {name} launched {n} times")
    return out


@contextlib.contextmanager
def smooth_l1():
    """Route the SimMIM model's decode + weighted L1 to a plain decode with
    a smooth L1, sum w * sqrt(diff^2 + 1e-2): the same step without the
    kink of |diff|, whose sign (the gradient of the loss) one rounding can
    flip where a residual is near 0."""
    from maskedsst_tpu_torch.models import simmim
    from maskedsst_tpu_torch.ops import fused_simmim

    def smooth(encoded, patches, kernel, bias, weights, dtype):
        diff = fused_simmim._diff(encoded, patches, kernel, bias, dtype)
        return ((diff * diff + 1e-2).sqrt() * fused_simmim._w4(weights, encoded)).sum()

    saved = simmim.fused_decode_l1
    simmim.fused_decode_l1 = smooth
    try:
        yield
    finally:
        simmim.fused_decode_l1 = saved


# On fresh weights the bf16 step's leaves are held to the bf16 plain step
# within TOL_STEP; a leaf above that is held instead by its distance from
# the fp32 plain step on the same inputs: the kernel route no further from
# it than NEARER_FP32 x the plain bf16 route's distance (both bf16 routes
# round at the same points; other dropout masks, the fault printed beside,
# read several times more).
NEARER_FP32 = 1.5


def houston_step_check(label: str, cfg, state: dict, img, trained: bool) -> None:
    """One Houston2018 pretraining step's loss and gradients on the weights
    ``state`` (the same crop, mask and dropout seeds throughout): the
    kernels against the plain versions in fp32, every leaf within TOL_STEP,
    and the loss in both types. bf16 leaves on fresh weights: within
    TOL_STEP of the plain bf16 step or, above it, no further than
    NEARER_FP32 x as far from the fp32 plain step as the plain bf16 step
    is. On trained weights, where the bf16 step itself (either route) sits
    percents from fp32 in many leaves, each bf16 leaf nearer the plain
    bf16 step than that step with other dropout masks is, and both routes'
    distances from fp32 printed. Prints d pos_embedding's distances from
    fp32, and the plain bf16 route's with the L1 made smooth."""
    import torch

    from maskedsst_tpu_torch.train.pretrainer import Pretrainer

    pos = "encoder.pos_embedding"
    grads, smooth, bool_mask = {}, {}, None
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        trainer = Pretrainer(cfg, dtype=dtype, tile_size=cfg.image_size, device="cuda")
        trainer.model.load_state_dict(state)
        if bool_mask is None:
            bool_mask = trainer.model.sample_mask(img.shape[0], "cuda",
                                                  torch.Generator().manual_seed(3))
        loss_k, g_k = pretrain_step_grads(trainer, img, bool_mask, seed=77)
        with plain_versions():
            loss_p, g_p = pretrain_step_grads(trainer, img, bool_mask, seed=77)
            # a fault to hold the limit against: the step with other dropout masks
            _, g_f = pretrain_step_grads(trainer, img, bool_mask, seed=78)
            with smooth_l1():
                smooth[name] = pretrain_step_grads(trainer, img, bool_mask, seed=77)[1][pos]
        del trainer
        grads[name] = g_k, g_p, g_f
        errs = {n: rel_to_max(g_k[n], ref) for n, ref in g_p.items()}
        faults = {n: rel_to_max(g_f[n], ref) for n, ref in g_p.items()}
        ranked = sorted(faults.values())
        print(f"     houston pretrain {label} {name} step: the five largest gradient errors "
              + ", ".join(f"{n} {errs[n]:.3e}" for n in sorted(errs, key=errs.get)[-5:])
              + f" (other dropout masks read {ranked[-1]:.3e} at worst, "
              f"{ranked[len(ranked) // 2]:.3e} median)", flush=True)
        check(abs(loss_k - loss_p) <= TOL_LOSS[name] * abs(loss_p),
              f"houston pretrain {label} {name} step: loss {loss_k:.8e} vs plain {loss_p:.8e} "
              f"(rel {abs(loss_k - loss_p) / abs(loss_p):.3e} <= {TOL_LOSS[name]:.0e})")
        if dtype == torch.float32:
            worst = max(errs, key=errs.get)
            check(errs[worst] <= TOL_STEP[name],
                  f"houston pretrain {label} {name} step: each of {len(errs)} gradients vs plain "
                  f"versions on the card, worst {worst} max|d|/max|ref| {errs[worst]:.3e} <= "
                  f"{TOL_STEP[name]:.1e}")
            continue
        ref32 = grads["float32"][1]

        def from_fp32(n):
            return rel_to_max(g_k[n], ref32[n]), max(rel_to_max(g_p[n], ref32[n]), 1e-30)

        over = {n: e for n, e in errs.items() if e > TOL_STEP[name]}
        if trained:
            ratio = {n: e / max(faults[n], 1e-30) for n, e in errs.items()}
            worst = max(ratio, key=ratio.get)
            check(ratio[worst] < 1.0,
                  f"houston pretrain {label} {name} step: each of {len(errs)} gradients nearer "
                  f"the plain bf16 step than the plain bf16 step with other dropout masks is; "
                  f"worst {worst} {errs[worst]:.3e} vs {faults[worst]:.3e} ({ratio[worst]:.2f}x)")
            dist = {n: from_fp32(n) for n in over}
            if dist:
                far = max(dist, key=lambda n: dist[n][0] / dist[n][1])
                print(f"     houston pretrain {label} {name} step: {len(over)} of {len(errs)} "
                      f"gradients above {TOL_STEP[name]:.1e} of the plain bf16 step (worst "
                      f"{max(over.values()):.3e}); on them, from the fp32 plain step, the kernels "
                      f"read up to {max(k for k, _ in dist.values()):.3e} and the plain bf16 "
                      f"step up to {max(p for _, p in dist.values()):.3e}; kernels / plain "
                      f"{statistics.mean(k / p for k, p in dist.values()):.2f}x on average, "
                      f"{dist[far][0] / dist[far][1]:.2f}x at most ({far})", flush=True)
        else:
            for n, e in over.items():
                k32, p32 = from_fp32(n)
                check(k32 <= NEARER_FP32 * p32,
                      f"houston pretrain {label} {name} step: {n} reads {e:.3e} vs the plain "
                      f"bf16 step (> {TOL_STEP[name]:.1e}); from the fp32 plain step the kernels "
                      f"read {k32:.3e} <= {NEARER_FP32} x the plain bf16 step's {p32:.3e}")
            held = {n: e for n, e in errs.items() if n not in over} or {"none": 0.0}
            worst = max(held, key=held.get)
            check(held[worst] <= TOL_STEP[name],
                  f"houston pretrain {label} {name} step: {len(errs) - len(over)} of {len(errs)} "
                  f"gradients within {TOL_STEP[name]:.1e} of the plain bf16 step, worst {worst} "
                  f"{held[worst]:.3e}; {len(over)} held by the fp32 step above")
        k32, p32 = from_fp32(pos)
        s32 = rel_to_max(smooth[name], smooth["float32"])
        print(f"     houston pretrain {label}: d pos_embedding {errs[pos]:.3e} from the plain "
              f"bf16 step; from the fp32 plain step: bf16 kernels {k32:.3e}, bf16 plain "
              f"{p32:.3e}; with a smooth L1, bf16 plain {s32:.3e}", flush=True)
        torch.cuda.empty_cache()


def phase_tools(card: str):
    """The tools path: tools.kernel_check in full at the Houston2018 shapes
    (its checks counted here, kernel #7 among them; phases 1b and 1c time
    the EnMAP shapes), then kernel #7's times; Houston2018 pretraining at
    full width through bench_geometries' workload, its step held to the
    plain versions on fresh and on trained weights; serving_bench at batch
    256 with a 1-cube request; bf16_soak at 32 steps per leg."""
    import torch

    from maskedsst_tpu_torch.ops import dropout_sample, fused_layer
    from maskedsst_tpu_torch.tools import bench_geometries, bf16_soak, kernel_check, serving_bench
    from maskedsst_tpu_torch.train.pretrainer import Pretrainer

    # --- (a) the kernel-check path, counted --------------------------------
    model_paths = dropout_sample.launches  # phases 1-4 never launch it
    dropout_sample.launches = 0
    kernel_check.run(check, "cuda", "houston")
    check_path = dropout_sample.launches
    check(model_paths == 0 and check_path > 0,
          f"dropout_sample: launched {model_paths} times on the model paths, {check_path} on "
          "the kernel-check path")
    drop_cases = kernel_check.dropout_sample_cases("cuda")
    torch.cuda.empty_cache()

    # --- (b) Houston2018 pretraining at full width, counted -----------------
    steps, window, windows = 20, 10, bench_geometries.WINDOWS
    taken = steps + bench_geometries.WARMUP + window * windows + bench_geometries.PROFILED
    cfg = bench_geometries.houston_pretrain_config()
    fresh = Pretrainer(cfg, dtype=torch.bfloat16, tile_size=cfg.image_size,
                       device="cuda").model.state_dict()
    trainer, store, idx = bench_geometries.houston_pretrainer(torch.bfloat16, "cuda", taken + 1)
    depth = trainer.config.transformer_depth
    want = {"fused_layer_fwd": 2 * depth, "fused_layer_bwd": 2 * depth,
            "layer_wgrad": 2 * depth, "fused_embed_fwd": 1, "fused_embed_bwd": 1,
            "fused_simmim_fwd": 1, "fused_simmim_bwd": 1}
    reset_counts()
    losses, seen = [], []
    for k in range(steps):
        before = launch_counts()
        losses.append(float(trainer.train_step_idx(store, idx[k])["loss"]))
        after = launch_counts()
        per_step = {n: after[n] - before[n] for n in after}
        if per_step not in seen:
            seen.append(per_step)
    houston_counts = launch_counts()
    check(seen == [want], f"houston pretrain bf16 [{len(idx[0])}, 50, 8, 8]: launches at every "
                          f"one of {steps} steps {seen} == {want}")
    check(all(math.isfinite(v) for v in losses),
          f"houston pretrain bf16: {steps} losses finite (last {losses[-1]:.6e})")
    it = iter(idx[steps:-1])
    m = bench_geometries.measure(lambda: trainer.train_step_idx(store, next(it)), window, "cuda")
    prof = m["profile"]
    batch = trainer.config.batch_size
    rates = [batch / s for s in m["window_step_s"]]
    print(f"     houston pretraining bfloat16: {1 / m['step_s']:.3f} steps/s, "
          f"{batch / m['step_s']:.1f} cubes/s (batch {batch}, {windows} windows of {window} "
          f"steps, one synchronize each; windows {min(rates):.1f}-{max(rates):.1f} cubes/s); "
          f"device {prof.get('device_ms_per_step', float('nan')):.2f} ms, span "
          f"{prof.get('span_ms_per_step', float('nan')):.2f} ms per step, idle share "
          f"{prof.get('idle_share', float('nan')):.1%} on {card}", flush=True)

    # --- (c) one step's gradients against the plain versions, on fresh
    # weights (as phase 4) and on the weights after the steps above ---------
    img = store[torch.as_tensor(idx[-1], device="cuda")]
    trained = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    del trainer
    torch.cuda.empty_cache()
    houston_step_check("fresh", cfg, fresh, img, trained=False)
    houston_step_check(f"trained ({taken} steps)", cfg, trained, img, trained=True)
    del store

    # --- (d) serving_bench at batch 256, a 1-cube request -------------------
    fused_layer.launches = 0
    rows = serving_bench.run([BATCH], [1], reps=3)
    check(fused_layer.launches > 0 and len(rows) == 3
          and all(math.isfinite(r["value"]) and r["value"] > 0 for r in rows),
          f"serving_bench: {len(rows)} rows (cubes/s at batch {BATCH}, 1-cube latency padded "
          f"and exact), finite; fused_layer_fwd launched {fused_layer.launches} times")
    torch.cuda.empty_cache()

    # --- (e) the bf16 soak, 32 steps per leg ---------------------------------
    rec = bf16_soak.soak(32, 8, 0.05, "cuda")
    check(all(leg["nan_free"] for leg in rec["legs"].values()) and rec["first_rel_delta"] <= 1e-2,
          f"bf16_soak 32 steps: both legs finite, step-1 losses bf16 "
          f"{rec['legs']['bf16']['first_loss']:.6e} vs fp32 {rec['legs']['fp32']['first_loss']:.6e}"
          f" (rel {rec['first_rel_delta']:.2e} <= 1e-2); final-window rel delta "
          f"{rec['final_rel_delta']:.3e}")
    torch.cuda.empty_cache()
    return check_path, model_paths, drop_cases, houston_counts, seen[0]


@contextlib.contextmanager
def class_recording(cls, name: str, seen: list, metrics: list):
    """``recording_steps`` for every instance of ``cls``: the drivers make
    their trainers themselves. Restores the methods on exit."""
    saved = {method: getattr(cls, method) for method, _ in step_methods(name)}
    for method, chunk in step_methods(name):
        def recorded(self, *args, _step=saved[method], _chunk=chunk, **kwargs):
            before = launch_counts()
            out = _step(self, *args, **kwargs)
            steps, outs = chunk_steps(before, launch_counts(), out, _chunk)
            seen.extend(steps)
            metrics.extend(outs)
            return out

        setattr(cls, method, recorded)
    try:
        yield
    finally:
        for method, step in saved.items():
            setattr(cls, method, step)


class PerSampleReads:
    """A dataset without its batch read: the loader reads it sample by
    sample and collates."""

    def __init__(self, dataset):
        self.dataset = dataset

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, i):
        return self.dataset[i]


def prefetch_threads() -> list:
    import threading

    return [t for t in threading.enumerate() if t.name == "DataLoader-prefetch" and t.is_alive()]


def threads_back(before: int, limit_s: float = 1.0) -> float:
    """Seconds until ``threading.active_count()`` is back to ``before`` and
    no prefetch thread is alive, or -1 when that takes longer than
    ``limit_s``."""
    import threading

    t0 = time.perf_counter()
    while time.perf_counter() - t0 <= limit_s:
        if threading.active_count() == before and not prefetch_threads():
            return time.perf_counter() - t0
        time.sleep(0.01)
    return -1.0


@contextlib.contextmanager
def loader_prefetch(prefetch: int):
    """Finetune.fit's host loaders built with ``prefetch`` batches read
    ahead in place of the loader's default."""
    from maskedsst_tpu_torch.train import finetuner as finetuner_mod

    loader = finetuner_mod.DataLoader
    finetuner_mod.DataLoader = functools.partial(loader, prefetch=prefetch)
    try:
        yield
    finally:
        finetuner_mod.DataLoader = loader


def run_quietly(log_path: str, main, argv):
    """A driver's main(argv) with its standard output sent to log_path;
    returns its result and its output's lines."""
    with open(log_path, "w") as log, contextlib.redirect_stdout(log):
        result = main(argv)
    with open(log_path) as log:
        return result, [line.rstrip("\n") for line in log]


def phase_drivers(card: str, per_step: dict, labeled: str):
    """Phase 8, the drivers: the loader's prefetch thread on phase 7's
    .msts and on Houston2018's random patches, pretraining through its
    driver with a JSONL Tracker and log_grad_norm, the sweep driver from
    that pretraining checkpoint, and the inference example from the
    sweep's checkpoint."""
    import copy
    import glob
    import threading

    import torch

    from maskedsst_tpu_torch import finetune_sweep, inference_example
    from maskedsst_tpu_torch import pretrain as pretrain_driver
    from maskedsst_tpu_torch.config import get_finetune_config
    from maskedsst_tpu_torch.data.houston2018 import Houston2018Dataset
    from maskedsst_tpu_torch.data.pipeline import split_dataset
    from maskedsst_tpu_torch.data.resolve import get_dataset, tile_size
    from maskedsst_tpu_torch.ops import dropout_sample
    from maskedsst_tpu_torch.serve import Predictor
    from maskedsst_tpu_torch.train import pretrainer as pretrainer_mod
    from maskedsst_tpu_torch.train.checkpoint import restore_params
    from maskedsst_tpu_torch.train.factory import build_finetune_model
    from maskedsst_tpu_torch.train.finetuner import Finetuner
    from maskedsst_tpu_torch.train.pretrainer import Pretrainer

    tmp = tempfile.mkdtemp(prefix="chip_smoke_drivers_")
    out: dict = {"steps_per_s": {}}
    drop_before = dropout_sample.launches
    reset_counts()
    try:
        # --- (a) phase 7's .msts: the store, streamed with prefetch 2 and 0 --
        ft = get_finetune_config("configs/finetune_config_enmap.yaml", "configs/config.yaml",
                                 seed=SEED)
        ft.train_path = labeled
        dataset = get_dataset(ft, supervised=True)
        val_ds, train_ds = split_dataset(dataset, ft.train_fraction, ft.data_fraction, SEED)
        # streamed: a batch read a batch at a time (read_batch), or sample
        # by sample and collated, as the JAX loader reads
        paths = {"store": (True, 2, False), "prefetch 2": (False, 2, False),
                 "prefetch 0": (False, 0, False),
                 "per-sample reads, prefetch 2": (False, 2, True),
                 "per-sample reads, prefetch 0": (False, 0, True)}
        for batch, route, epochs in ((TRAIN_BATCH, "emb_dropout_0", 2), (2, "recipe", 1)):
            names = list(paths) if batch == TRAIN_BATCH else list(paths)[:3]
            runs = {}
            for name in names:
                device_data, prefetch, per_sample = paths[name]
                cfg = ft.copy()
                cfg.batch_size = batch
                cfg.transformer_emb_dropout = 0.0 if route == "emb_dropout_0" else 0.1
                cfg.device_data = device_data
                cfg.max_steps = 0  # the config's budget: a validation at every epoch end
                model, kw = build_finetune_model(cfg, dtype=torch.bfloat16, device="cuda")
                trainer = Finetuner(cfg, model, tile_size=64, **kw)
                seen, metrics = [], []
                recording_steps(trainer, "train_step_idx" if device_data else "train_step",
                                seen, metrics)
                threads = threading.active_count()
                with loader_prefetch(prefetch):
                    hist = trainer.fit(PerSampleReads(train_ds) if per_sample else train_ds,
                                       val_ds, epochs=epochs, max_steps=10**9,
                                       tracker=QuietTracker(), save_checkpoints=False)
                runs[name] = (trainer, hist, seen, [float(m["loss"]) for m in metrics],
                              threads_back(threads))
            tag = f"drivers: .msts finetune batch {batch} ({route}, bf16, {epochs} epochs)"
            store, h_store, seen, losses, _ = runs["store"]
            steps = epochs * -(-len(train_ds) // batch)
            for name in names[1:]:
                other, hist, o_seen, o_losses, back = runs[name]
                diff = states_equal(store.state, other.state)
                check(h_store["device_store"] and not hist["device_store"]
                      and len(seen) == len(o_seen) == steps
                      and all(c == per_step[route] for c in seen + o_seen)
                      and losses == o_losses and all(math.isfinite(v) for v in losses)
                      and not diff and back >= 0,
                      f"{tag}: streamed with {name} == the store path bit for bit: {steps} "
                      f"per-step losses (last {losses[-1]:.6f}), every parameter and Adam moment, "
                      f"the generator (differ: {diff[:6] or 'none'}); each step launching phase "
                      f"3's {per_step[route]}; threads back to their count {back:.3f} s after fit")
            check([v["acc"] for v in runs["prefetch 2"][1]["val"]]
                  == [v["acc"] for v in runs["prefetch 0"][1]["val"]],
                  f"{tag}: validation of the streamed runs equal with prefetch 2 and 0: "
                  f"{[v['acc'] for v in runs['prefetch 2'][1]['val']]}")
            rate = {name: runs[name][1]["throughput"]["steps_per_s"] for name in names}
            out["steps_per_s"][f"msts_b{batch}"] = rate
            print(f"     {tag}: store path {rate['store']:.2f} steps/s; streamed "
                  + ", ".join(f"with {name} {rate[name]:.2f}" for name in names[1:])
                  + f" ({steps} steps each, whole epochs timed with one synchronize each, "
                  f"validation excluded) on {card}", flush=True)
            del runs, store, trainer, model
            torch.cuda.empty_cache()

        # --- (b) Houston2018's random patches: streamed, prefetch 2 and 0 ---
        t0 = time.perf_counter()
        hrng = np.random.default_rng(SEED)
        scene = hrng.standard_normal((50, 1202, 4768), dtype=np.float32)
        scene[48:] = 0.0
        gt = hrng.integers(-1, 20, (1202, 4768))
        hc = get_finetune_config("configs/finetune_config_houston2018.yaml",
                                 "configs/config.yaml", seed=SEED)
        print(f"     Houston2018 scene [50, 1202, 4768] made in {time.perf_counter() - t0:.1f} s",
              flush=True)
        # prefetch 2 and 0 alternating, so that a drift of the host's clock
        # over the phase falls on both
        hsteps, order = 100, (2, 0, 0, 2)
        runs = []
        for prefetch in order:
            drawn = Houston2018Dataset("", "", patch_size=8, fix_train_patches=False,
                                       drop_unlabeled=True, img=scene, label=gt, seed=SEED)
            val, train = split_dataset(drawn, hc.train_fraction, hc.data_fraction, SEED)
            cfg = hc.copy()
            model, kw = build_finetune_model(cfg, dtype=torch.bfloat16, device="cuda")
            trainer = Finetuner(cfg, model, tile_size=tile_size(drawn), **kw)
            seen, metrics = [], []
            recording_steps(trainer, "train_step", seen, metrics)
            threads = threading.active_count()
            with loader_prefetch(prefetch):
                hist = trainer.fit(train, val, epochs=1, max_steps=hsteps,
                                   tracker=QuietTracker(), save_checkpoints=False)
            runs.append((prefetch, trainer, hist, seen, [float(m["loss"]) for m in metrics],
                         threads_back(threads)))
        n_train = len(train)
        _, first, h_first, _, losses, _ = runs[0]
        for prefetch, trainer, hist, seen, o_losses, back in runs[1:]:
            diff = states_equal(first.state, trainer.state)
            check(not h_first["device_store"] and not hist["device_store"]
                  and len(losses) == len(o_losses) == hsteps and losses == o_losses
                  and all(math.isfinite(v) for v in losses) and not diff
                  and all(c == per_step["recipe"] for c in seen),
                  f"drivers: houston2018 random patches streamed (batch {hc.batch_size}, bf16, "
                  f"{hsteps} of the epoch's {-(-n_train // hc.batch_size)} steps): prefetch "
                  f"{prefetch} == the first run's prefetch {order[0]} bit for bit: per-step "
                  f"losses (last {losses[-1]:.4f}), parameters, Adam moments, the generator "
                  f"(differ: {diff[:6] or 'none'}); each step launching {per_step['recipe']}")
        backs = [back for prefetch, *_, back in runs if prefetch]
        check(all(0 <= back <= 1.0 for back in backs),
              f"drivers: the max_steps break at step {hsteps} mid-epoch with prefetch 2 left no "
              f"producer: threading.active_count() back to its count before fit in "
              f"{', '.join(f'{back:.3f}' for back in backs)} s (limit 1 s)")
        rates = [(prefetch, hist["throughput"]["steps_per_s"]) for prefetch, _, hist, *_ in runs]
        out["steps_per_s"]["houston_random"] = {
            k: [r for p, r in rates if p == k] for k in (2, 0)}
        print(f"     houston2018 random patches streamed: "
              + ", ".join(f"prefetch {p} {r:.2f}" for p, r in rates)
              + f" steps/s in that order ({hsteps} steps each, one synchronize at the end, "
              f"batch {hc.batch_size}) on {card}", flush=True)
        del runs, first, trainer, model, scene, gt, drawn
        torch.cuda.empty_cache()

        # --- (c) the pretraining driver: a JSONL Tracker and log_grad_norm ---
        models = os.path.join(tmp, "models")
        raw_norms: list = []
        clamp = pretrainer_mod.clamp_gradients_

        def recording_clamp(params, bound):
            """The raw gradients' global norm in fp64 on the host, then the
            trainer's clamp."""
            params = list(params)
            norms = [torch.linalg.vector_norm(q.grad.double()) for q in params
                     if q.grad is not None]
            raw_norms.append(float(torch.linalg.vector_norm(torch.stack(norms))))
            clamp(params, bound)

        keys = {"epoch", "loss", "lr", "steps_per_sec", "items_per_sec",
                "items_per_sec_per_chip", "grad_norm"}
        for dtype_flag, steps in (("bf16", 20), ("fp32", 10)):
            jsonl = os.path.join(tmp, f"pretrain_{dtype_flag}.jsonl")
            argv = ["--synthetic", "--synthetic-tiles", str(10 * TRAIN_BATCH), "--steps",
                    str(steps), "--log-grad-norm", "--jsonl", jsonl, "--models-dir",
                    os.path.join(models, f"pretrain_{dtype_flag}")]
            if dtype_flag == "fp32":
                argv.append("--fp32")
            # fp32 takes the FMA form of the layer backward, weight gradients included
            want = dict(per_step["pretrain"], **({"layer_wgrad": 0} if dtype_flag == "fp32"
                                                   else {}))
            seen, metrics = [], []
            raw_norms.clear()
            pretrainer_mod.clamp_gradients_ = recording_clamp
            t0 = time.perf_counter()
            try:
                with class_recording(Pretrainer, "train_step_idx", seen, metrics):
                    run_quietly(os.path.join(tmp, f"pretrain_{dtype_flag}.log"),
                                pretrain_driver.main, argv)
            finally:
                pretrainer_mod.clamp_gradients_ = clamp
            with open(jsonl) as f:
                rows = [json.loads(line) for line in f]
            bounds = [r for r in rows if "lr" in r]
            norms = [float(m["grad_norm"]) for m in metrics]
            rel = max(abs(a - b) / b for a, b in zip(norms, raw_norms))
            freq = 10
            window_ok = all(
                r["grad_norm"] == float(torch.stack([m["grad_norm"] for m in
                                                     metrics[r["step"] - freq : r["step"]]])
                                        .float().mean())
                for r in bounds)
            check(len(seen) == steps and all(c == want for c in seen)
                  and [r["step"] for r in bounds] == list(range(freq, steps + 1, freq))
                  and all(set(r) - {"step"} == keys for r in bounds)
                  and all(math.isfinite(r["grad_norm"]) and r["grad_norm"] > 0 for r in bounds)
                  and window_ok and len(raw_norms) == steps and rel <= 1e-6,
                  f"drivers: pretrain driver ({dtype_flag}, {steps} steps, --log-grad-norm, "
                  f"--jsonl): each step launching {want}; boundary "
                  f"rows at steps {[r['step'] for r in bounds]} with the keys {sorted(keys)}; "
                  f"grad_norm {[round(r['grad_norm'], 6) for r in bounds]} finite, > 0, each "
                  f"the mean of its window's per-step norms; every step's norm vs the fp64 norm "
                  f"of that step's .grads before the clamp: max rel {rel:.2e} <= 1e-6 "
                  f"({time.perf_counter() - t0:.1f} s); other rows "
                  f"{[(r['step'], sorted(set(r) - {'step'})) for r in rows if 'lr' not in r]}")
        pre_ckpt = glob.glob(os.path.join(models, "pretrain_bf16", "*",
                                          "model_ViTSpatialSpectral_at_step20.pt"))
        check(len(pre_ckpt) == 1, f"drivers: the pretrain driver wrote {pre_ckpt}")
        torch.cuda.empty_cache()

        # --- (d) the sweep driver from that pretraining checkpoint -----------
        captured: dict = {}
        fit = Finetuner.fit

        def spy_fit(self, *args, **kwargs):
            captured["trainer"] = self
            captured["start"] = {k: v.detach().clone() for k, v in self.model.state_dict().items()}
            return fit(self, *args, **kwargs)

        seen, metrics = [], []
        argv = ["enmap", "--synthetic", "--steps", "20", "--set", "lr=0.001",
                "--set", "linear_eval=false", "--set", f"checkpoint_path={pre_ckpt[0]}",
                "--set", "spectral_pos_embed=false",
                "--models-dir", os.path.join(models, "sweep")]
        Finetuner.fit = spy_fit
        t0 = time.perf_counter()
        try:
            with class_recording(Finetuner, "train_step_idx", seen, metrics):
                _, lines = run_quietly(os.path.join(tmp, "sweep.log"), finetune_sweep.main, argv)
        finally:
            Finetuner.fit = fit
        trainer = captured["trainer"]
        start, ckpt = captured["start"], restore_params(pre_ckpt[0], "cuda")
        carried = ("pos_embedding", "to_patch_embedding.blockwise_kernel")
        fresh_model, _ = build_finetune_model(trainer.config, device="cpu")
        fresh = fresh_model.state_dict()
        head_fresh = all(torch.equal(start[k].cpu(), fresh[k]) for k in
                         ("head_linear.weight", "head_linear.bias"))
        rows = [line for line in lines if line.startswith("[enmap-simmim-downstream] step")]
        cfg = trainer.config
        check(all(torch.equal(start[k], ckpt[f"encoder.{k}"]) for k in carried) and head_fresh
              and cfg.lr == 0.001 and cfg.linear_eval is False and cfg.spectral_pos_embed is False
              and len(seen) == 20 and all(c == per_step["recipe"] for c in seen)
              and all(math.isfinite(float(m["loss"])) for m in metrics)
              and any(line.startswith("best val acc:") for line in lines) and len(rows) == 2,
              f"drivers: finetune_sweep enmap --synthetic --steps 20 --set lr=0.001 --set "
              f"linear_eval=false --set spectral_pos_embed=false --set checkpoint_path=<(c)'s "
              f".pt>: {', '.join(carried)} equal the checkpoint's bit for bit, head_linear "
              f"fresh (a seeded model's); each of {len(seen)} steps launching phase 3's "
              f"{per_step['recipe']}; {len(rows)} tracker rows, e.g. '{rows[-1] if rows else ''}'; "
              f"{time.perf_counter() - t0:.1f} s")
        ft_ckpt = glob.glob(os.path.join(models, "sweep", "*", "ViTSpatialSpectral_at_step20.pt"))
        check(len(ft_ckpt) == 1, f"drivers: the sweep driver wrote {ft_ckpt}")
        del trainer, captured, fresh_model
        torch.cuda.empty_cache()

        # --- (e) the inference example from the sweep's checkpoint -----------
        tiles = 8
        before = launch_counts()
        t0 = time.perf_counter()
        result, lines = run_quietly(os.path.join(tmp, "inference.log"), inference_example.main,
                                    ["--synthetic", "--tiles", str(tiles), "--checkpoint",
                                     ft_ckpt[0]])
        after = launch_counts()
        out["counts"] = launch_counts()  # the main path ends here
        used = {n: after[n] - before[n] for n in after}
        model, config = result["model"], result["config"]
        depth = config.transformer_depth
        want = {n: 0 for n in used}
        want.update(fused_layer_fwd=2 * depth * tiles, fused_embed_fwd=tiles)
        state = model.state_dict()
        trained = restore_params(ft_ckpt[0], "cuda")
        fresh_model, _ = build_finetune_model(config, device="cpu")
        fresh = fresh_model.state_dict()
        carried = [k for k in state if k in trained and not k.startswith("head_linear.")]
        kept = sorted(k for k in state if k not in carried)
        check(used == want and result["windows"].shape[0] == tiles * 64
              and all(torch.equal(state[k], trained[k]) for k in carried)
              and all(torch.equal(state[k].cpu(), fresh[k]) for k in kept)
              and any(line.startswith(f"mean tile accuracy over {tiles} tiles") for line in lines),
              f"drivers: inference_example --synthetic --tiles {tiles} --checkpoint <(d)'s .pt> "
              f"(fp32): launches {used} == {want} ({tiles} window batches of 64, one a tile); "
              f"{len(carried)} tensors equal to the checkpoint's, fresh as a seeded model (the "
              f"loader's head surgery; the recipe's sin-cos tables where the sweep learned "
              f"positions): {kept}; '{lines[-1]}' ({time.perf_counter() - t0:.1f} s)")
        windows = result["windows"]
        logits = Predictor(model, batch_size=64)(windows)
        ref = Predictor(copy.deepcopy(model), batch_size=64, device="cpu")(windows)
        err = float((np.abs(logits - ref) / np.maximum(1.0, np.abs(ref))).max())
        top2 = np.sort(ref, axis=1)[:, -2:]
        margin = top2[:, 1] - top2[:, 0]
        sure = margin > 1e-3
        same = result["preds"] == ref.argmax(axis=1)
        check(err <= TOL_MODEL["float32"] and bool(same[sure].all()),
              f"drivers: the example's fp32 logits on the card vs the same model's plain "
              f"versions on the CPU: max|d|/max(1,|ref|) {err:.3e} <= "
              f"{TOL_MODEL['float32']:.0e}; its argmax equal at all {int(sure.sum())} of "
              f"{sure.size} pixels whose top-2 margin exceeds 1e-3 "
              f"({int((~same).sum())} differ in all)")
        out["drop_launches"] = dropout_sample.launches - drop_before
        del model, result, fresh_model
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for name, n in out["counts"].items():
        check(n > 0, f"drivers path: {name} launched {n} times")
    check(out["drop_launches"] == 0,
          f"drivers path: dropout_sample launched {out['drop_launches']} times (a check-path "
          "kernel)")
    return out


PRE_CONFIGS = ["configs/pretrain_config.yaml", "configs/config.yaml"]
FINE_CONFIGS = ["configs/finetune_config_enmap.yaml", "configs/config.yaml"]


def ranks_equal(ranks: list, name: str) -> bool:
    """The ranks' parameters, gradients and full train states equal bit for
    bit after every step of case ``name`` (their digests)."""
    keys = ("params_digest", "grads_digest", "state_digest")
    got = [[tuple(s[k] for k in keys) for s in r[name]["steps"]] for r in ranks]
    return all(g == got[0] for g in got)


def dp_hold_steps(label: str, name: str, ranks: list, arrays: dict, one: tuple, dtype: str,
                  lr_of, same_launches: bool = True, ref32=None) -> None:
    """Case ``name`` of the ranks against its one-process run: each step's
    loss relative to |one| within TOL_LOSS, its metrics within TOL_METRIC
    and its launches equal; each gradient relative to its max |one| within
    TOL_STEP and the parameters within 1e-2 x lr but for at most 0.5 % of
    the elements (a weight whose gradient is near zero takes Adam's full
    step either way: at most 2 x lr), at every step in fp32 and at the
    first in bf16. Later bf16 steps start from parameters that differ by
    that first step's roundings, which TOL_STEP was not set for: their
    distances are printed. ``same_launches=False``: the ranks take another
    route (the head-split layer), whose launches are checked apart.
    ``ref32``, the one-process run of the same case in fp32, for a bf16
    step on another route (the head-split layer's PyTorch products against
    the kernels): a leaf above TOL_STEP is held instead by its distance from
    that fp32 step, no further than NEARER_FP32 x the one-process bf16
    step's (phase 5's rule: the L1's sign flips land whole in d
    pos_embedding), and the parameters are printed, not held (Adam's first
    step turns a gradient's bf16-level difference near zero into up to
    2 x lr)."""
    scalars, ref = one
    for r, rank in enumerate(ranks):
        for k, (got, want) in enumerate(zip(rank[name]["steps"], scalars["steps"]), 1):
            rel = abs(got["loss"] - want["loss"]) / abs(want["loss"])
            metrics = {m: abs(got[m] - want[m]) for m in ("acc", "macro_acc") if m in want}
            launches = not same_launches or got["launches"] == want["launches"]
            check(rel <= TOL_LOSS[dtype] and all(v <= TOL_METRIC[dtype] for v in metrics.values())
                  and launches,
                  f"{label} rank {r} step {k}: loss {got['loss']:.8e} vs one process "
                  f"{want['loss']:.8e} (rel {rel:.3e} <= {TOL_LOSS[dtype]:.0e}), metrics "
                  f"|d| {metrics} <= {TOL_METRIC[dtype]:.0e}"
                  + (f", launches {got['launches']} == one process's" if same_launches else ""))
    steps = len(scalars["steps"])
    held = steps if dtype == "float32" else 1
    for k in range(1, steps + 1):
        grads = {n[len(f"{name}/grads{k}/"):]: v for n, v in ref.items()
                 if n.startswith(f"{name}/grads{k}/")}
        errs = {n: float(np.abs(arrays[f"{name}/grads{k}/{n}"] - v).max()
                         / max(float(np.abs(v).max()), 1e-30)) for n, v in grads.items()}
        worst = max(errs, key=errs.get)
        far, total, worst_lr = 0, 0, 0.0
        for n, v in ref.items():
            if not n.startswith(f"{name}/params{k}/"):
                continue
            lr = lr_of(n.split("/", 2)[2])
            d = np.abs(arrays[n] - v) / lr
            far += int((d > 1e-2).sum())
            total += d.size
            worst_lr = max(worst_lr, float(d.max()))
        msg = (f"{label} step {k}: each of {len(errs)} gradients vs one process, worst {worst} "
               f"max|d|/max|ref| {errs[worst]:.3e}; parameters: {far} of {total} elements "
               f"beyond 1e-2 x lr, worst {worst_lr:.3e} x lr")
        if k <= held and ref32 is not None:
            over = {n: e for n, e in errs.items() if e > TOL_STEP[dtype]}
            for n, e in over.items():
                w32 = ref32[1][f"{name}/grads{k}/{n}"]
                scale = max(float(np.abs(w32).max()), 1e-30)
                k32 = float(np.abs(arrays[f"{name}/grads{k}/{n}"] - w32).max()) / scale
                p32 = max(float(np.abs(grads[n] - w32).max()) / scale, 1e-30)
                check(k32 <= NEARER_FP32 * p32,
                      f"{label} step {k}: {n} reads {e:.3e} vs one process (> "
                      f"{TOL_STEP[dtype]:.1e}); from the fp32 one-process step it reads "
                      f"{k32:.3e} <= {NEARER_FP32} x the bf16 one-process step's {p32:.3e}")
            rest = max((e for n, e in errs.items() if n not in over), default=0.0)
            check(rest <= TOL_STEP[dtype],
                  f"{msg}; {len(errs) - len(over)} gradients <= {TOL_STEP[dtype]:.1e} (worst "
                  f"{rest:.3e}), {len(over)} held by the fp32 step above; parameters printed")
        elif k <= held:
            check(errs[worst] <= TOL_STEP[dtype] and far <= 5e-3 * total and worst_lr <= 2.0,
                  f"{msg} (<= {TOL_STEP[dtype]:.1e}, 0.5 %, 2)")
        else:
            print(f"     {msg} (printed: a later bf16 step)", flush=True)


def phase_data_parallel(card: str, per_step: dict):
    """Phase 9, data-parallel training (parallel/mesh.py) through
    tools/dist_worker.py: two ranks on the one card over Gloo against the
    one-process runs of the same cases in this process, NCCL at
    min(device_count, 2), and the pretraining driver under torchrun."""
    import subprocess

    import torch

    from maskedsst_tpu_torch.config import get_finetune_config, get_pretrain_config
    from maskedsst_tpu_torch.data.synthetic import SyntheticCubeDataset
    from maskedsst_tpu_torch.models.layers import fold_rank_seed
    from maskedsst_tpu_torch.parallel.mesh import DataWorld
    from maskedsst_tpu_torch.tools import dist_worker
    from maskedsst_tpu_torch.train.checkpoint import restore_params
    from maskedsst_tpu_torch.train.pretrainer import Pretrainer

    tmp = tempfile.mkdtemp(prefix="chip_smoke_dp_")
    out: dict = {}
    pcfg = get_pretrain_config(*PRE_CONFIGS, seed=SEED)
    fcfg = get_finetune_config(*FINE_CONFIGS, seed=SEED)
    try:
        # one batch of seeded tiles on each store, shuffled anew at every step
        store = dict(tiles=TRAIN_BATCH, seed=SEED)
        no_dropout = dict(seed=SEED, transformer_dropout=0.0)
        pre = dict(kind="pretrain", configs=PRE_CONFIGS, store=store, steps=3, arrays=True,
                   timed=10)
        fine = dict(kind="finetune", configs=FINE_CONFIGS, dtype="bfloat16")
        cases = [
            # (a) the recipe at dropout 0, bf16 and fp32 (TF32 off)
            dict(pre, name="pre_bf16", dtype="bfloat16", set=no_dropout),
            dict(pre, name="pre_fp32", dtype="float32", set=no_dropout, timed=0),
            # (b) the recipe's dropout 0.1; the finetune recipe's embedding dropout
            dict(pre, name="pre_dropout", dtype="bfloat16", set=dict(seed=SEED), arrays=False,
                 record_seeds=True, timed=0),
            dict(fine, name="fine_emb_dropout", set=dict(seed=SEED, batch_size=TRAIN_BATCH),
                 store=dict(store, batches=[TRAIN_BATCH]), steps=1, record_emb_keep=True,
                 all_ranks_arrays=True),
            # (c) index batches of 63 (a pad index), 64 and 61 rows; validation at 31
            dict(fine, name="fine_pad", arrays=True, steps=3, val_batch=31,
                 set=dict(seed=SEED, batch_size=TRAIN_BATCH, transformer_dropout=0.0,
                          transformer_emb_dropout=0.0),
                 store=dict(store, batches=[63, 64, 61])),
        ]
        world1 = DataWorld(device=torch.device("cuda", 0))
        one = {c["name"]: dist_worker.run_case(dict(c, out=tmp), world1, {}) for c in cases}
        # (d) a one-process checkpoint for the ranks to resume; 160 tiles: 144
        # train tiles, 2 steps an epoch
        resume_tiles = 160
        data = SyntheticCubeDataset(num_tiles=resume_tiles, n_bands=pcfg.n_bands, labeled=False,
                                    seed=SEED)
        Pretrainer(pcfg.copy(), dtype=torch.bfloat16, device="cuda").fit(
            data, max_steps=3, tracker=QuietTracker("w1"), models_dir=os.path.join(tmp, "w1"))
        from_path = os.path.join(tmp, "w1", "w1", f"model_{pcfg.encoder_name}_at_step3.pt")
        cases.append(dict(kind="pretrain_resume", name="resume", configs=PRE_CONFIGS,
                          dtype="bfloat16", set=dict(seed=SEED), tiles=resume_tiles,
                          data_seed=SEED, steps=5, stop=3, **{"from": from_path}))
        torch.cuda.empty_cache()

        # --- the main path: two ranks on the one card over gloo, counted ---------
        spec = dict(out=os.path.join(tmp, "gloo"), device="cuda", backend="gloo", cases=cases)
        t0 = time.perf_counter()
        results = dist_worker.launch(spec, 2, timeout_s=600)
        ranks = [r["cases"] for r in results]
        arrays = dist_worker.load_arrays(spec["out"])
        print(f"     data-parallel: 2 ranks over gloo on {[r['device'] for r in results]} ran "
              f"{len(cases)} cases in {time.perf_counter() - t0:.1f} s (both processes' "
              "start-up and CUDA set-up included)", flush=True)

        # (a) bf16 and fp32 against one process; every rank's launches
        for name, dtype in (("pre_bf16", "bfloat16"), ("pre_fp32", "float32")):
            check(ranks_equal(ranks, name),
                  f"data-parallel {name}: the 2 ranks' parameters, gradients and train "
                  "states equal bit for bit after each of 3 steps")
            dp_hold_steps(f"data-parallel {name}", name, ranks, arrays, one[name], dtype,
                          lambda n: pcfg.lr)
        out["launches"] = [{n: sum(s["launches"][n] for s in r["pre_bf16"]["steps"])
                            for n in per_step["pretrain"]} for r in ranks]
        check(all(s["launches"] == per_step["pretrain"] for r in ranks
                  for s in r["pre_bf16"]["steps"]),
              f"data-parallel pre_bf16: each rank launched phase 4's {per_step['pretrain']} at "
              f"every step (ranks' totals {out['launches']})")
        for r, got in enumerate(out["launches"]):
            for n, v in got.items():
                check(v > 0, f"data-parallel path rank {r}: {n} launched {v} times")
        one_rate = one["pre_bf16"][0]["steps_per_s"]
        for r, rank in enumerate(ranks):
            print(f"     data-parallel pretraining bf16, rank {r} of 2 sharing the card over "
                  f"gloo: {rank['pre_bf16']['steps_per_s']:.3f} steps/s of the global batch "
                  f"{TRAIN_BATCH} (32 rows a rank; one process: {one_rate:.3f} steps/s; 10 "
                  f"steps, host clock, synchronized; not a scaling figure) on {card}",
                  flush=True)

        # (b) dropout 0.1: seeds folded as in JAX, rank 0's embedding dropout
        seeds = [r["pre_dropout"]["seeds"] for r in ranks]
        check(ranks_equal(ranks, "pre_dropout") and seeds[0] == one["pre_dropout"][0]["seeds"]
              and seeds[1] == [fold_rank_seed(v, 1) for v in seeds[0]] != seeds[0]
              and all(math.isfinite(s["loss"]) for r in ranks for s in r["pre_dropout"]["steps"]),
              f"data-parallel dropout 0.1: ranks equal bit for bit, {len(seeds[0])} layer seeds "
              "of rank 0 the one process's, rank 1's folded by + 668265261 (int32 wrap), "
              "losses finite")
        want = one["fine_emb_dropout"][1]["fine_emb_dropout/emb_keep1"]
        keeps = [dist_worker.load_arrays(spec["out"], r)["fine_emb_dropout/emb_keep1"]
                 for r in range(2)]
        check(all(np.array_equal(got, want[r * len(got) : (r + 1) * len(got)])
                  and 2 * len(got) == len(want) for r, got in enumerate(keeps))
              and ranks_equal(ranks, "fine_emb_dropout"),
              f"data-parallel embedding dropout 0.1: rank 0's keep mask {keeps[0].shape} equals "
              f"the first half of the one-process draw {want.shape}, rank 1's the second "
              f"({keeps[0].mean():.4f} kept)")

        # (c) finetuning from the store with padded batches
        check(ranks_equal(ranks, "fine_pad"),
              "data-parallel fine_pad: ranks equal bit for bit after each of 3 steps")
        dp_hold_steps("data-parallel fine_pad", "fine_pad", ranks, arrays, one["fine_pad"],
                      "bfloat16", lambda n: fcfg.mlp_head_lr if n.startswith("head_")
                      else fcfg.lr)
        vals = [r["fine_pad"]["val"] for r in ranks]
        want = one["fine_pad"][0]["val"]
        check(all(abs(v[m] - want[m]) <= TOL_METRIC["bfloat16"] for v in vals
                  for m in ("acc", "macro_acc"))
              and all(abs(v["loss"] - want["loss"]) <= TOL_LOSS["bfloat16"] * abs(want["loss"])
                      for v in vals) and vals[0] == vals[1],
              f"data-parallel fine_pad validation (batches of 31, padded to 32): {vals} vs one "
              f"process {want}")

        # (d) checkpoints: rank 0 writes; resumes bit for bit; across world sizes
        r0, r1 = ranks[0]["resume"], ranks[1]["resume"]
        check(r1["files"] == [] and any(f.endswith("_at_step3.pt") for f in r0["files"])
              and not r1["jsonl"] and r0["jsonl"],
              f"data-parallel checkpoints: rank 0 wrote {len(r0['files'])} files, rank 1 "
              f"{len(r1['files'])}; tracker JSONL on rank 0 {r0['jsonl']}, rank 1 {r1['jsonl']}")
        check(r0["resumed"] == r0["control"] and r1["resumed"] == r1["control"]
              and r0["control"] == r1["control"] and r0["from"] == r1["from"]
              and r0["from_step"] == 5,
              "data-parallel resume: 2 ranks resumed at step 3 == their uninterrupted control "
              "at step 5, bit for bit; a one-process checkpoint resumed by 2 ranks to step 5")
        single = Pretrainer(pcfg.copy(), dtype=torch.bfloat16, device="cuda")
        at = single.resume(r0["checkpoint"])
        same = all(torch.equal(single.model.state_dict()[n], v)
                   for n, v in restore_params(r0["checkpoint"], "cuda").items())
        loss = float(single.train_step(np.stack([data[i]["img"] for i in range(TRAIN_BATCH)]))
                     ["loss"])
        check(at == 3 and same and math.isfinite(loss),
              f"data-parallel checkpoint in one process: resumed at step {at}, parameters equal "
              f"to the file's, a step's loss {loss:.6e} finite")
        del single
        torch.cuda.empty_cache()

        # --- (e) NCCL at world size min(device_count, 2) -------------------------
        size = min(torch.cuda.device_count(), 2)
        nccl = dict(pre, name="nccl", dtype="bfloat16", set=no_dropout, arrays=False, timed=20)
        spec = dict(out=os.path.join(tmp, "nccl"), device="cuda", backend="nccl",
                    cases=[nccl, dict(nccl, name="no_group", no_group=True)])
        results = dist_worker.launch(spec, size, timeout_s=300)
        for r, res in enumerate(results):
            a, b = res["cases"]["nccl"], res["cases"]["no_group"]
            same = [s["state_digest"] for s in a["steps"]] == [s["state_digest"]
                                                             for s in b["steps"]]
            check(same if size == 1 else ranks_equal([x["cases"] for x in results], "nccl"),
                  f"data-parallel nccl at world size {size}, rank {r}: the step "
                  + ("bit-equal to the step without a process group" if size == 1
                     else "bit-equal across ranks"))
            print(f"     data-parallel nccl, world size {size}, rank {r}: {a['steps_per_s']:.3f} "
                  f"steps/s vs {b['steps_per_s']:.3f} without a process group (bf16, batch "
                  f"{TRAIN_BATCH}, 20 steps, host clock, synchronized) on {card}", flush=True)
        out["nccl_size"] = size

        # --- (f) the pretraining driver under torchrun ---------------------------
        models = os.path.join(tmp, "driver")
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc_per_node", "2", "-m", "maskedsst_tpu_torch.pretrain", "--synthetic",
               "--synthetic-tiles", "160", "--steps", "3", "--dist-backend", "gloo",
               "--models-dir", models]
        t0 = time.perf_counter()
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        log = res.stdout + res.stderr
        # 144 train tiles: 2 steps an epoch, so the epoch-0 save and the break's
        pts = sorted(os.path.relpath(os.path.join(d, f), models) for d, _, fs in os.walk(models)
                     for f in fs if f.endswith(".pt"))
        want = [f"model_{pcfg.encoder_name}_at_step3.pt", f"model_{pcfg.encoder_name}_ep0.pt"]
        check(res.returncode == 0 and "multihost: process 0/2" in log
              and "multihost: process 1/2" in log and len({os.path.dirname(p) for p in pts}) == 1
              and [os.path.basename(p) for p in pts] == want,
              f"data-parallel driver under torchrun --nproc_per_node 2 (gloo, 3 synthetic "
              f"steps): exit {res.returncode} in {time.perf_counter() - t0:.1f} s, both ranks' "
              f"lines, checkpoints written {pts}" + ("" if res.returncode == 0 else
                                                     "\n" + log[-3000:]))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def count_steps(step, steps: int) -> tuple:
    """Runs ``step`` (k → loss) ``steps`` times: (the losses, the distinct
    per-step launch counts)."""
    import torch

    losses, seen = [], []
    for k in range(steps):
        before = launch_counts()
        losses.append(float(step(k)))
        torch.cuda.synchronize()
        after = launch_counts()
        per_step = {n: after[n] - before[n] for n in after}
        if per_step not in seen:
            seen.append(per_step)
    return losses, seen


def launches_want(fwd=0, bwd=0, wgrad=0) -> dict:
    """A path's launch counts: the layer kernels' and none of #3-#6."""
    return {"fused_layer_fwd": fwd, "fused_layer_bwd": bwd, "layer_wgrad": wgrad,
            "fused_embed_fwd": 0, "fused_embed_bwd": 0, "fused_simmim_fwd": 0,
            "fused_simmim_bwd": 0}


def hold_step(label: str, name: str, step_grads_fn, tol_loss: float, ref32=None) -> dict:
    """One step's loss and gradients (``step_grads_fn(seed)`` → (loss,
    grads)) against the same step through the plain versions on the card,
    the step with other dropout masks printed beside the limit. With
    ``ref32``, the fp32 plain step's gradients on the same inputs, a bf16
    leaf above TOL_STEP is held instead by its distance from that step, as
    phase 5 holds Houston2018's step on fresh weights (NEARER_FP32: d
    pos_embedding sums every sample's tokens and takes whole the L1's sign
    flips that one bf16 rounding makes). Returns the plain step's
    gradients."""
    loss_k, g_k = step_grads_fn(77)
    with plain_versions():
        loss_p, g_p = step_grads_fn(77)
        _, g_f = step_grads_fn(78)
    errs = {n: rel_to_max(g_k[n], ref) for n, ref in g_p.items()}
    faults = sorted(rel_to_max(g_f[n], ref) for n, ref in g_p.items())
    check(abs(loss_k - loss_p) <= tol_loss * abs(loss_p),
          f"{label} {name} step: loss {loss_k:.8e} vs plain {loss_p:.8e} (rel "
          f"{abs(loss_k - loss_p) / abs(loss_p):.3e} <= {tol_loss:.0e})")
    over = {}
    if ref32 is not None:
        over = {n: e for n, e in errs.items() if e > TOL_STEP[name]}
    for n, e in over.items():
        k32, p32 = rel_to_max(g_k[n], ref32[n]), max(rel_to_max(g_p[n], ref32[n]), 1e-30)
        check(k32 <= NEARER_FP32 * p32,
              f"{label} {name} step: {n} reads {e:.3e} vs the plain bf16 step (> "
              f"{TOL_STEP[name]:.1e}); from the fp32 plain step the kernels read {k32:.3e} <= "
              f"{NEARER_FP32} x the plain bf16 step's {p32:.3e}")
    held = {n: e for n, e in errs.items() if n not in over}
    worst = max(held, key=held.get)
    check(held[worst] <= TOL_STEP[name],
          f"{label} {name} step: {len(held)} of {len(errs)} gradients vs plain versions on the "
          f"card, worst {worst} max|d|/max|ref| {held[worst]:.3e} <= {TOL_STEP[name]:.1e}; "
          f"{len(over)} held by the fp32 step above (other dropout masks read "
          f"{faults[-1]:.3e} at worst, {faults[len(faults) // 2]:.3e} median, "
          f"{sum(v > TOL_STEP[name] for v in faults)} leaves above the limit)")
    return g_p


def steps_per_s(step, card: str, label: str, batch: int = TRAIN_BATCH) -> float:
    """Median of 7 synchronized steps after 2 warm-up ones, with a profile."""
    import torch

    for _ in range(2):
        step()
    torch.cuda.synchronize()
    walls = []
    for _ in range(7):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    step_s = statistics.median(walls)
    prof = profile_step(step)
    if prof:
        print(f"     profile {label}: {prof['device_ms_per_step']:.2f} ms of device time in a "
              f"{prof['wall_ms_per_step']:.2f} ms step (busy {prof['busy_share']:.1%}); by "
              "kernel: " + ", ".join(f"{g} {ms:.3f} ms"
                                     for g, ms in prof["groups_ms_per_step"].items()), flush=True)
    else:
        print(f"     profile {label}: the profiler recorded no device time (not measured)",
              flush=True)
    print(f"     {label}: {1 / step_s:.3f} steps/s, {batch / step_s:.1f} cubes/s (batch {batch}, "
          f"median of 7 steps) on {card}", flush=True)
    return 1 / step_s


def phase_other_models(card: str, gen):
    """Phase 10: the other ViT models and SimMIM options at the repo's full
    widths: (a) the layer kernels at S = 65 (ViTRGB's cls-token sequence);
    (b) ViTRGB serving and (c) finetuning on the EnMAP-DFC config; (d)
    EnMAP pretraining with PatchEmbed and the shared decoder; (e) SimMIM
    over ViTSpatialSpectralV1 with intermediate_losses; (f) the legacy
    SimMIM over ViTRGB. Returns the kernels' cases at S = 65 and each
    path's launches."""
    import torch

    from maskedsst_tpu_torch.config import get_finetune_config, get_pretrain_config
    from maskedsst_tpu_torch.data.device_store import DeviceTileStore, IndexBatcher
    from maskedsst_tpu_torch.data.pipeline import DataLoader, split_dataset
    from maskedsst_tpu_torch.data.synthetic import SyntheticCubeDataset
    from maskedsst_tpu_torch.models import (
        SimMIM,
        SimMIMSpatialSpectral,
        ViTRGB,
        ViTSpatialSpectralV1,
    )
    from maskedsst_tpu_torch.ops import fused_layer
    from maskedsst_tpu_torch.serve import Predictor
    from maskedsst_tpu_torch.train.factory import build_finetune_model
    from maskedsst_tpu_torch.train.finetuner import Finetuner
    from maskedsst_tpu_torch.train.pretrainer import Pretrainer

    out = {"launches": {}}
    # --- (a) the layer kernels at S = 65 --------------------------------------
    for form in ("fwd", "bwd", "rows"):
        plan = fused_layer.launch_plan(form, 65, 96, 64, 64, "cuda")
        check(plan.shared_bytes <= plan.limit,
              f"layer plan at S 65, {fused_layer.FORMS[form]}: level {plan.level}, "
              f"{plan.shared_bytes} shared bytes a block <= the card's {plan.limit}, "
              f"{plan.scratch_bytes} bytes of device scratch a block")
    fwd_cases = phase_layer(gen, (("vit_rgb", BATCH, 65),))
    bwd_cases, train_fwd_cases, wgrad_cases = phase_layer_bwd(
        gen, (("vit_rgb", TRAIN_BATCH, 65, ("float32", "bfloat16")),))
    out["cases"] = (fwd_cases + train_fwd_cases, bwd_cases, wgrad_cases)

    base = get_finetune_config("configs/finetune_config_enmap.yaml", "configs/config.yaml",
                               seed=SEED)
    base.method_name = "ViTRGB"
    depth = base.transformer_depth

    # --- (b) ViTRGB serving -----------------------------------------------------
    rng = np.random.default_rng(SEED + 10)
    requests = {n: rng.standard_normal((n, base.n_bands, 8, 8)).astype(np.float32)
                for n in REQUESTS}
    batches = sum(math.ceil(n / BATCH) for n in REQUESTS)
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[1]
        model, kw = build_finetune_model(base, dtype=dtype, device="cuda")
        check(isinstance(model, ViTRGB) and kw == {} and model.pixelwise,
              f"vit_rgb {name}: the factory builds ViTRGB per pixel, no trainer flags")
        pred = Predictor(model, batch_size=BATCH)
        reset_counts()
        outs = {n: pred(x) for n, x in requests.items()}
        torch.cuda.synchronize()
        counts = launch_counts()
        out["launches"][f"vit_rgb_serving_{name}"] = counts
        want = launches_want(fwd=depth * batches)
        check(counts == want, f"vit_rgb serving {name}: launches {counts} == {want} "
                              f"({depth} layer forwards a batch, no embed or SimMIM kernel)")
        for n, o in outs.items():
            check(o.shape == (n, base.n_classes, 8, 8) and bool(np.isfinite(o).all()),
                  f"vit_rgb serving {name}: N={n} -> shape {o.shape}, finite")
        with plain_versions():
            refs = {n: pred(x) for n, x in requests.items() if n}
        for n, ref in refs.items():
            diff = np.abs(outs[n] - ref)
            err = float((diff / np.maximum(1.0, np.abs(ref))).max())
            check(err <= TOL_MODEL[name],
                  f"vit_rgb serving {name}: N={n} logits vs plain versions on the card: max|d| "
                  f"{float(diff.max()):.3e}, max|d|/max(1,|ref|) {err:.3e} <= "
                  f"{TOL_MODEL[name]:.0e}")
        x = rng.standard_normal((8 * BATCH, base.n_bands, 8, 8)).astype(np.float32)
        pred(x)
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            pred(x)
            walls.append(time.perf_counter() - t0)
        print(f"     vit_rgb serving {name}: {x.shape[0] / statistics.median(walls):.1f} cubes/s "
              f"(N={x.shape[0]}, batch {BATCH}, median of 3, host clock incl. transfers) on "
              f"{card}", flush=True)
        del model, pred
        torch.cuda.empty_cache()

    # --- (c) ViTRGB finetuning (dropout 0.1, embedding dropout 0.1) -----------
    data = SyntheticCubeDataset(num_tiles=TRAIN_BATCH, n_bands=base.n_bands,
                                n_classes=base.n_classes, seed=SEED)
    tiles = next(iter(DataLoader(data, TRAIN_BATCH, shuffle=False)))

    def finetuner(dtype, batch=TRAIN_BATCH):
        cfg = base.copy()
        cfg.batch_size = batch
        model, kw = build_finetune_model(cfg, dtype=dtype, device="cuda")
        return Finetuner(cfg, model, **kw)

    for dtype, want in ((torch.bfloat16, launches_want(depth, depth, depth)),
                        (torch.float32, launches_want(depth, depth, 0))):
        name = str(dtype).split(".")[1]
        trainer = finetuner(dtype)
        reset_counts()
        losses, seen = count_steps(
            lambda k: trainer.train_step(tiles["img"], tiles["label"])["loss"], 20)
        out["launches"][f"vit_rgb_finetune_{name}"] = launch_counts()
        check(seen == [want], f"vit_rgb finetune {name}: launches at every one of "
                              f"{len(losses)} steps {seen} == {want}")
        check(all(math.isfinite(v) for v in losses),
              f"vit_rgb finetune {name}: {len(losses)} losses finite (last {losses[-1]:.4f})")
        hold_step("vit_rgb finetune", name,
                  lambda seed: step_grads(trainer, tiles["img"], tiles["label"], seed),
                  TOL_MODEL[name])
        del trainer
        torch.cuda.empty_cache()
    trainer = finetuner(torch.bfloat16)
    losses = [float(trainer.train_step(tiles["img"], tiles["label"])["loss"]) for _ in range(30)]
    first, last = sum(losses[:5]) / 5, sum(losses[-5:]) / 5
    check(last < first, f"vit_rgb finetune bf16: mean loss of steps 1-5 {first:.4f} > steps "
                        f"26-30 {last:.4f}")
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[1]
        trainer = finetuner(dtype)
        steps_per_s(lambda: trainer.train_step(tiles["img"], tiles["label"]), card,
                    f"vit_rgb finetuning {name}")
        del trainer
        torch.cuda.empty_cache()

    # --- (d) pretraining with PatchEmbed and the shared decoder ---------------
    pcfg = get_pretrain_config("configs/pretrain_config.yaml", "configs/config.yaml", seed=SEED)
    pcfg.blockwise_patch_embed = False
    pcfg.to_pixels_per_spectral_block = False
    pdata = pretrain_tiles(pcfg.n_bands)
    _, train_ds = split_dataset(pdata, pcfg.train_fraction, pcfg.data_fraction, SEED)
    store = DeviceTileStore(train_ds, "cuda").arrays["img"]
    idx_all = IndexBatcher(store.shape[0], TRAIN_BATCH, shuffle=True, drop_last=True,
                           seed=SEED).take(60)
    host = next(iter(DataLoader(train_ds, TRAIN_BATCH, shuffle=False)))["img"]

    def pretrainer(dtype):
        return Pretrainer(pcfg.copy(), dtype=dtype, device="cuda")

    trainer = pretrainer(torch.bfloat16)
    check(not trainer.model.pn_layout and not trainer.model.per_block,
          "pretrain patch_embed: the model takes the PatchEmbed tokenization and the shared "
          "to_pixels_linear decoder")
    want = launches_want(2 * depth, 2 * depth, 2 * depth)
    reset_counts()
    losses, seen = count_steps(lambda k: trainer.train_step_idx(store, idx_all[k])["loss"], 20)
    streamed, seen_streamed = count_steps(lambda k: trainer.train_step(host)["loss"], 3)
    out["launches"]["patch_embed_pretrain"] = launch_counts()
    check(seen == [want] and seen_streamed == [want],
          f"pretrain patch_embed bf16: launches at every one of 20 store steps {seen} and 3 "
          f"streamed steps {seen_streamed} == {want} (none of #3-#6)")
    check(all(math.isfinite(v) for v in losses + streamed),
          f"pretrain patch_embed bf16: 23 losses finite (last {losses[-1]:.6e})")
    del trainer
    ref32 = None  # fp32 first: its plain step holds the bf16 leaves above TOL_STEP
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        trainer = pretrainer(dtype)
        img = trainer._gather_crop(store, torch.as_tensor(idx_all[0], device="cuda"), (5, 9),
                                   pcfg.image_size)
        mask = trainer.model.sample_mask(TRAIN_BATCH, "cuda", torch.Generator().manual_seed(3))
        plain = hold_step("pretrain patch_embed", name,
                          lambda seed: pretrain_step_grads(trainer, img, mask, seed),
                          TOL_LOSS[name], ref32)
        ref32 = ref32 or plain
        del trainer
        torch.cuda.empty_cache()
    trainer = pretrainer(torch.bfloat16)
    losses = [float(trainer.train_step_idx(store, idx)["loss"]) for idx in idx_all]
    first, last = sum(losses[:5]) / 5, sum(losses[-5:]) / 5
    check(last < first, f"pretrain patch_embed bf16: mean loss of steps 1-5 {first:.6e} > steps "
                        f"56-60 {last:.6e}")
    it = iter(idx_all)
    steps_per_s(lambda: trainer.train_step_idx(store, next(it)), card,
                "pretraining patch_embed + shared decoder bfloat16")
    del trainer
    torch.cuda.empty_cache()
    img = store[torch.as_tensor(idx_all[0], device="cuda"), :, 5:13, 9:17].contiguous()

    # --- (e) SimMIM over ViTSpatialSpectralV1 with intermediate_losses ---------
    def v1_simmim(dtype, intermediate):
        enc = ViTSpatialSpectralV1(
            image_size=8, spatial_patch_size=1, spectral_patch_size=pcfg.band_patch_size,
            num_classes=pcfg.n_classes, dim=pcfg.transformer_dim, depth=depth,
            heads=pcfg.transformer_n_heads, mlp_dim=pcfg.transformer_mlp_dim,
            channels=pcfg.n_bands, dropout=pcfg.transformer_dropout, dtype=dtype)
        return SimMIMSpatialSpectral(enc, pcfg.mim_masking_ratio, pcfg.mim_mask_patch_size,
                                     pcfg.tube_masking, intermediate_losses=intermediate,
                                     dtype=dtype).init_weights(SEED).cuda()

    class Holder:  # what pretrain_step_grads reads of a trainer
        pass

    ref32 = None
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        three, one = v1_simmim(dtype, True), v1_simmim(dtype, False)
        mask = three.sample_mask(TRAIN_BATCH, "cuda", torch.Generator().manual_seed(4))
        holder = Holder()
        holder.model = three
        reset_counts()
        loss3, _ = pretrain_step_grads(holder, img, mask, 77)
        torch.cuda.synchronize()
        counts = launch_counts()
        out["launches"][f"v1_intermediate_{name}"] = counts
        holder.model = one
        loss1, _ = pretrain_step_grads(holder, img, mask, 77)
        want = launches_want(2 * depth, 2 * depth, 2 * depth if dtype == torch.bfloat16 else 0)
        check(counts == want, f"simmim v1 intermediate_losses {name}: one step's launches "
                              f"{counts} == {want}")
        check(math.isfinite(loss3) and np.float32(loss3) == np.float32(3.0) * np.float32(loss1),
              f"simmim v1 {name}: the loss with intermediate_losses {loss3:.8e} == 3 x the "
              f"loss without {loss1:.8e}, exactly")
        holder.model = three
        plain = hold_step("simmim v1 intermediate_losses", name,
                          lambda seed: pretrain_step_grads(holder, img, mask, seed),
                          TOL_LOSS[name], ref32)
        ref32 = ref32 or plain
        del three, one, holder
        torch.cuda.empty_cache()

    # --- (f) the legacy SimMIM over ViTRGB --------------------------------------
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[1]
        enc = ViTRGB(image_size=8, patch_size=1, num_classes=base.n_classes,
                     dim=base.transformer_dim, depth=depth, heads=base.transformer_n_heads,
                     mlp_dim=base.transformer_mlp_dim, channels=base.n_bands,
                     dropout=base.transformer_dropout, dtype=dtype)
        legacy = SimMIM(enc, 0.5).init_weights(SEED).cuda().train()
        reset_counts()
        loss, pred, patches, idx, encoded = legacy(img, rng=torch.Generator().manual_seed(5))
        torch.cuda.synchronize()
        counts = launch_counts()
        out["launches"][f"legacy_simmim_{name}"] = counts
        m = legacy.num_masked
        shapes = [tuple(t.shape) for t in (loss, pred, patches, idx, encoded)]
        want_shapes = [(), (TRAIN_BATCH, m, base.n_bands), (TRAIN_BATCH, m, base.n_bands),
                       (TRAIN_BATCH, m), (TRAIN_BATCH, 64, base.transformer_dim)]
        check(shapes == want_shapes and bool(torch.isfinite(loss)),
              f"legacy simmim {name}: (loss, pred, masked patches, indices, encoded) shapes "
              f"{shapes} == {want_shapes}, finite loss {float(loss):.6e}; launches {counts}")
        mask = torch.zeros(TRAIN_BATCH, 64, dtype=torch.bool, device="cuda")
        mask.scatter_(1, idx, True)

        def legacy_grads(seed):
            legacy.zero_grad(set_to_none=True)
            lo = legacy(img, rng=torch.Generator().manual_seed(seed), bool_mask=mask)[0]
            lo.backward()
            grads = {n: q.grad.detach().clone() for n, q in legacy.named_parameters()
                     if q.grad is not None}
            legacy.zero_grad(set_to_none=True)
            return float(lo.detach()), grads

        hold_step("legacy simmim", name, legacy_grads, TOL_LOSS[name])
        del legacy, enc
        torch.cuda.empty_cache()
    return out


# fp32, TF32 off: a card step against the CPU step, relative. A gradient that
# a cancelling sum makes near-zero (a bias before a training-mode BatchNorm;
# chen's sums at its 0.001-std init) carries rounding far above 1e-4 of its
# own max in both fp32 steps alike: it is held instead by its distance from
# a float64 step (NEARER_FP32 x the CPU fp32 step's) or by the net's
# largest gradient.
ZOO_TOL = 1e-4


def phase_zoo(card: str) -> dict:
    """Phase 11: the DeepHyperX zoo and the HyperX benchmark. (a) every net
    at its factory geometry and batch through ``tools/zoo_check.py`` on the
    card, and a held step of each (dropout off, BatchNorm training) against
    the same step on the CPU from the same weights on a batch of 8; (b) li
    on the EnMAP-DFC config through the finetune factory: ``Finetuner.fit``
    from the device store at batch 64 with the SGD recipe and class
    weights, steps/s and the idle share, ``Predictor`` at batch 256, a
    ``.pt`` resume bit for bit against its control, a ``.pth`` export and
    import, and the finetune driver with a li config; (c) the two HyperX
    CLIs on a synthetic scene, what needs PIL or sklearn only where they
    import. Every kernel count stays 0: no zoo path runs a ViT kernel."""
    import importlib.util

    import torch

    from maskedsst_tpu_torch import finetune
    from maskedsst_tpu_torch.config import get_finetune_config
    from maskedsst_tpu_torch.data.device_store import DeviceTileStore, IndexBatcher
    from maskedsst_tpu_torch.data.pipeline import split_dataset
    from maskedsst_tpu_torch.data.synthetic import SyntheticCubeDataset
    from maskedsst_tpu_torch.hyperx import inference as hx_inference
    from maskedsst_tpu_torch.hyperx import main as hx_main
    from maskedsst_tpu_torch.io.torch_import import (
        export_li_et_al,
        import_li_et_al,
        load_torch_checkpoint,
    )
    from maskedsst_tpu_torch.models.zoo import ZOO_NAMES
    from maskedsst_tpu_torch.ops import dropout_sample
    from maskedsst_tpu_torch.serve import Predictor
    from maskedsst_tpu_torch.tools import zoo_check
    from maskedsst_tpu_torch.train.checkpoint import save_checkpoint
    from maskedsst_tpu_torch.train.factory import build_finetune_model, load_pretrained_params
    from maskedsst_tpu_torch.train.finetuner import Finetuner

    out: dict = {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_zoo_")
    reset_counts()
    drop_before = dropout_sample.launches
    try:
        # --- (a) every net on the card, and held against the CPU -------------
        t0 = time.perf_counter()
        record = zoo_check.run(ZOO_NAMES, "cuda", steps=4)
        out["zoo_check"] = record
        for row in record["per_net"]:
            check(row["ok"], f"zoo {row['name']}: {row.get('geometry')} batch "
                  f"{row.get('batch')}, 4 steps, loss {row.get('loss_first', float('nan')):.5f} -> "
                  f"{row.get('loss_last', float('nan')):.5f} finite and moving, eval logits finite"
                  + ("" if row["ok"] else f": {row.get('error')}"))
            if row["ok"]:
                dev = row["device_ms_per_step"]
                print(f"     zoo {row['name']}: {row['ms_per_step']:.3f} ms a step (host clock, "
                      f"median of steps 2-4), device busy "
                      f"{'not measured' if dev is None else f'{dev:.3f} ms'} a step; "
                      f"{row['parameters']:,} parameters, batch {row['batch']} on {card}",
                      flush=True)
        holds = []
        for name in ZOO_NAMES:
            h = zoo_check.hold_on(name, "cuda", batch=8)
            holds.append(h)
            rows = h["grads"]
            own = [k for k, r in rows.items() if r["own"] <= ZOO_TOL]
            net = [k for k, r in rows.items() if k not in own and r["net"] <= ZOO_TOL]
            fp64 = [k for k, r in rows.items() if k not in own and k not in net
                    and r["fp64_device"] <= NEARER_FP32 * r["fp64_cpu"]]
            bad = [k for k in rows if k not in own + fp64 + net]
            worst = max(rows, key=lambda k: rows[k]["own"])
            check(h["loss_rel"] <= ZOO_TOL and not bad,
                  f"zoo {name}: card step vs CPU step (fp32, TF32 off, batch 8): loss "
                  f"{h['loss_device']:.8e} vs {h['loss_cpu']:.8e} (rel {h['loss_rel']:.2e} <= "
                  f"{ZOO_TOL:.0e}); of {len(rows)} gradients {len(own)} within {ZOO_TOL:.0e} of "
                  f"their max|ref| (worst {worst} {rows[worst]['own']:.2e}), {len(net)} within "
                  f"{ZOO_TOL:.0e} of the net's largest gradient "
                  + "".join(f"[{k}: {rows[k]['net']:.2e}]" for k in net)
                  + f", {len(fp64)} no further from a float64 step than {NEARER_FP32} x the CPU "
                  "fp32 step "
                  + "".join(f"[{k}: {rows[k]['fp64_device']:.2e} vs {rows[k]['fp64_cpu']:.2e}]"
                            for k in fp64)
                  + (f"; above all three: {bad}" if bad else ""))
        out["holds"] = holds
        # what cuDNN's deterministic algorithms (the Finetuner's choice for a
        # zoo net) cost on the two heaviest nets: their steps in turns
        before_det = torch.backends.cudnn.deterministic
        for name in ("chen", "sharma"):
            trainer, hp = zoo_check.build(name, "cuda")
            img_t, label_t = trainer._to_device(*zoo_check.batch_for(hp, hp["batch_size"]))
            ms = {False: [], True: []}
            for det in (False, True, True, False):
                torch.backends.cudnn.deterministic = det
                trainer.train_step(img_t, label_t)
                torch.cuda.synchronize()
                t = time.perf_counter()
                for _ in range(3):
                    trainer.train_step(img_t, label_t)
                torch.cuda.synchronize()
                ms[det].append(1e3 * (time.perf_counter() - t) / 3)
            torch.backends.cudnn.deterministic = before_det
            out[f"{name}_ms_nondeterministic_deterministic"] = (ms[False], ms[True])
            print(f"     zoo {name}: cuDNN's default algorithms {ms[False][0]:.3f} / "
                  f"{ms[False][1]:.3f} ms a step, its deterministic ones {ms[True][0]:.3f} / "
                  f"{ms[True][1]:.3f} (default, deterministic, deterministic, default; 3 steps "
                  f"each after one) on {card}", flush=True)
            del trainer
        print(f"     phase 11 (a) took {time.perf_counter() - t0:.1f} s", flush=True)

        # --- (b) li at the EnMAP-DFC geometry --------------------------------
        t0 = time.perf_counter()
        cfg = get_finetune_config("configs/finetune_config_enmap.yaml", "configs/config.yaml",
                                  seed=SEED)
        cfg.method_name, cfg.pixelwise, cfg.patch_sub = "li", True, 1
        cfg.batch_size = cfg.val_batch_size = TRAIN_BATCH
        model, kwargs = build_finetune_model(cfg, dtype=torch.bfloat16, device="cuda")
        check(type(model).__name__ == "LiEtAl" and model.patch_size == 7
              and kwargs["optimizer_override"]["name"] == "SGD"
              and float(kwargs["class_weights"][-1]) == 0.0 and kwargs["add_channel_dim"],
              f"li factory: LiEtAl (16 planes, 200 bands, 7x7 windows), fp32 whatever the "
              f"compute dtype, SGD {kwargs['optimizer_override']}, class weights "
              f"{list(kwargs['class_weights'])}")
        data = SyntheticCubeDataset(num_tiles=256, n_bands=cfg.n_bands, n_classes=cfg.n_classes,
                                    seed=SEED)
        val_ds, train_ds = split_dataset(data, cfg.train_fraction, cfg.data_fraction, SEED)
        trainer = Finetuner(cfg, model, tile_size=64, **kwargs)
        hist = trainer.fit(train_ds, val_ds, tracker=QuietTracker(), save_checkpoints=False,
                           max_steps=48)
        losses = [row["loss"] for row in hist["train"]]
        chance = 1.0 / cfg.n_classes
        check(hist["device_store"] and all(np.isfinite(losses)) and len(hist["val"]) > 0
              and all(np.isfinite(v["loss"]) for v in hist["val"])
              and hist["best_val_acc"] > chance,
              f"li finetune fit (device store, batch {TRAIN_BATCH}, SGD, class weights): 48 "
              f"steps, every epoch's last loss finite ({losses[0]:.4f} ... {losses[-1]:.4f}), "
              f"{len(hist['val'])} validations, best val acc {hist['best_val_acc']:.4f} > "
              f"chance {chance:.3f}")
        out["li_finetune_steps_per_s"] = hist["throughput"]["steps_per_s"]
        store = DeviceTileStore(train_ds, "cuda")
        idx = np.arange(TRAIN_BATCH) % len(store)
        prof = profile_step(lambda: trainer.train_step_idx(store.arrays["img"],
                                                           store.arrays["label"], idx))
        out["li_finetune_idle_share"] = prof.get("idle_share")
        out["li_finetune_device_ms"] = prof.get("device_ms_per_step")
        print(f"     li finetune: {hist['throughput']['steps_per_s']:.3f} steps/s through fit "
              f"(batch {TRAIN_BATCH}, whole epochs, validation excluded); one store step "
              + (f"{prof['device_ms_per_step']:.3f} ms of device time in a "
                 f"{prof['wall_ms_per_step']:.3f} ms step, idle {prof['idle_share']:.1%} of "
                 f"the span" if prof else "not measured (no device time in the trace)")
              + f" on {card}", flush=True)
        cubes = np.random.default_rng(3).standard_normal(
            (8 * BATCH, 1, cfg.n_bands, 7, 7)).astype(np.float32)
        pred = Predictor(model, batch_size=BATCH)
        logits = pred(cubes[:300])
        with torch.no_grad():
            direct = model.eval()(torch.from_numpy(cubes[:300]).cuda()).cpu().numpy()
        check(logits.shape == (300, cfg.n_classes) and np.isfinite(logits).all()
              and np.abs(logits - direct).max() <= 1e-5,
              f"li serving: Predictor(batch {BATCH}) logits {logits.shape} finite, as the "
              f"model's own forward (max |d| {np.abs(logits - direct).max():.2e})")
        pred(cubes)
        torch.cuda.synchronize()
        walls = []
        for _ in range(3):
            t = time.perf_counter()
            pred(cubes)
            walls.append(time.perf_counter() - t)
        out["li_serving_cubes_per_s"] = cubes.shape[0] / statistics.median(walls)
        print(f"     li serving: {out['li_serving_cubes_per_s']:.1f} cubes/s (N={cubes.shape[0]}, "
              f"batch {BATCH}, median of 3, host clock incl. transfers) on {card}", flush=True)

        def li_trainer():
            m, kw = build_finetune_model(cfg, device="cuda")
            return Finetuner(cfg, m, tile_size=64, **kw)

        batches = [np.random.default_rng(40 + k).permutation(len(store))[:TRAIN_BATCH]
                   for k in range(10)]
        process_flag = torch.backends.cudnn.deterministic
        control, repeat, first = li_trainer(), li_trainer(), li_trainer()
        flags, update = [], control._update  # the flag each of control's steps ran with

        def flagged(*args, **kw):
            flags.append(torch.backends.cudnn.deterministic)
            return update(*args, **kw)

        control._update = flagged
        for k in range(10):
            control.train_step_idx(store.arrays["img"], store.arrays["label"], batches[k])
            repeat.train_step_idx(store.arrays["img"], store.arrays["label"], batches[k])
        diff = states_equal(control.state, repeat.state)
        check(not diff and flags == [True] * 10
              and torch.backends.cudnn.deterministic == process_flag,
              "li determinism: 10 store steps repeated from the same seed equal bit for bit "
              f"(each step ran with cuDNN's deterministic algorithms: {flags.count(True)} of "
              f"{len(flags)}, selected by the Finetuner for a zoo net's steps; the process's "
              f"flag {torch.backends.cudnn.deterministic} as before them)"
              + (f" (differ: {diff[:5]})" if diff else ""))
        for k in range(5):
            first.train_step_idx(store.arrays["img"], store.arrays["label"], batches[k])
        path = os.path.join(tmp, "li_at_step5.pt")
        save_checkpoint(path, first.state, cfg)
        resumed = li_trainer()
        resumed.resume(path)
        for k in range(5, 10):
            resumed.train_step_idx(store.arrays["img"], store.arrays["label"], batches[k])
        diff = states_equal(control.state, resumed.state)
        check(not diff and resumed.state.step == 10
              and any("momentum_buffer" in s for s in resumed.state.optimizer.state.values()),
              f"li resume: 5 steps, a .pt, a new Finetuner resumed for 5 more: parameters, SGD "
              f"momentum buffers, step and generator equal the 10-step control bit for bit"
              + (f" (differ: {diff[:5]})" if diff else ""))
        pth = os.path.join(tmp, "li.pth")
        torch.save({"model_state_dict": export_li_et_al(control.model.state_dict())}, pth)
        fresh, _ = build_finetune_model(cfg, device="cuda")
        fresh.load_state_dict(import_li_et_al(load_torch_checkpoint(pth)["model_state_dict"],
                                              fresh))
        fresh2, _ = build_finetune_model(cfg, device="cuda")
        fresh2.load_state_dict(load_pretrained_params(pth, cfg, fresh2))
        want = Predictor(control.model, batch_size=BATCH)(cubes[:300])
        got, got2 = (Predictor(m, batch_size=BATCH)(cubes[:300]) for m in (fresh, fresh2))
        check(np.array_equal(got, want) and np.array_equal(got2, want),
              "li .pth: export -> torch.save -> load -> import (and through "
              "load_pretrained_params) serves the trained logits bit for bit")
        cfg_path = os.path.join(tmp, "finetune_config_li.yaml")
        with open("configs/finetune_config_enmap.yaml") as f:
            text = f.read()
        with open(cfg_path, "w") as f:
            f.write(text.replace("method_name: ViTSpatialSpectral", "method_name: li")
                    .replace("pixelwise: False", "pixelwise: True"))
        history, lines = run_quietly(os.path.join(tmp, "finetune_li.log"), finetune.main, [
            "enmap", "--synthetic", "--synthetic-tiles", "16", "--steps", "6",
            "--finetune-config", cfg_path, "--checkpoint", "none",
            "--models-dir", os.path.join(tmp, "models")])
        check(any(line.startswith("Model name: li") for line in lines)
              and any(line.startswith("device: ") and "cpu" not in line for line in lines)
              and np.isfinite(history["train"][-1]["loss"]),
              f"finetune driver with method_name li on the card: final loss "
              f"{history['train'][-1]['loss']:.5f}, best val acc {history['best_val_acc']:.4f}")
        del store, control, repeat, first, resumed, trainer
        torch.cuda.empty_cache()
        print(f"     phase 11 (b) took {time.perf_counter() - t0:.1f} s", flush=True)

        # --- (c) the HyperX CLIs ---------------------------------------------
        t0 = time.perf_counter()
        has_pil = importlib.util.find_spec("PIL") is not None
        has_sklearn = importlib.util.find_spec("sklearn") is not None
        not_run = []
        cli = {}
        for name, epochs in (("li", 20), ("liu", 3), ("mou", 3)):
            np.random.seed(SEED)
            json_out = os.path.join(tmp, f"hyperx_{name}.json")
            results, _ = run_quietly(os.path.join(tmp, f"hyperx_{name}.log"), hx_main.main, [
                "--model", name, "--synthetic-scene", "--epoch", str(epochs),
                "--out-dir", "none", "--json-out", json_out,
                "--checkpoint-dir", os.path.join(tmp, "ck")])
            with open(json_out) as f:
                rec = json.load(f)
            acc, kappa = results[0]["Accuracy"], results[0]["Kappa"]
            cli[name] = {"accuracy": acc, "kappa": kappa, "f1": list(results[0]["F1 scores"])}
            chance = 100.0 / 6  # six classes on the synthetic scene
            check(np.isfinite(acc) and np.isfinite(kappa)
                  and np.isfinite(results[0]["F1 scores"]).all() and acc > chance
                  and rec["platform"] == "gpu" and rec["device"] == torch.cuda.get_device_name(0),
                  f"hyperx.main --model {name} --synthetic-scene --epoch {epochs} on the card: "
                  f"OA {acc:.3f} % > chance {chance:.1f} %, kappa {kappa:.4f}, F1 finite; "
                  f"record on {rec['device']}")
        out["cli"] = cli
        ckpt = os.path.join(tmp, "ck", "li_et_al", "synthetic", "best.pt")
        img, *_ = hx_main.synthetic_scene()
        scene = os.path.join(tmp, "scene.npy")
        np.save(scene, img)
        if has_pil:
            infer_out = os.path.join(tmp, "infer")
            run_quietly(os.path.join(tmp, "infer.log"), hx_inference.main, [
                "--model", "li", "--checkpoint", ckpt, "--image", scene, "--n-classes", "7",
                "--out", infer_out])
            probs = np.load(os.path.join(infer_out, "probs.npy"))
            prediction = np.load(os.path.join(infer_out, "prediction.npy"))
            wrote = os.path.exists(os.path.join(infer_out, "color_prediction.tif"))
        else:
            probs, prediction = hx_inference.predict_scene(
                "li", ckpt, hx_inference.load_scene(scene), 7)
            wrote = True
            not_run.append("the inference CLI's .tif maps and hyperx.main's image outputs "
                           "(PIL does not import here; probabilities and predictions ran)")
        check(probs.shape == img.shape[:2] + (7,) and np.isfinite(probs).all()
              and np.array_equal(prediction, probs.argmax(-1)) and wrote,
              f"hyperx inference of li's checkpoint on the card: scores {probs.shape} finite, "
              f"prediction their argmax" + (", maps written" if has_pil else ""))
        if has_sklearn:
            results, _ = run_quietly(os.path.join(tmp, "svm.log"), hx_main.main, [
                "--model", "SVM", "--synthetic-scene", "--training_sample", "0.05",
                "--out-dir", "none", "--checkpoint-dir", "none"])
            check(np.isfinite(results[0]["Accuracy"]),
                  f"hyperx.main --model SVM: OA {results[0]['Accuracy']:.3f} %")
        else:
            not_run.append("the sklearn baselines (sklearn does not import here; random "
                           "sampling took the numpy stratified split)")
        print("     phase 11 did not run: " + ("; ".join(not_run) if not_run else "nothing")
              + f" (PIL {'imports' if has_pil else 'absent'}, sklearn "
              f"{'imports' if has_sklearn else 'absent'}); the CPU tests cover them", flush=True)
        print(f"     phase 11 (c) took {time.perf_counter() - t0:.1f} s", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.synchronize()
    out["launches"] = launch_counts()
    out["drop_launches"] = dropout_sample.launches - drop_before
    check(all(v == 0 for v in out["launches"].values()) and out["drop_launches"] == 0,
          f"phase 11 paths launched no ViT kernel: {out['launches']}, dropout_sample "
          f"{out['drop_launches']}")
    return out


def phase_flax_checkpoint(card: str, pretrain_per_step: dict, finetune_per_step: dict,
                          serving_rate: float) -> dict:
    """Phase 12: the JAX package's .msgpack checkpoints and serving over
    several devices. (a) two bf16 pretraining steps at batch 64 written by
    write_flax_checkpoint (AdamW + clip, flat moments), read back bit for
    bit, resumed by a new Pretrainer for 3 counted steps; (b) that file's
    encoder through load_pretrained_params into the EnMAP-DFC classifier,
    equal to the .pt route's, 3 counted finetune steps, the finetune state
    written as .msgpack (Adam, head / rest groups) and resumed with its
    moments bit for bit; (c) Predictor over ["cuda:0", "cuda:0"] at batch
    256 against one device at 128, and over the default devices, their
    cubes/s beside phase 2's one-device ``serving_rate``; (d)
    BatchNorm zoo nets through HyperXTrainer.save / restore as .msgpack."""
    import tempfile

    import torch

    from maskedsst_tpu_torch.config import get_finetune_config, get_pretrain_config
    from maskedsst_tpu_torch.data.synthetic import SyntheticCubeDataset
    from maskedsst_tpu_torch.hyperx.training import HyperXTrainer
    from maskedsst_tpu_torch.io.flax_checkpoint import (
        flax_tree_of,
        read_flax_checkpoint,
        write_flax_checkpoint,
    )
    from maskedsst_tpu_torch.models.zoo import BatchNorm, get_model
    from maskedsst_tpu_torch.ops import dropout_sample
    from maskedsst_tpu_torch.serve import Predictor
    from maskedsst_tpu_torch.train.checkpoint import save_checkpoint
    from maskedsst_tpu_torch.train.factory import build_finetune_model, load_pretrained_params
    from maskedsst_tpu_torch.train.finetuner import Finetuner
    from maskedsst_tpu_torch.train.pretrainer import Pretrainer

    def bits(x):
        x = x.detach().cpu() if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
        return x.view(torch.int16) if x.dtype == torch.bfloat16 else x

    def same_tree(a, b) -> list:
        """The paths where two trees differ (keys or leaf bits)."""
        if isinstance(a, dict) or isinstance(b, dict):
            if not (isinstance(a, dict) and isinstance(b, dict)) or sorted(a) != sorted(b):
                return ["keys"]
            return [f"{k}/{d}" for k in a for d in same_tree(a[k], b[k])]
        x, y = bits(a), bits(b)
        return [] if x.dtype == y.dtype and torch.equal(x, y) else ["leaf"]

    def moments_equal(a, b) -> list:
        diff = [n for (n, p), q in zip(a.model.named_parameters(), b.model.parameters())
                if not torch.equal(p, q)]
        for (n, p), q in zip(a.model.named_parameters(), b.model.parameters()):
            sa, sb = a.optimizer.state[p], b.optimizer.state[q]
            diff += [f"{n} {k}" for k in ("step", "exp_avg", "exp_avg_sq")
                     if not torch.equal(sa[k].cpu(), sb[k].cpu())]
        return diff

    tmp = tempfile.mkdtemp(prefix="chip_smoke_flax_")
    out: dict = {}
    try:
        # --- (a) pretraining through a .msgpack --------------------------------
        cfg = get_pretrain_config("configs/pretrain_config.yaml", "configs/config.yaml",
                                  seed=SEED)
        cfg.batch_size = TRAIN_BATCH
        data = SyntheticCubeDataset(num_tiles=TRAIN_BATCH, n_bands=cfg.n_bands, labeled=False,
                                    seed=SEED)
        tiles = np.stack([data[i]["img"] for i in range(TRAIN_BATCH)])

        def pretrainer():
            return Pretrainer(cfg.copy(), dtype=torch.bfloat16, device="cuda")

        writer = pretrainer()
        for _ in range(2):
            writer.train_step(tiles)
        path = os.path.join(tmp, "model_at_step2.msgpack")
        t0 = time.perf_counter()
        write_flax_checkpoint(path, writer.state, writer.config, extra=writer._scheduler_extra())
        save_s = time.perf_counter() - t0
        tree = read_flax_checkpoint(path)
        diff = same_tree(tree, flax_tree_of(writer.state, writer.config))
        inject = tree["opt_state"]["1"]
        flat = inject["inner_state"]["0"]["mu"]
        check(not diff and sorted(tree["opt_state"]) == ["0", "1"] and flat.ndim == 1
              and flat.size == writer.num_params,
              f"phase 12 (a): {os.path.basename(path)} ({os.path.getsize(path) / 2**20:.2f} MiB, "
              f"written in {save_s:.3f} s) read back leaf for leaf equal to the writing state: "
              f"optax clip + AdamW layout, flat moments of {flat.size:,} values "
              f"(differ: {diff[:4] or 'none'})")
        resumed = pretrainer()
        t0 = time.perf_counter()
        at = resumed.resume(path)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        diff = moments_equal(writer.state, resumed.state)
        check(at == 2 and not diff and resumed.state.optimizer.param_groups[0]["lr"]
              == float(np.float32(cfg.lr)),
              f"phase 12 (a): Pretrainer.resume at step {at} (restored in {restore_s:.3f} s on "
              f"{card}): every parameter, AdamW moment and step bit for bit (differ: "
              f"{diff[:4] or 'none'}), the rate {cfg.lr} as float32")
        seen: list = []
        counting_steps(resumed, "train_step", seen)
        dropout_sample.launches = 0
        reset_counts()
        losses = [float(resumed.train_step(tiles)["loss"]) for _ in range(3)]
        torch.cuda.synchronize()
        pre_counts = launch_counts()
        check(len(seen) == 3 and all(c == pretrain_per_step for c in seen)
              and all(math.isfinite(v) for v in losses),
              f"phase 12 (a): 3 resumed pretraining steps, each launching phase 4's "
              f"{pretrain_per_step}, losses {' '.join(f'{v:.5f}' for v in losses)}")
        del resumed

        # --- (b) the encoder into the classifier, a finetune state ---------------
        pt = os.path.join(tmp, "model_at_step2.pt")
        save_checkpoint(pt, writer.state, writer.config)
        ft = get_finetune_config("configs/finetune_config_enmap.yaml", "configs/config.yaml",
                                 seed=SEED)
        ft.transformer_emb_dropout = 0.0
        ft.batch_size = TRAIN_BATCH
        model, kw = build_finetune_model(ft, dtype=torch.bfloat16, device="cuda")
        from_msgpack = load_pretrained_params(path, ft, model, seed=ft.seed)
        from_pt = load_pretrained_params(pt, ft, model, seed=ft.seed)
        carried = [k for k in from_pt if f"encoder.{k}" in writer.model.state_dict()]
        check(from_msgpack.keys() == from_pt.keys() and carried
              and all(torch.equal(from_msgpack[k], from_pt[k]) for k in from_pt),
              f"phase 12 (b): load_pretrained_params of the .msgpack == of the .pt, bit for bit "
              f"({len(carried)} encoder tensors carried, {len(from_pt) - len(carried)} fresh)")
        model.load_state_dict(from_msgpack)
        trainer = Finetuner(ft.copy(), model, **kw)
        data_ft = SyntheticCubeDataset(num_tiles=TRAIN_BATCH, n_bands=ft.n_bands,
                                       n_classes=ft.n_classes, seed=SEED)
        batch = [data_ft[i] for i in range(TRAIN_BATCH)]
        img = np.stack([b["img"] for b in batch])
        label = np.stack([b["label"] for b in batch])
        seen = []
        counting_steps(trainer, "train_step", seen)
        losses = [float(trainer.train_step(img, label)["loss"]) for _ in range(3)]
        torch.cuda.synchronize()
        out["launches"] = launch_counts()  # (a)'s resumed steps and these
        out["launches"]["dropout_sample"] = dropout_sample.launches
        check(len(seen) == 3 and all(c == finetune_per_step for c in seen)
              and all(math.isfinite(v) for v in losses),
              f"phase 12 (b): 3 finetune steps from the .msgpack encoder, each launching phase "
              f"3's {finetune_per_step}, losses {' '.join(f'{v:.5f}' for v in losses)}")
        fpath = os.path.join(tmp, f"{ft.method_name}_at_step3.msgpack")
        write_flax_checkpoint(fpath, trainer.state, trainer.config, extra={
            "epoch": 0, "step": 3, "best_val_acc": 0.0, "last_val_loss": None,
            "scheduler": trainer.scheduler.state_dict()})
        groups = sorted(read_flax_checkpoint(fpath)["opt_state"].get("inner_states", {}))
        model2, kw2 = build_finetune_model(ft, dtype=torch.bfloat16, device="cuda")
        back = Finetuner(ft.copy(), model2, **kw2)
        at = back.resume(fpath)
        diff = moments_equal(trainer.state, back.state)
        rates = [g["lr"] for g in back.state.optimizer.param_groups]
        check(at == 3 and groups == ["head", "rest"] and not diff
              and rates == [float(np.float32(g["lr"])) for g in trainer.state.optimizer
                            .param_groups],
              f"phase 12 (b): the finetune state as .msgpack (optax groups {groups}) resumed at "
              f"step {at}: parameters, Adam moments and steps bit for bit (differ: "
              f"{diff[:4] or 'none'}), rates {rates}")
        del writer, trainer, back, model2
        torch.cuda.empty_cache()

        # --- (c) serving over several devices --------------------------------
        serve_model, _ = build_finetune_model(ft, dtype=torch.bfloat16, device="cuda")
        x = np.random.default_rng(SEED).standard_normal((300, ft.n_bands, 8, 8)).astype(
            np.float32)
        two = Predictor(serve_model, batch_size=BATCH, devices=["cuda:0", "cuda:0"])
        one = Predictor(serve_model, batch_size=BATCH // 2, devices=["cuda:0"])
        default = Predictor(serve_model, batch_size=BATCH * torch.cuda.device_count())
        dropout_sample.launches = 0
        reset_counts()
        a = two(x)
        b = default(x)
        torch.cuda.synchronize()
        out["multi_device"] = launch_counts()
        out["multi_device"]["dropout_sample"] = dropout_sample.launches
        ref = one(x)
        depth = ft.transformer_depth
        chunks = math.ceil(300 / BATCH) * 2 + math.ceil(
            300 / default.batch_size) * len(default.devices)
        want = {"fused_layer_fwd": 2 * depth * chunks, "fused_embed_fwd": chunks}
        got = {k: out["multi_device"][k] for k in want}
        check(a.shape == ref.shape == (300, ft.n_classes, 8, 8) and np.array_equal(a, ref)
              and bool(np.isfinite(a).all()),
              f"phase 12 (c): Predictor(batch_size={BATCH}, devices=['cuda:0', 'cuda:0']) "
              f"logits of 300 cubes == Predictor(batch_size={BATCH // 2}) bit for bit")
        ref = Predictor(serve_model, batch_size=default.per_device,
                        devices=[default.devices[0]])(x)
        check(b.shape == ref.shape and np.array_equal(b, ref),
              f"phase 12 (c): Predictor over the default devices "
              f"{[str(d) for d in default.devices]} (batch {default.batch_size}) == one device "
              f"at batch {default.per_device}, bit for bit")
        check(got == want and all(v == 0 for k, v in out["multi_device"].items() if k not in want),
              f"phase 12 (c): launches {out['multi_device']} ({want} of #1 / #3, none else)")
        xs = np.random.default_rng(SEED + 1).standard_normal(
            (8 * BATCH, ft.n_bands, 8, 8)).astype(np.float32)
        rates = {}
        for name, pred in (("two replicas on cuda:0", two), ("default devices", default)):
            pred(xs)  # warm-up
            walls = []
            for _ in range(3):
                t0 = time.perf_counter()
                pred(xs)
                walls.append(time.perf_counter() - t0)
            rates[name] = xs.shape[0] / statistics.median(walls)
        out["serving"] = rates
        print(f"     serving bf16 over devices: two replicas on cuda:0 (batch {BATCH}, "
              f"{BATCH // 2} a replica) {rates['two replicas on cuda:0']:.1f} cubes/s, "
              f"the default devices "
              f"({len(default.devices)}, batch {default.batch_size}) "
              f"{rates['default devices']:.1f} cubes/s, beside phase 2's one-device batch "
              f"{BATCH}: {serving_rate:.1f} cubes/s (N="
              f"{xs.shape[0]}, median of 3, host clock incl. transfers) on {card}", flush=True)
        del two, one, default, serve_model
        torch.cuda.empty_cache()

        # --- (d) BatchNorm zoo nets as .msgpack (params + batch_stats) ---------
        for name in ("liu", "sharma"):
            kwargs = dict(n_classes=20, n_bands=50, ignored_labels=[0])
            net, opt, crit, hp = get_model(name, seed=SEED, **kwargs)
            gen = torch.Generator().manual_seed(SEED)
            with torch.no_grad():
                for mod in net.modules():
                    if isinstance(mod, BatchNorm):
                        mod.running_mean.copy_(torch.randn(mod.running_mean.shape,
                                                           generator=gen) * 0.1)
                        mod.running_var.copy_(torch.rand(mod.running_var.shape,
                                                         generator=gen) + 0.5)
            source = HyperXTrainer(net, opt, crit, hp)
            zpath = os.path.join(tmp, f"{name}.msgpack")
            source.save(zpath)
            variables = read_flax_checkpoint(zpath)
            other, *_ = get_model(name, seed=SEED + 1, **kwargs)
            target = HyperXTrainer(other, opt, crit, hp)
            target.restore(zpath)
            xz = np.random.default_rng(SEED).standard_normal(
                (8, *net.input_shape)).astype(np.float32)
            la, lb = source.predict(xz), target.predict(xz)
            check(sorted(variables) == ["batch_stats", "params"] and variables["batch_stats"]
                  and torch.equal(la, lb) and bool(torch.isfinite(la).all()),
                  f"phase 12 (d): {name} through HyperXTrainer.save / restore as .msgpack "
                  f"(params and batch_stats): eval logits {tuple(la.shape)} equal the source "
                  f"net's bit for bit")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


TP_KERNELS = ("fused_layer_fwd", "fused_layer_bwd", "layer_wgrad", "fused_embed_fwd",
              "fused_embed_bwd", "fused_simmim_fwd", "fused_simmim_bwd", "dropout_sample")


def tp_launches_want(depth: int, dropout: bool) -> dict:
    """A head-split SimMIM step's launches on one rank: no layer kernel
    (#1, #2, layer_wgrad), the embed and decode kernels once each, kernel
    #7 four sites a layer at dropout > 0."""
    return {"fused_layer_fwd": 0, "fused_layer_bwd": 0, "layer_wgrad": 0, "fused_embed_fwd": 1,
            "fused_embed_bwd": 1, "fused_simmim_fwd": 1, "fused_simmim_bwd": 1,
            "dropout_sample": 4 * 2 * depth if dropout else 0}


def tp_ranks_hold(label: str, name: str, ranks: list, want: dict) -> None:
    """The ranks of case ``name``: the whole (replicated) leaves bit-equal
    on every rank after every step, the local shards across the data ranks
    of one model index, and each rank's launches at every step ``want``."""
    grids = [r[name]["grid"] for r in ranks]
    steps = len(ranks[0][name]["steps"])
    whole = all(len({r[name]["steps"][k]["whole_digest"] for r in ranks}) == 1
                for k in range(steps))
    local = all(len({r[name]["steps"][k][key] for r, g in zip(ranks, grids) if g[2] == m}) == 1
                for k in range(steps) for m in range(grids[0][3])
                for key in ("params_digest", "grads_digest"))
    launches = [s["launches"] for r in ranks for s in r[name]["steps"]]
    check(whole and local and all(got == want for got in launches),
          f"{label}: grid {grids} (data, data size, model, model size; row-major); the whole "
          f"leaves' parameters and gradients bit-equal on every rank after each of {steps} "
          f"steps, the local shards across data ranks; each rank launched {want} at every "
          "step" + ("" if all(got == want for got in launches) else f" (got {launches})"))


def tp_shards_hold(label: str, name: str, spec_out: str, n_ranks: int, steps: int, heads: int,
                   mlp: int) -> None:
    """Each rank's local shard of every split weight bit-equal to the same
    slice of every other rank's gathered tensor."""
    from maskedsst_tpu_torch.parallel.sharding_rules import head_split, shard_index
    from maskedsst_tpu_torch.tools import dist_worker

    arrays = [dist_worker.load_arrays(spec_out, r) for r in range(n_ranks)]
    bad, checked = [], 0
    for r in range(n_ranks):
        m = r % 2
        split = head_split(heads, mlp, 2, m)
        for key, local in arrays[r].items():
            if not key.startswith(f"{name}/local{steps}/"):
                continue
            leaf_name = key.split("/", 2)[2]
            idx = shard_index(".".join(leaf_name.split(".")[-3:]), split, 64)
            idx = idx.numpy() if hasattr(idx, "numpy") else idx
            for other in range(n_ranks):
                whole = arrays[other][f"{name}/params{steps}/{leaf_name}"]
                checked += 1
                if not same_bits(whole[idx], local):
                    bad.append((r, other, leaf_name))
    check(checked > 0 and not bad,
          f"{label}: {checked} local shards after step {steps}, each bit-equal to its slice of "
          f"each rank's gathered tensor" + (f" (differ: {bad[:4]})" if bad else ""))


def phase_tensor_parallel(card: str, pretrain_rate: float) -> dict:
    """Phase 13, tensor parallelism over attention heads (parallel/mesh.py's
    grid, parallel/sharding_rules.py, ops/tp_layer.py) through
    tools/dist_worker.py's tensor_parallel case, each run held against its
    one-process run (the fused kernels) in this process: (a) tp = 2 on the
    card over Gloo, bf16 at dropout 0.1 and fp32 at dropout 0; (b) a 2 x 2
    grid in bf16; (c) NCCL over two cards where there are two; (d) kernel
    #7's strided form against its plain version; (e) the gathered state
    through .pt and .msgpack; (f) the trainers' guard; (g) a li finetune
    state through .msgpack resumed on the card."""
    import torch

    from maskedsst_tpu_torch.config import get_finetune_config, get_pretrain_config
    from maskedsst_tpu_torch.data.device_store import DeviceTileStore
    from maskedsst_tpu_torch.data.synthetic import SyntheticCubeDataset
    from maskedsst_tpu_torch.io.flax_checkpoint import read_flax_checkpoint
    from maskedsst_tpu_torch.ops import dropout_sample, fused_layer
    from maskedsst_tpu_torch.parallel.mesh import DataWorld, Grid
    from maskedsst_tpu_torch.tools import dist_worker
    from maskedsst_tpu_torch.tools.kernel_check import dropout_sample_cost
    from maskedsst_tpu_torch.train.checkpoint import restore_params, save_checkpoint
    from maskedsst_tpu_torch.train.factory import build_finetune_model
    from maskedsst_tpu_torch.train.finetuner import Finetuner
    from maskedsst_tpu_torch.train.pretrainer import Pretrainer, build_pretrain_model

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_tp_")
    out: dict = {"cases": []}
    pcfg = get_pretrain_config(*PRE_CONFIGS, seed=SEED)
    depth, heads, mlp = pcfg.transformer_depth, pcfg.transformer_n_heads, pcfg.transformer_mlp_dim
    world1 = DataWorld(device=torch.device("cuda", 0))
    try:
        # --- (a) tp = 2, dp = 1: two ranks sharing the card over gloo ---------
        pt, mp = os.path.join(tmp, "gathered.pt"), os.path.join(tmp, "gathered.msgpack")
        base = dict(kind="tensor_parallel", configs=PRE_CONFIGS, tiles=TRAIN_BATCH,
                    data_seed=SEED, model=2, arrays=True, all_ranks_arrays=True)
        cases = [dict(base, name="tp_bf16", dtype="bfloat16", steps=3, set=dict(seed=SEED),
                      timed=2, save=[pt, mp]),
                 dict(base, name="tp_fp32", dtype="float32", steps=3,
                      set=dict(seed=SEED, transformer_dropout=0.0))]
        one = {c["name"]: dist_worker.run_case(dict(c, model=1, save=[], out=tmp), world1, {})
               for c in cases}
        # a bf16 case's one-process step in fp32 (same weights, masks, seeds)
        ref32 = {c["name"]: dist_worker.run_case(dict(c, model=1, save=[], timed=0,
                                                      dtype="float32", out=tmp), world1, {})
                 for c in cases if c["dtype"] == "bfloat16"}
        torch.cuda.empty_cache()
        spec = dict(out=os.path.join(tmp, "tp2"), device="cuda", backend="gloo", cases=cases)
        t0 = time.perf_counter()
        results = dist_worker.launch(spec, 2, timeout_s=600)
        ranks = [r["cases"] for r in results]
        arrays = dist_worker.load_arrays(spec["out"])
        print(f"     tensor-parallel tp = 2: 2 ranks over gloo on {[r['device'] for r in results]} "
              f"ran {len(cases)} cases in {time.perf_counter() - t0:.1f} s (start-up included)",
              flush=True)
        for name, dtype, dropout in (("tp_bf16", "bfloat16", True),
                                     ("tp_fp32", "float32", False)):
            check(all(r[name]["round_trip"] for r in ranks),
                  f"tensor-parallel {name}: gather_params of place_params is the one-process "
                  "state bit for bit on both ranks")
            tp_ranks_hold(f"tensor-parallel {name}", name, ranks, tp_launches_want(depth, dropout))
            dp_hold_steps(f"tensor-parallel {name}", name, ranks, arrays, one[name], dtype,
                          lambda n: pcfg.lr, same_launches=False, ref32=ref32.get(name))
            tp_shards_hold(f"tensor-parallel {name}", name, spec["out"], 2, 3, heads, mlp)
        out["launches"] = [{n: sum(s["launches"][n] for s in r["tp_bf16"]["steps"])
                            for n in TP_KERNELS} for r in ranks]
        out["rate_tp2"] = [r["tp_bf16"]["steps_per_s"] for r in ranks]
        one_rate = one["tp_bf16"][0]["steps_per_s"]
        for r, rate in enumerate(out["rate_tp2"]):
            print(f"     tensor-parallel tp = 2 bf16 (dropout 0.1), rank {r} of 2 sharing the "
                  f"card over gloo: {rate:.3f} steps/s of the global batch {TRAIN_BATCH} (4 of "
                  f"8 heads and 32 of 64 MLP columns a rank; one process on the fused kernels "
                  f"in this phase: {one_rate:.3f} steps/s; phase 4: {pretrain_rate:.3f} steps/s; "
                  "2 steps, host clock, synchronized; two ranks on one card are not a scaling "
                  f"figure) on {card}", flush=True)

        # --- (e) the gathered state through .pt and .msgpack ------------------
        gathered = {n[len("tp_bf16/params3/"):]: v for n, v in arrays.items()
                    if n.startswith("tp_bf16/params3/")}
        losses, same = {}, {}
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        img = torch.randn((TRAIN_BATCH, pcfg.n_bands, pcfg.image_size, pcfg.image_size),
                          generator=gen, device="cuda")
        for path in (pt, mp):
            model = build_pretrain_model(pcfg, torch.bfloat16, "cuda")
            model.load_state_dict(restore_params(path, "cuda", model), strict=True)
            same[path] = all(same_bits(v.float().cpu().numpy(), gathered[k])
                             for k, v in model.state_dict().items()) and (
                model.state_dict().keys() == gathered.keys())
            mask = model.sample_mask(TRAIN_BATCH, "cuda", torch.Generator().manual_seed(SEED))
            with torch.no_grad():
                losses[path] = float(model.eval()(img, bool_mask=mask))
            del model
        ext = {os.path.splitext(p)[1]: same[p] for p in same}
        check(all(same.values()) and losses[pt] == losses[mp] and math.isfinite(losses[pt]),
              f"tensor-parallel round trip: gather_params after (a) written as .pt and .msgpack, "
              f"a one-process model restored from each holds the gathered parameters bit for bit "
              f"{ext}, both give the eval loss {losses[pt]:.8e} == {losses[mp]:.8e}")

        # --- (b) a 2 x 2 grid: four ranks sharing the card -----------------------
        grid_case = dict(base, name="grid_bf16", dtype="bfloat16", steps=2, timed=2,
                         set=dict(seed=SEED, transformer_dropout=0.0))
        one_grid = dist_worker.run_case(dict(grid_case, model=1, out=tmp), world1, {})
        grid32 = dist_worker.run_case(dict(grid_case, model=1, timed=0, dtype="float32",
                                           out=tmp), world1, {})
        torch.cuda.empty_cache()
        spec = dict(out=os.path.join(tmp, "grid"), device="cuda", backend="gloo",
                    cases=[grid_case])
        t0 = time.perf_counter()
        results = dist_worker.launch(spec, 4, timeout_s=600)
        ranks4 = [r["cases"] for r in results]
        print(f"     tensor-parallel 2 x 2: 4 ranks over gloo ran in "
              f"{time.perf_counter() - t0:.1f} s (start-up included)", flush=True)
        tp_ranks_hold("tensor-parallel 2 x 2 grid_bf16", "grid_bf16", ranks4,
                      tp_launches_want(depth, False))
        arrays4 = dist_worker.load_arrays(spec["out"])
        dp_hold_steps("tensor-parallel 2 x 2 grid_bf16", "grid_bf16", ranks4, arrays4, one_grid,
                      "bfloat16", lambda n: pcfg.lr, same_launches=False, ref32=grid32)
        tp_shards_hold("tensor-parallel 2 x 2 grid_bf16", "grid_bf16", spec["out"], 4, 2, heads,
                       mlp)
        out["rate_grid"] = [r["grid_bf16"]["steps_per_s"] for r in ranks4]
        print(f"     tensor-parallel 2 x 2 bf16 (dropout 0): {out['rate_grid'][0]:.3f} steps/s "
              f"of the global batch {TRAIN_BATCH} on rank 0 (4 ranks sharing the card; one "
              f"process: {one_grid[0]['steps_per_s']:.3f}; phase 4: {pretrain_rate:.3f}; 2 "
              f"steps, host clock) on {card}", flush=True)

        # --- (c) a second card ----------------------------------------------
        if torch.cuda.device_count() >= 2:
            nccl = dict(base, name="nccl", dtype="bfloat16", steps=2, arrays=False,
                        all_ranks_arrays=False, set=dict(seed=SEED, transformer_dropout=0.0))
            spec = dict(out=os.path.join(tmp, "nccl"), device="cuda", backend="nccl",
                        cases=[nccl])
            res = [r["cases"] for r in dist_worker.launch(spec, 2, timeout_s=300)]
            tp_ranks_hold("tensor-parallel tp = 2 over nccl on 2 cards", "nccl", res,
                          tp_launches_want(depth, False))
            want = one_grid[0]["steps"]
            check(all(abs(s["loss"] - w["loss"]) <= TOL_LOSS["bfloat16"] * abs(w["loss"])
                      for s, w in zip(res[0]["nccl"]["steps"], want)),
                  "tensor-parallel over nccl: the losses of 2 steps within TOL_LOSS of one "
                  "process's")
        else:
            print(f"     tensor-parallel over nccl on two cards: not run, this machine has "
                  f"{torch.cuda.device_count()} card (NCCL refuses two ranks on one card)",
                  flush=True)

        # --- (d) kernel #7's strided form ------------------------------------
        s_sp = pcfg.image_size ** 2
        rows_sp = TRAIN_BATCH * (pcfg.n_bands // pcfg.band_patch_size)
        strided = (
            ("strided_attention", fused_layer.SITE_ATTN, (rows_sp, heads, s_sp, s_sp),
             (rows_sp, heads // 2, s_sp, s_sp), heads // 2 * s_sp * s_sp, heads * s_sp * s_sp),
            ("strided_ff_mid", fused_layer.SITE_FF_MID, (rows_sp * s_sp, mlp),
             (rows_sp * s_sp, mlp // 2), mlp // 2, mlp),
        )
        for label, site, full_shape, shape, base_idx, stride in strided:
            o = torch.empty(shape, device="cuda")
            before = dropout_sample.launches
            got = dropout_sample.dropout_sample(o, 1064, site, 0.1, base_idx, stride).clone()
            launched = dropout_sample.launches - before
            width = o.numel() // shape[0]
            plain = dropout_sample.dropout_sample_reference(o.numel(), 1064, site, 0.1, base_idx,
                                                            "cuda", width, stride)
            full = fused_layer.dropout_mask(full_shape, 1064, site, 0.1, "cuda").reshape(
                shape[0], -1)[:, base_idx:base_idx + width]
            exact = torch.equal(got.reshape(-1), plain) and torch.equal(
                got.reshape(shape[0], -1), full)
            ms = device_ms(lambda: dropout_sample._launch(o, 1064, site, 0.1, base_idx, stride),
                           names=("dropout_sample",))
            plain_ms = device_ms(lambda: dropout_sample.dropout_sample_reference(
                o.numel(), 1064, site, 0.1, base_idx, "cuda", width, stride))
            nbytes, flops = dropout_sample_cost(o.numel())
            bms, by = bound_ms(nbytes, flops, "float32")
            err = float((got.reshape(-1) - plain).abs().max())
            out["cases"].append(dict(shape=label, dims=list(shape), dtype="float32",
                                     max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                                     bound_by=by, bytes=nbytes, base=base_idx,
                                     row_stride=stride))
            check(exact and launched == 1,
                  f"dropout_sample {label} {list(shape)} (base {base_idx}, row stride {stride}): "
                  f"the kernel equals its plain version and the slice of dropout_mask "
                  f"{list(full_shape)} bit for bit; device ms {ms:.4f}, plain {plain_ms:.4f}, "
                  f"bound {bms:.4f} ({by}), share of bound {bms / ms:.1%}")
            del o, got, plain, full

        # --- (f) the guard -----------------------------------------------------
        grid2 = Grid(device=torch.device("cuda", 0), model_size=2)
        refused = []
        try:
            Pretrainer(pcfg.copy(), dtype=torch.bfloat16, device="cuda", world=grid2)
        except ValueError as exc:
            refused.append("data parallelism only" in str(exc))
        fcfg = get_finetune_config(*FINE_CONFIGS, seed=SEED)
        model, kw = build_finetune_model(fcfg, dtype=torch.bfloat16, device="cuda")
        try:
            Finetuner(fcfg, model, world=grid2, **kw)
        except ValueError as exc:
            refused.append("data parallelism only" in str(exc))
        check(refused == [True, True],
              "tensor-parallel guard: a Pretrainer and a Finetuner on a grid of model size 2 "
              "raise ValueError (data parallelism only)")
        del model

        # --- (g) a li finetune state through .msgpack, resumed on the card -----
        lcfg = get_finetune_config(*FINE_CONFIGS, seed=SEED)
        lcfg.method_name, lcfg.pixelwise, lcfg.patch_sub = "li", True, 1
        lcfg.batch_size = TRAIN_BATCH
        data = SyntheticCubeDataset(num_tiles=TRAIN_BATCH, n_bands=lcfg.n_bands,
                                    n_classes=lcfg.n_classes, seed=SEED)
        store = DeviceTileStore(data, "cuda")

        def li_trainer():
            m, k = build_finetune_model(lcfg, device="cuda")
            return Finetuner(lcfg, m, tile_size=64, **k)

        batches = [np.random.default_rng(60 + k).permutation(TRAIN_BATCH) for k in range(4)]
        xys = [(k, 2 * k) for k in range(4)]
        control, first = li_trainer(), li_trainer()
        for k in range(4):
            control.train_step_idx(store.arrays["img"], store.arrays["label"], batches[k],
                                   xy=xys[k])
        for k in range(2):
            first.train_step_idx(store.arrays["img"], store.arrays["label"], batches[k],
                                 xy=xys[k])
        lpath = os.path.join(tmp, "li_at_step2.msgpack")
        save_checkpoint(lpath, first.state, lcfg, extra={"epoch": 0, "step": 2})
        opt_tree = read_flax_checkpoint(lpath)["opt_state"]
        resumed = li_trainer()
        at = resumed.resume(lpath)
        for k in range(2, 4):
            resumed.train_step_idx(store.arrays["img"], store.arrays["label"], batches[k],
                                   xy=xys[k])
        # optax keeps a rate in float32: the resumed groups hold the rounded rates
        diff = [d for d in states_equal(control.state, resumed.state)
                if d not in ("rng", "optimizer param_groups")]
        groups = [dict(g, params=None) for g in control.state.optimizer.state_dict()["param_groups"]]
        for g in groups:
            g["lr"] = float(np.float32(g["lr"]))
        if groups != [dict(g, params=None)
                      for g in resumed.state.optimizer.state_dict()["param_groups"]]:
            diff.append("optimizer param_groups")
        check(at == 2 and not diff and resumed.state.step == 4 and "inner_states" in opt_tree
              and any("momentum_buffer" in v for v in resumed.state.optimizer.state.values()),
              f"li .msgpack resume: 2 steps, the full state as .msgpack (optax SGD trace in "
              f"head / rest groups), a new Finetuner resumed at step {at} for 2 more: "
              f"parameters, SGD momentum buffers, step and rates equal the 4-step control bit "
              f"for bit (the generator is seeded from the file's key, and the crops are given)"
              + (f" (differ: {diff[:5]})" if diff else ""))
        del control, first, resumed, store
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t_phase
    print(f"     phase 13 wall time {out['seconds']:.1f} s", flush=True)
    return out


class ArrayTiles:
    """A map-style dataset over tiles made in one numpy call: ``img`` [N, C,
    T, T] and, when given, ``label`` [N, T, T]."""

    def __init__(self, img: np.ndarray, label=None):
        self.img, self.label = img, label

    def __len__(self) -> int:
        return self.img.shape[0]

    def __getitem__(self, i: int) -> dict:
        sample = {"img": self.img[i]}
        if self.label is not None:
            sample["label"] = self.label[i]
        return sample


def superstep_tiles(n: int, bands: int, labeled: bool, n_classes: int = 8, tile: int = 64,
                    seed: int = SEED) -> ArrayTiles:
    """n seeded tiles: 64 normal draws, tile i the (i mod 64)-th plus i / n,
    so that no two are alike (drawing all n took 30 s on the card's host)."""
    rng = np.random.default_rng(seed)
    base = rng.standard_normal((64, bands, tile, tile), dtype=np.float32)
    img = np.empty((n, bands, tile, tile), np.float32)
    for i in range(n):
        np.add(base[i % 64], np.float32(i / n), out=img[i])
    return ArrayTiles(img, rng.integers(-1, n_classes, (n, tile, tile)) if labeled else None)


# the eager per-step launches of the recipe's bf16 training step (depth 4 +
# 4): the layer forward, row kernel and layer_wgrad once per layer, the
# embed and SimMIM kernels once
PRETRAIN_STEP = {"fused_layer_fwd": 8, "fused_layer_bwd": 8, "layer_wgrad": 8,
                 "fused_embed_fwd": 1, "fused_embed_bwd": 1, "fused_simmim_fwd": 1,
                 "fused_simmim_bwd": 1}


def phase_superstep(card: str, per_step: dict) -> dict:
    """Phase 14, the trainers' superstep (train/superstep.py): k store-path
    steps a host dispatch as one CUDA graph, held to k single steps from
    one seed: (a) the EnMAP SimMIM pretraining recipe (bf16, batch 64,
    dropout 0.1), 48 steps at steps_per_call 16 against 48 single steps;
    (b) EnMAP-DFC finetuning (bf16, batch 64, embedding dropout 0.1) at k
    8 with a plateau cut of the rate at every epoch end, so every epoch
    captures anew; (c) fp32 pretraining at k 4, two chunks; (d) a k-16 run
    saved at step 24 as .pt and .msgpack and resumed to 48; (e) eager
    against graphed steps in turns on three workloads: steps/s, device
    busy, span and idle share, capture time, the graph pool's memory."""
    import torch

    from maskedsst_tpu_torch.config import get_finetune_config, get_pretrain_config
    from maskedsst_tpu_torch.data.device_store import DeviceTileStore, IndexBatcher
    from maskedsst_tpu_torch.data.pipeline import split_dataset
    from maskedsst_tpu_torch.tools import bench_geometries
    from maskedsst_tpu_torch.train.checkpoint import save_checkpoint
    from maskedsst_tpu_torch.train.factory import build_finetune_model
    from maskedsst_tpu_torch.train.finetuner import Finetuner
    from maskedsst_tpu_torch.train.optim import get_learning_rates, set_learning_rates
    from maskedsst_tpu_torch.train.pretrainer import Pretrainer
    from maskedsst_tpu_torch.utils.profiling import parse_device_trace, trace

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_superstep_")
    out: dict = {"launches": {}}
    try:
        # 1138 tiles, train_fraction 0.9: 1024 train tiles, 16 steps an epoch
        t0 = time.perf_counter()
        pcfg = get_pretrain_config(*PRE_CONFIGS, seed=SEED)
        pcfg.skip_val = True
        pdata = superstep_tiles(1138, pcfg.n_bands, labeled=False)
        fcfg = get_finetune_config(*FINE_CONFIGS, seed=SEED)
        fcfg.batch_size = fcfg.val_batch_size = TRAIN_BATCH
        ftrain = superstep_tiles(16 * TRAIN_BATCH, fcfg.n_bands, True, fcfg.n_classes, seed=1)
        fval = superstep_tiles(TRAIN_BATCH, fcfg.n_bands, True, fcfg.n_classes, seed=2)
        print(f"     phase 14 tiles made in {time.perf_counter() - t0:.1f} s", flush=True)

        def single(trainer):
            """The trainer's fit in single steps: built for chunks of k (its
            optimizer capturable, as the graph route builds it), run at 1."""
            trainer.steps_per_call = 1
            return trainer

        def pretrainer(k, dtype=torch.bfloat16):
            cfg = pcfg.copy()
            cfg.steps_per_call = k
            return Pretrainer(cfg, dtype=dtype, device="cuda")

        def fit(trainer, label, max_steps, *data, **kw):
            seen, metrics = [], []
            recording_steps(trainer, "train_step_idx", seen, metrics)
            reset_counts()
            trainer.fit(*data, epochs=kw.pop("epochs", 10), max_steps=max_steps,
                        tracker=QuietTracker(kw.pop("run", None)),
                        save_checkpoints=kw.pop("save", False), models_dir=tmp, **kw)
            torch.cuda.synchronize()
            out["launches"][label] = launch_counts()
            return seen, metrics

        def held(label, graphed, eager, seen_g, seen_e, met_g, met_e, want, names=("loss",)):
            diff = states_equal(graphed.state, eager.state)
            same = {n: torch.equal(torch.stack([m[n] for m in met_g]),
                                   torch.stack([m[n] for m in met_e])) for n in names}
            sup = graphed.superstep
            check(graphed.route.graph and sup.replays > 0 and not diff and all(same.values())
                  and len(met_g) == len(met_e),
                  f"superstep {label}: {len(met_g)} steps by {sup.replays} graph replays "
                  f"({len(sup.captures)} captures) == {len(met_e)} single steps bit for bit: "
                  f"per-step {', '.join(names)} {same}, every parameter, AdamW moment and "
                  f"step, state.step, the generator (differ: {diff[:6] or 'none'}); route: "
                  f"{graphed.route.reason}")
            check(len(seen_g) == len(met_g) and all(c == want for c in seen_g)
                  and all(c == want for c in seen_e),
                  f"superstep {label}: launches at every step, replays counted by their "
                  f"captures, == eager's {want} (first graphed step {seen_g[:1]})")

        # --- (a) the EnMAP SimMIM pretraining recipe, k 16 vs 1 ---------------
        t0 = time.perf_counter()
        want = per_step["pretrain"]
        check(want == PRETRAIN_STEP, f"superstep: phase 4's eager launches per step {want} == "
                                     f"{PRETRAIN_STEP}")
        graphed, eager = pretrainer(16), single(pretrainer(16))
        sg, mg = fit(graphed, "pretrain_k16", 48, pdata)
        se, me = fit(eager, "pretrain_k1", 48, pdata)
        held("(a) EnMAP pretraining bf16 k 16", graphed, eager, sg, se, mg, me, want)
        out["pretrain_captures"] = graphed.superstep.captures
        control = graphed
        del eager
        print(f"     phase 14 (a) took {time.perf_counter() - t0:.1f} s", flush=True)

        # --- (b) EnMAP-DFC finetuning, k 8 vs 1, a rate cut every epoch -------
        t0 = time.perf_counter()

        def finetuner(k):
            cfg = fcfg.copy()
            cfg.steps_per_call = k
            model, kw = build_finetune_model(cfg, dtype=torch.bfloat16, device="cuda")
            trainer = Finetuner(cfg, model, tile_size=64, **kw)
            # every epoch end cuts the rates: no loss can beat a best of -1
            trainer.scheduler.patience, trainer.scheduler.best = 0, -1.0
            return trainer

        fg, fe = finetuner(8), single(finetuner(8))
        lr0 = get_learning_rates(fg.state.optimizer)
        sfg, mfg = fit(fg, "finetune_k8", 48, ftrain, fval, epochs=3)
        sfe, mfe = fit(fe, "finetune_k1", 48, ftrain, fval, epochs=3)
        rates = [c["k"] for c in fg.superstep.captures]
        check(len(fg.superstep.captures) == 3 and get_learning_rates(fg.state.optimizer) != lr0,
              f"superstep (b): the plateau scheduler cut the rates at every epoch end ({lr0} -> "
              f"{get_learning_rates(fg.state.optimizer)}): {len(rates)} captures of k {rates}, "
              "one an epoch")
        held("(b) EnMAP-DFC finetuning bf16 k 8, the rates cut", fg, fe, sfg, sfe, mfg, mfe,
             per_step["recipe"], names=("loss", "acc", "macro_acc"))
        out["finetune_captures"] = fg.superstep.captures
        del fg, fe
        print(f"     phase 14 (b) took {time.perf_counter() - t0:.1f} s", flush=True)

        # --- (c) fp32 pretraining, k 4, two chunks ----------------------------
        t0 = time.perf_counter()
        graphed32, eager32 = pretrainer(4, None), single(pretrainer(4, None))
        sg, mg = fit(graphed32, "pretrain_fp32_k4", 8, pdata)
        se, me = fit(eager32, "pretrain_fp32_k1", 8, pdata)
        held("(c) EnMAP pretraining fp32 k 4", graphed32, eager32, sg, se, mg, me, se[0])
        del graphed32, eager32
        print(f"     phase 14 (c) took {time.perf_counter() - t0:.1f} s", flush=True)

        # --- (d) a k-16 run saved at step 24, resumed to 48 --------------------
        t0 = time.perf_counter()
        cut = pretrainer(16)
        fit(cut, "pretrain_cut", 24, pdata, run="cut", save=True)
        pt = os.path.join(tmp, "cut", f"model_{pcfg.encoder_name}_at_step24.pt")
        mp = os.path.join(tmp, "cut_at_step24.msgpack")
        save_checkpoint(mp, cut.state, cut.config, extra={"epoch": 1, **cut._scheduler_extra()})
        del cut
        from_pt, from_mp, pt_as_mp = pretrainer(16), pretrainer(16), pretrainer(16)
        at = [from_pt.resume(pt), from_mp.resume(mp), pt_as_mp.resume(pt)]
        # a .msgpack holds a JAX key and float32 rates: the .pt-resumed twin
        # takes the generator and rates the .msgpack gave
        pt_as_mp.state.rng.set_state(from_mp.state.rng.get_state())
        set_learning_rates(pt_as_mp.state.optimizer, get_learning_rates(from_mp.state.optimizer))
        for label, trainer in (("from_pt", from_pt), ("from_msgpack", from_mp),
                               ("pt_as_msgpack", pt_as_mp)):
            fit(trainer, f"resume_{label}", 48, pdata)
        d_pt = states_equal(control.state, from_pt.state)
        d_mp = states_equal(pt_as_mp.state, from_mp.state)
        check(at == [24, 24, 24] and not d_pt and not d_mp,
              f"superstep (d): a k-16 run saved at step 24 (.pt and .msgpack) and resumed to "
              f"48: from the .pt == the uninterrupted k-16 run of (a) bit for bit (differ: "
              f"{d_pt[:6] or 'none'}); from the .msgpack == the .pt's resume under the "
              f".msgpack's generator and float32 rates (differ: {d_mp[:6] or 'none'})")
        del from_pt, from_mp, pt_as_mp, control
        torch.cuda.empty_cache()
        print(f"     phase 14 (d) took {time.perf_counter() - t0:.1f} s", flush=True)

        # --- (e) eager against graphed steps, in turns --------------------------
        t0 = time.perf_counter()
        out["rates"] = {}

        def profiled(fn, steps):
            with trace() as info:
                fn()
            tr = parse_device_trace(info["events"])
            if tr is None or tr.busy_ms <= 0:
                return {"wall_ms": info["wall_s"] * 1e3 / steps}
            return {"wall_ms": info["wall_s"] * 1e3 / steps, "busy_ms": tr.busy_ms / steps,
                    "span_ms": tr.span_ms / steps, "idle_share": tr.idle_share,
                    "overcounted": tr.overcounted}

        def rates_of(name, trainer, single, chunk, batches, k):
            """Windows of len(batches) steps: eager (single steps), graphed
            (chunks of k), graphed, eager; each from its first call to a
            synchronize after its last."""
            n = len(batches)

            def eager_window():
                for b in batches:
                    single(b)

            def graph_window():
                for i in range(0, n, k):
                    chunk(batches[i : i + k])

            graph_window()  # the first chunk runs eagerly, the second is captured
            graph_window()
            eager_window()
            torch.cuda.synchronize()
            walls = {"eager": [], "graph": []}
            peak = {}
            for route in ("eager", "graph", "graph", "eager"):
                torch.cuda.reset_peak_memory_stats()
                t = time.perf_counter()
                (eager_window if route == "eager" else graph_window)()
                torch.cuda.synchronize()
                walls[route].append(time.perf_counter() - t)
                peak[route] = max(peak.get(route, 0), torch.cuda.max_memory_allocated())
            rec = {"steps_per_s": {r: n * len(w) / sum(w) for r, w in walls.items()},
                   "window_steps_per_s": {r: [n / x for x in w] for r, w in walls.items()},
                   "eager": profiled(eager_window, n), "graph": profiled(graph_window, n),
                   "peak_allocated_mib": {r: v / 2**20 for r, v in peak.items()},
                   "reserved_mib": torch.cuda.memory_reserved() / 2**20,
                   "captures": trainer.superstep.captures, "k": k, "steps": n}
            cap = rec["captures"][-1]
            out["rates"][name] = rec

            def dev(r):
                p = rec[r]
                if "busy_ms" not in p:
                    return f"{p['wall_ms']:.3f} ms wall a step, device time not measured"
                return (f"{p['wall_ms']:.3f} ms wall, {p['busy_ms']:.3f} ms busy in a "
                        f"{p['span_ms']:.3f} ms span a step, idle {p['idle_share']:.1%}")

            sps = rec["steps_per_s"]
            print(f"     superstep (e) {name} (k {k}, windows of {n} steps: eager, graph, "
                  f"graph, eager): eager {sps['eager']:.2f} steps/s "
                  f"{[round(x, 2) for x in rec['window_steps_per_s']['eager']]}, graphed "
                  f"{sps['graph']:.2f} steps/s "
                  f"{[round(x, 2) for x in rec['window_steps_per_s']['graph']]}; profiled "
                  f"eager {dev('eager')}; graphed {dev('graph')}; capture of {cap['k']} steps "
                  f"{cap['seconds']:.3f} s, its pool {cap['pool_bytes'] / 2**20:.1f} MiB; peak "
                  f"allocated eager {rec['peak_allocated_mib']['eager']:.1f} MiB, graphed "
                  f"{rec['peak_allocated_mib']['graph']:.1f} MiB, reserved "
                  f"{rec['reserved_mib']:.1f} MiB, on {card}", flush=True)

        trainer = pretrainer(16)
        _, train = split_dataset(pdata, pcfg.train_fraction, pcfg.data_fraction, SEED)
        store = DeviceTileStore(train, "cuda").arrays["img"]
        batches = IndexBatcher(store.shape[0], TRAIN_BATCH, seed=SEED).take(16)
        rates_of("enmap_pretrain_bf16_b64", trainer,
                 lambda b: trainer.train_step_idx(store, b),
                 lambda c: trainer.train_chunk_idx(store, c), list(batches), 16)
        del trainer, store

        trainer, store, idx = bench_geometries.houston_pretrainer(torch.bfloat16, "cuda", 16)
        rates_of("houston_pretrain_bf16_b64", trainer,
                 lambda b: trainer.train_step_idx(store, b),
                 lambda c: trainer.train_chunk_idx(store, c), list(idx), 16)
        del trainer, store

        cfg = fcfg.copy()
        model, kw = build_finetune_model(cfg, dtype=torch.bfloat16, device="cuda")
        trainer = Finetuner(cfg, model, tile_size=64, **kw)
        arrays = DeviceTileStore(ftrain, "cuda").arrays
        batches = IndexBatcher(len(ftrain), TRAIN_BATCH, seed=SEED).take(16)
        rates_of("enmap_dfc_finetune_bf16_b64", trainer,
                 lambda b: trainer.train_step_idx(arrays["img"], arrays["label"], b),
                 lambda c: trainer.train_chunk_idx(arrays["img"], arrays["label"], c),
                 list(batches), 8)
        del trainer, arrays
        torch.cuda.empty_cache()
        print(f"     phase 14 (e) took {time.perf_counter() - t0:.1f} s", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"     phase 14 took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return out


def kernel_entry(name, source, replaces, cases, launches, **extra):
    """One kernel's JSON entry: times of one launch averaged over the main
    paths' bf16 shapes (the serving and training dtype; the layer backward
    at the recipe's dropout 0.1), every case kept under "cases"."""
    main = [c for c in cases if c["dtype"] == "bfloat16"
            and c["shape"] in ("spatial", "spectral", "embed", "simmim")
            and c.get("dropout", 0.1) == 0.1]

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
    os.chdir(os.path.dirname(os.path.abspath(__file__)))
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

    def timed(label, fn, *args):
        print(label, flush=True)
        t = time.perf_counter()
        out = fn(*args)
        print(f"{label.split(' ', 2)[0]} {label.split(' ', 2)[1]} took "
              f"{time.perf_counter() - t:.1f} s", flush=True)
        return out

    gen = torch.Generator().manual_seed(SEED)
    layer_cases, embed_cases = timed("phase 1 forward kernels vs plain versions",
                                     lambda: (phase_layer(gen), phase_embed(gen)))
    (layer_bwd_cases, layer_drop_cases, wgrad_cases), embed_bwd_cases = timed(
        "phase 1b backward kernels vs plain versions (training shapes, batch 64)",
        lambda: (phase_layer_bwd(gen), phase_embed_bwd(gen)))
    simmim_fwd_cases, simmim_bwd_cases = timed(
        "phase 1c SimMIM decode + weighted-L1 kernels vs plain versions", phase_simmim, gen)
    serving, serving_rates = timed("phase 2 serving path: Predictor over the EnMAP-DFC "
                                   "classifier", phase_main, card)
    counts, per_step = timed("phase 3 training path: Finetuner over the EnMAP-DFC classifier",
                             phase_train, card)
    pre_counts, per_step["pretrain"], pre_rates = timed(
        "phase 4 pretraining path: SimMIM Pretrainer on the EnMAP pretrain recipe",
        phase_pretrain, card)
    (drop_launches, drop_model_paths, drop_cases, houston_counts,
     per_step["houston_pretrain"]) = timed(
        "phase 5 tools: kernel_check (kernel #7), Houston2018 pretraining, serving_bench, "
        "bf16_soak", phase_tools, card)
    ckpt = timed("phase 6 checkpoint path: pretraining resume, finetuning from the checkpoint, "
                 "the .pth round trip", phase_checkpoint, card, per_step["pretrain"],
                 per_step["emb_dropout_0"])
    store_dir = tempfile.mkdtemp(prefix="chip_smoke_stores_")
    try:
        real = timed("phase 7 real data path: the .msts store, finetuning and pretraining from "
                     "it, Houston2018 on a full-size scene, the drivers", phase_real_data, card,
                     per_step, store_dir)
        drivers = timed("phase 8 drivers: the prefetch thread, the tracked pretraining driver, "
                        "the sweep driver, the inference example", phase_drivers, card, per_step,
                        real["labeled"])
    finally:
        shutil.rmtree(store_dir, ignore_errors=True)
    dp = timed("phase 9 data-parallel training: 2 ranks on the card over gloo, nccl, the "
               "driver under torchrun", phase_data_parallel, card, per_step)
    other = timed("phase 10 other models: the layer kernels at S = 65, ViTRGB serving and "
                  "finetuning, PatchEmbed + shared-decoder pretraining, SimMIM over V1, the "
                  "legacy SimMIM", phase_other_models, card, gen)
    zoo = timed("phase 11 zoo and HyperX: the 12 DeepHyperX nets, li on the EnMAP-DFC config, "
                "the HyperX CLIs", phase_zoo, card)
    flax = timed("phase 12 the JAX package's .msgpack checkpoints: pretraining and finetuning "
                 "resumed, the encoder loaded, BatchNorm zoo nets; serving over several devices",
                 phase_flax_checkpoint, card, per_step["pretrain"], per_step["emb_dropout_0"],
                 serving_rates["bfloat16"])
    tp = timed("phase 13 tensor parallelism: the head-split layer on 2 and 2 x 2 ranks over "
               "gloo, kernel #7's strided form, the gathered state through .pt and .msgpack, "
               "the trainers' guard, a li .msgpack resume", phase_tensor_parallel, card,
               pre_rates["bfloat16"])
    sup = timed("phase 14 the trainers' superstep: k store steps as one CUDA graph against k "
                "single steps, bit for bit; eager against graphed steps", phase_superstep, card,
                per_step)
    for route, got in sup["launches"].items():
        for kname in ("fused_layer_fwd", "fused_layer_bwd"):
            check(got[kname] > 0, f"phase 14 {route}: {kname} launched {got[kname]} times")
    for r, got in enumerate(tp["launches"]):
        for kname in ("fused_embed_fwd", "fused_embed_bwd", "fused_simmim_fwd",
                      "fused_simmim_bwd", "dropout_sample"):
            check(got[kname] > 0, f"phase 13 tensor-parallel path rank {r}: {kname} launched "
                                  f"{got[kname]} times")
    for kname in ("fused_layer_fwd", "fused_layer_bwd", "layer_wgrad", "fused_embed_fwd",
                  "fused_embed_bwd", "fused_simmim_fwd", "fused_simmim_bwd"):
        check(flax["launches"][kname] > 0,
              f"phase 12 .msgpack paths: {kname} launched {flax['launches'][kname]} times")
    s65_fwd, s65_bwd, s65_wgrad = other["cases"]
    for kname in ("fused_layer_fwd", "fused_layer_bwd", "layer_wgrad"):
        total = sum(got[kname] for got in other["launches"].values())
        check(total > 0, f"phase 10 paths: {kname} launched {total} times")

    batches = sum(math.ceil(n / BATCH) for n in REQUESTS)

    def steps_of(name):
        return {route: c[name] for route, c in per_step.items()}

    kernels = [
        kernel_entry("fused_layer_fwd", "maskedsst_tpu_torch/csrc/fused_layer_fwd.cu",
                     "maskedsst_tpu/ops/fused_layer.py:443",
                     layer_cases + layer_drop_cases + s65_fwd,
                     counts["fused_layer_fwd"], launches_per_step=steps_of("fused_layer_fwd"),
                     launches_serving=serving["bfloat16"]["fused_layer_fwd"],
                     launches_per_serving_batch=serving["bfloat16"]["fused_layer_fwd"] // batches),
        kernel_entry("fused_layer_bwd", "maskedsst_tpu_torch/csrc/fused_layer_bwd.cu",
                     "maskedsst_tpu/ops/fused_layer.py:476", layer_bwd_cases + s65_bwd,
                     counts["fused_layer_bwd"], launches_per_step=steps_of("fused_layer_bwd")),
        kernel_entry("layer_wgrad", "maskedsst_tpu_torch/csrc/layer_wgrad.cu",
                     "maskedsst_tpu/ops/fused_layer.py:476", wgrad_cases + s65_wgrad,
                     counts["layer_wgrad"], launches_per_step=steps_of("layer_wgrad")),
        kernel_entry("fused_embed_fwd", "maskedsst_tpu_torch/csrc/fused_embed_fwd.cu",
                     "maskedsst_tpu/ops/fused_embed.py:89", embed_cases,
                     counts["fused_embed_fwd"], launches_per_step=steps_of("fused_embed_fwd"),
                     launches_serving=serving["bfloat16"]["fused_embed_fwd"],
                     launches_per_serving_batch=serving["bfloat16"]["fused_embed_fwd"] // batches),
        kernel_entry("fused_embed_bwd", "maskedsst_tpu_torch/csrc/fused_embed_bwd.cu",
                     "maskedsst_tpu/ops/fused_embed.py:102", embed_bwd_cases,
                     counts["fused_embed_bwd"], launches_per_step=steps_of("fused_embed_bwd")),
        kernel_entry("fused_simmim_fwd", "maskedsst_tpu_torch/csrc/fused_simmim_fwd.cu",
                     "maskedsst_tpu/ops/fused_simmim.py:52", simmim_fwd_cases,
                     pre_counts["fused_simmim_fwd"],
                     launches_per_step=steps_of("fused_simmim_fwd")),
        kernel_entry("fused_simmim_bwd", "maskedsst_tpu_torch/csrc/fused_simmim_bwd.cu",
                     "maskedsst_tpu/ops/fused_simmim.py:74", simmim_bwd_cases,
                     pre_counts["fused_simmim_bwd"],
                     launches_per_step=steps_of("fused_simmim_bwd")),
    ]
    for entry in kernels[:5]:
        entry["launches_pretrain"] = pre_counts[entry["name"]]
    for entry in kernels:
        entry["launches_houston_pretrain"] = houston_counts[entry["name"]]
        entry["launches_checkpoint_resume"] = ckpt["pretrain_resume"][entry["name"]]
        entry["launches_checkpoint_finetune"] = ckpt["finetune"][entry["name"]]
        entry["launches_real_data"] = real["counts"][entry["name"]]
        entry["launches_drivers"] = drivers["counts"][entry["name"]]
        entry["launches_data_parallel"] = [got[entry["name"]] for got in dp["launches"]]
        entry["launches_other_models"] = {path: got[entry["name"]]
                                          for path, got in other["launches"].items()}
        entry["launches_zoo"] = zoo["launches"][entry["name"]]
        entry["launches_flax_checkpoint"] = flax["launches"][entry["name"]]
        entry["launches_multi_device"] = flax["multi_device"][entry["name"]]
        entry["launches_tensor_parallel"] = [got[entry["name"]] for got in tp["launches"]]
        entry["launches_superstep"] = {route: got[entry["name"]]
                                       for route, got in sup["launches"].items()}
    attn = next(c for c in drop_cases if c["shape"] == "attention_site")
    kernels.append(dict(
        name="dropout_sample", route="cuda", source="maskedsst_tpu_torch/csrc/dropout_sample.cu",
        replaces="scripts/tpu_kernel_check.py:167", launches=drop_launches,
        launches_model_paths=drop_model_paths, launches_drivers=drivers["drop_launches"],
        launches_zoo=zoo["drop_launches"],
        launches_flax_checkpoint=flax["launches"]["dropout_sample"],
        launches_multi_device=flax["multi_device"]["dropout_sample"],
        launches_tensor_parallel=[got["dropout_sample"] for got in tp["launches"]],
        max_abs_err=max(c["max_abs_err"] for c in drop_cases + tp["cases"]),
        ms=attn["ms"], plain_ms=attn["plain_ms"], bound_ms=attn["bound_ms"],
        bound_by=attn["bound_by"], library_ms=None, library_note=LIBRARY_NONE["dropout_sample"],
        cases=drop_cases + tp["cases"]))
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
