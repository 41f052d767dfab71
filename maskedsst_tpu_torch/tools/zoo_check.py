"""One training run of every DeepHyperX zoo net on the card (the port's
counterpart of the repo's ``scripts/zoo_tpu_check.py``).

Per net, at its factory geometry (20 classes, 50 bands, chen 100: its
spectral pyramid needs >= 94) and its factory batch size: init, ``--steps``
``HyperXTrainer`` steps on one seeded batch and an eval forward. A net
passes when every loss is finite, the last differs from the first, and the
eval logits are finite. Each row has the steps' host-clock ms (a
synchronize after each, median of all but the first) and, on the card, the
device-busy ms of one step from a trace.

    python -m maskedsst_tpu_torch.tools.zoo_check [--names li,hu,...] [--steps 4]
        [--cpu] [--json-out PATH]

``held_step`` is one step with the dropout off and BatchNorm in training
(the net in eval mode, its BatchNorm and GRU modules in training mode), so
that a step on the card and on the CPU from the same weights on the same
batch can be held to each other, with a float64 CPU step beside them
(``hold_on``); ``chip_smoke.py`` phase 11 does.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
import traceback
from typing import Dict, Tuple

import numpy as np
import torch

N_CLASSES = 20
DEFAULT_BANDS = 50
N_BANDS = {"chen": 100}


def build(name: str, device: str, **overrides):
    """(trainer, hyperparameters) of ``name`` at its factory geometry."""
    from maskedsst_tpu_torch.hyperx.training import HyperXTrainer
    from maskedsst_tpu_torch.models.zoo import get_model

    model, opt, crit, hp = get_model(name, n_classes=N_CLASSES,
                                     n_bands=N_BANDS.get(name, DEFAULT_BANDS),
                                     ignored_labels=[-1], **overrides)
    return HyperXTrainer(model, opt, crit, hp, device=device), hp


def batch_for(hp: Dict, batch: int, seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """A seeded batch of ``batch`` samples in the net's layout, its labels
    per center pixel (per pixel for a dense net)."""
    rng = np.random.default_rng(seed)
    p, bands = hp["patch_size"], hp["n_bands"]
    shape = (batch, bands) if p == 1 else (batch, 1, bands, p, p)
    lshape = (batch,) if hp["center_pixel"] or p == 1 else (batch, p, p)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.integers(0, N_CLASSES, lshape).astype(np.int64))


def held_step(trainer, img, label) -> Tuple[float, Dict[str, torch.Tensor]]:
    """One update with the dropout off and BatchNorm (and the GRU: cuDNN's
    backward needs its training mode) in training; the loss and the
    gradients (float64, on the CPU)."""
    from maskedsst_tpu_torch.models.zoo import BatchNorm

    img, label = trainer._to_device(img, label)
    trainer.model.eval()
    for mod in trainer.model.modules():
        if isinstance(mod, (BatchNorm, torch.nn.RNNBase)):
            mod.train()
    trainer.optimizer.zero_grad(set_to_none=True)
    loss = trainer.loss(trainer.model(img), img, label)
    loss.backward()
    grads = {n: p.grad.detach().cpu().double() for n, p in trainer.model.named_parameters()}
    trainer.optimizer.step()
    return float(loss.detach()), grads


def hold_on(name: str, device: str, batch: int = 8) -> dict:
    """A held step of ``name`` on ``device`` against the same step on the CPU
    from the same weights on the same batch, both fp32, and a float64 CPU
    step beside them: the loss's |difference| over |CPU loss|, and per
    gradient max|device - CPU| over the tensor's max|CPU| (``own``), over
    the net's largest |CPU gradient| (``net``), and the device's and the fp32
    CPU step's distances from the float64 step, each over its max|ref|
    (``fp64_device``, ``fp64_cpu``)."""
    ref, hp = build(name, "cpu")
    dev, _ = build(name, device)  # the same weights: both from the recipe's seed
    ref64, _ = build(name, "cpu")
    ref64.model.double()
    img, label = batch_for(hp, batch, seed=1)
    loss_ref, g_ref = held_step(ref, img, label)
    loss_dev, g_dev = held_step(dev, img, label)
    _, g64 = held_step(ref64, img, label)
    net = max(float(g.abs().max()) for g in g_ref.values())
    rows = {}
    for key, want in g_ref.items():
        scale, scale64 = float(want.abs().max()) or 1.0, float(g64[key].abs().max()) or 1.0
        diff = float((g_dev[key] - want).abs().max())
        rows[key] = {"own": diff / scale, "net": diff / net,
                     "fp64_device": float((g_dev[key] - g64[key]).abs().max()) / scale64,
                     "fp64_cpu": float((want - g64[key]).abs().max()) / scale64}
    return {"name": name, "loss_cpu": loss_ref, "loss_device": loss_dev,
            "loss_rel": abs(loss_dev - loss_ref) / max(abs(loss_ref), 1e-30), "grads": rows}


def check_net(name: str, device: str, steps: int = 4) -> dict:
    from maskedsst_tpu_torch.utils.profiling import traced_busy_ms

    t0 = time.perf_counter()
    trainer, hp = build(name, device)
    init_s = time.perf_counter() - t0
    bs = hp["batch_size"]
    img, label = batch_for(hp, bs)
    img_t, label_t = trainer._to_device(img, label)
    losses, times = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        losses.append(float(trainer.train_step(img_t, label_t)))  # the fetch waits
        times.append(time.perf_counter() - t0)
    logits = trainer.predict(img_t)
    assert all(np.isfinite(v) for v in losses), f"{name}: non-finite loss {losses}"
    assert bool(torch.isfinite(logits).all()), f"{name}: non-finite eval logits"
    assert losses[-1] != losses[0], f"{name}: loss frozen across steps {losses}"
    busy = None
    if trainer.device.type == "cuda":
        busy = traced_busy_ms(lambda: trainer.train_step(img_t, label_t))
    return {"name": name, "ok": True, "loss_first": losses[0], "loss_last": losses[-1],
            "ms_per_step": 1e3 * statistics.median(times[1:]),
            "first_step_ms": 1e3 * times[0], "device_ms_per_step": busy, "init_s": init_s,
            "batch": bs, "geometry": list(img.shape),
            "parameters": sum(p.numel() for p in trainer.model.parameters())}


def run(names, device: str, steps: int = 4) -> dict:
    rows = []
    for name in names:
        try:
            row = check_net(name, device, steps)
        except Exception as exc:  # noqa: BLE001 - recorded, and the run fails
            traceback.print_exc()
            row = {"name": name, "ok": False, "error": str(exc).splitlines()[0][:200]}
        rows.append(row)
        print(json.dumps(row), flush=True)
    dev = torch.device(device)
    return {"metric": "zoo_check",
            "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
            "ok": all(r["ok"] for r in rows), "nets_ok": sum(r["ok"] for r in rows),
            "nets_total": len(rows), "per_net": rows}


def main(argv=None) -> int:
    from maskedsst_tpu_torch.models.zoo import ZOO_NAMES

    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--names", default=",".join(ZOO_NAMES))
    ap.add_argument("--steps", type=int, default=4, help="train steps per net (min 2)")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    ap.add_argument("--json-out", default=None)
    args = ap.parse_args(argv)
    if args.steps < 2:
        ap.error("--steps must be >= 2: the loss must move, and the timing leaves out the first")
    if not args.cpu and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --cpu to run on the CPU")
    record = run(args.names.split(","), "cpu" if args.cpu else "cuda", args.steps)
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(record, f, indent=1)
            f.write("\n")
    print(f"zoo_check: {record['nets_ok']}/{record['nets_total']} ok on {record['device']}")
    return 0 if record["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
