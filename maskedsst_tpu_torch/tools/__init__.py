"""On-card check and measurement tools of the port, each run as
``python -m maskedsst_tpu_torch.tools.<name>``:

- ``kernel_check``: every kernel against oracles written in the tool, the
  dropout generator's invariants through the ``dropout_sample`` kernel, and
  each kernel's device time beside its bound;
- ``profile_step``: device time by kernel of pretraining steps or serving
  batches;
- ``bench_geometries``: Houston2018 pretraining and the EnMAP and Houston
  finetune steps: cubes/s, device ms, span and idle share per step;
- ``serving_bench``: Predictor cubes/s by batch and latency by request size;
- ``bf16_soak``: a bf16 and an fp32 pretraining run from the same weights
  and streams, compared over their final window.

Each runs on the card. ``--cpu`` runs it on the CPU through the plain
versions, a rehearsal of its control flow: no device time is measured
there. ``--set KEY=VALUE`` (repeatable) overrides a field of every config
the tool builds, after the tool's own changes, e.g. narrow widths for that
rehearsal.
"""

from __future__ import annotations

import argparse

import torch
import yaml


def add_common_args(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU through the plain versions (no device time)")
    ap.add_argument("--set", dest="overrides", action="append", default=[], metavar="KEY=VALUE",
                    help="override a config field (YAML value) of every config built")


def device_of(args) -> str:
    """"cpu" under ``--cpu``, else "cuda"; exits when there is no card."""
    if args.cpu:
        return "cpu"
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this tool measures the card (--cpu rehearses on the CPU)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return "cuda"


def apply_overrides(cfg, overrides):
    """Sets each ``KEY=VALUE`` of ``overrides`` on ``cfg`` (the value parsed
    as YAML); returns ``cfg``."""
    for item in overrides:
        key, sep, value = item.partition("=")
        if not sep or not key:
            raise ValueError(f"--set takes KEY=VALUE, got {item!r}")
        setattr(cfg, key, yaml.safe_load(value))
    return cfg


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def device_name(device) -> str:
    """The card's name, or "cpu"."""
    return torch.cuda.get_device_name(0) if torch.device(device).type == "cuda" else "cpu"
