"""Tiny versions of the cells for CPU tests: the configurations' recipes
at narrow widths (dim 24, one layer a stack, 2 heads, 2 spectral blocks),
small stores and pools, the port's plain versions in float32."""

from __future__ import annotations

import copy

from hsi_bench import registry

WIDTHS = {"transformer_dim": 24, "transformer_depth": 1, "transformer_n_heads": 2,
          "transformer_mlp_dim": 16, "n_bands": 20, "compute_dtype": "float32"}


def config(name: str = "enmap") -> dict:
    cfg = copy.deepcopy(registry.config(name))
    for section in ("pretrain", "serve"):
        if section in cfg:
            cfg[section].update(WIDTHS)
    cfg["pretrain"].update(batch_size=4, steps_per_call=4)
    if "serve" in cfg:
        cfg["serve"]["spectral_pos"] = [0, 1]
    return cfg


def workload(name: str) -> dict:
    wl = copy.deepcopy(registry.workload(name))
    t = wl["traffic"]
    if t["kind"] == "train_superstep":
        t.update(tiles=16, tile_size=min(t["tile_size"], 12))
    elif t["kind"] == "serve_bulk":
        t.update(batch_size=8, call_cubes=32, pool_cubes=64, compared_calls=1)
    else:
        t.update(batch_size=8, min_cubes=2, max_cubes=16, block=8, pool_cubes=64,
                 compared_requests=4)
    return wl
