"""One run of one cell of the port's benchmark.

    python3 -m hsi_bench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Set-up (the program's start, its kernels built or loaded from
``build/kernels`` in the checkout, the seed's weights and inputs, every
shape the cell uses warmed), then the measured window of ``--seconds``,
untraced (``--trace 0``: the cell's end-to-end metrics) or under the
profiler's CUDA trace (``--trace 1``: its per-layer metrics). Then the
program's state is freed and the plain reference decides ``correct``.
The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device`` (with ``--trace 1``
also ``busy_s``, ``window_s`` and a ``breakdown``), and last ``compared``:
each number compared with its limit, which also close standard error.
Without a CUDA device, or with fewer than the cell's chips, it exits with
2 and prints no result; if JAX or the JAX package is loaded once the run
is over (modules are never unloaded, so this covers the window), with 3.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()  # set-up counts from here, before torch is imported

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from typing import Optional  # noqa: E402

from hsi_bench import registry  # noqa: E402

BANNED = ("jax", "jaxlib", "flax", "maskedsst_tpu")


def loaded_banned() -> list:
    """Top-level names of loaded modules that the port must not pull in,
    compared whole (``maskedsst_tpu_torch`` is the port)."""
    return sorted({m.split(".", 1)[0] for m in sys.modules} & set(BANNED))


def run_cell(name: str, seed: int, seconds: float, traced: bool, device: str = "cuda",
             t0: float = T0, workload: Optional[dict] = None, config: Optional[dict] = None,
             bench: Optional[dict] = None) -> dict:
    """The result of one run; ``workload``, ``config`` and ``bench`` stand in
    for the files of that name (tests)."""
    import torch

    from hsi_bench import trace

    wl = workload or registry.workload(name)
    config = config or registry.config(wl["config"])
    bench = bench or registry.benchmark()
    kind = wl["traffic"]["kind"]
    cuda = device.startswith("cuda")
    cell = registry.traffic(kind).Cell(config, wl["traffic"], seed, device)
    cell.setup()
    setup_s = time.perf_counter() - t0
    with trace.record(traced and cuda) as info:
        win = cell.window(seconds)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    cell.release()
    numbers = cell.compare()
    limits = wl["limits"]
    if set(limits) - set(numbers):
        raise ValueError(f"{name}: limits for numbers the cell does not read: "
                         f"{sorted(set(limits) - set(numbers))}")
    compared = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items() if k in limits}
    correct = all(c["value"] <= c["limit"] for c in compared.values()) and win["failed"] == 0
    tr = info["trace"]
    if "parse_s" in info:
        print(f"trace of {len(tr.events) if tr else 0} device events read in "
              f"{info['parse_s']:.1f} s", file=sys.stderr)
    ctx = {"kind": kind, "config": config[wl["traffic"]["section"]],
           "params": wl["traffic"], "setup_s": setup_s, "window": win, "trace": tr}
    metrics = {}
    for mname, unit in registry.metrics_for(bench, name, traced):
        value = registry.metric(mname).read(ctx)
        if value is not None:
            metrics[mname] = {"value": value, "unit": unit}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": int(wl["chips"]), "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": int(win["attempted"]),
              "failed": int(win["failed"]), "metrics": metrics, "device": dev}
    if traced:
        dev["busy_s"] = tr.busy_s if tr is not None else 0.0
        dev["window_s"] = win["window_s"]
        if tr is not None:
            result["breakdown"] = {"device_ops": tr.top_ops(), "idle_gaps": tr.idle_gaps()}
    for k, v in numbers.items():
        if k not in limits:
            print(f"read, not compared: {k} {v!r}", file=sys.stderr)
    result["compared"] = compared
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    import torch

    wl = registry.workload(args.workload)
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark runs on the card only", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < int(wl["chips"]):
        print(f"{args.workload} needs {wl['chips']} CUDA devices, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), "cuda:0",
                      workload=wl)
    banned = loaded_banned()
    if banned:
        print(f"loaded in the benchmark's process: {', '.join(banned)}", file=sys.stderr)
        return 3
    for k, c in result["compared"].items():
        print(f"compared {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
