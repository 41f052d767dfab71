"""The readings that the limits of ``correct`` are set from, many seeds in
one process, on the card at the cell's own sizes.

    python3 -m hsi_bench.calibrate --workload <name> --seeds 101,102,... \
        [--control-seeds 3] [--seconds 3] [--out chiprun_out/calibrate.jsonl]

For every seed: set-up as a run makes it, then the cell's readings
(``Cell.readings``): the program's numbers as a run reads them and, for
the first ``--control-seeds`` seeds, those of the control and of each
fault that the cell reads in the program's place. One JSON line a seed,
then a summary: each number's largest program reading (the lower
reading) and the smallest reading of every other side. Not run by the
benchmark's own runs.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from hsi_bench import registry


def readings(name: str, seed: int, control: bool, seconds: float, device: str) -> dict:
    wl = registry.workload(name)
    cell = registry.traffic(wl["traffic"]["kind"]).Cell(registry.config(wl["config"]),
                                                        wl["traffic"], seed, device)
    t0 = time.perf_counter()
    cell.setup()
    out = {"seed": seed, "setup_s": time.perf_counter() - t0}
    out.update(cell.readings(control, seconds))
    out["seconds"] = time.perf_counter() - t0
    return out


def summary(rows: list) -> dict:
    """Each number's largest program reading and smallest other readings."""
    out = {}
    for key in rows[0]["numbers"]["program"]:
        entry = {"lower": max(r["numbers"]["program"][key] for r in rows)}
        sides = {s for r in rows for s in r["numbers"] if s != "program"}
        for side in sorted(sides):
            entry[side] = min(r["numbers"][side][key] for r in rows if side in r["numbers"])
        out[key] = entry
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=3.0, help="a serving cell's window")
    ap.add_argument("--out", default=None, help="also append the lines to this file")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    seeds = [int(s) for s in args.seeds.split(",")]
    rows = []
    sink = open(args.out, "a") if args.out else None
    try:
        for i, seed in enumerate(seeds):
            row = {"workload": args.workload,
                   **readings(args.workload, seed, i < args.control_seeds, args.seconds, "cuda:0")}
            rows.append(row)
            line = json.dumps(row)
            print(line, flush=True)
            if sink:
                sink.write(line + "\n")
                sink.flush()
            torch.cuda.empty_cache()
        summary_line = {"workload": args.workload, "summary": summary(rows)}
        print(json.dumps(summary_line), flush=True)
        if sink:
            sink.write(json.dumps(summary_line) + "\n")
    finally:
        if sink:
            sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
