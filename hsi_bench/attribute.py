"""Where the device's idle time goes in one traced window of a cell: the
program's host spans joined with its device events (``spans.py``).

    python3 -m hsi_bench.attribute --workload <name> --seed <n> --seconds <s>

Set-up as ``run.py`` makes it, then one window under the program's own
trace (``maskedsst_tpu_torch/utils/profiling.py::trace``), whose device
events ``profiling.device_events`` puts on the spans' host clock from the
trace's API calls; no reference runs. Prints one JSON object: the card,
the window's counts; ``clock``, the largest shift that put an event on the
host clock and how far each upload (``Memcpy HtoD``) starts outside the
nearest ``serve.copy_in`` span, the check that the clocks agree (a
pageable upload runs while the host waits in its span); ``idle``, the
device idle time by the innermost span open (``outside`` where none is),
as ms a batch (serving) or a step (training) and as % of all idle time,
and the idle share inside ``serve.call``; ``gaps``, the longest idle gaps,
each with the device events on either side and split by span; ``spans``,
each name's count and summed ms; ``launches``, the layer kernels' launches
traced and counted on the spans. Exits with 2 without a card.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()  # set-up counts from here, as in run.py

import argparse  # noqa: E402
import bisect  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from collections import defaultdict  # noqa: E402

from hsi_bench import readers, registry, spans, trace  # noqa: E402


def upload_offsets_us(events, recs) -> dict:
    """How far each ``Memcpy HtoD`` starts outside the nearest
    ``serve.copy_in`` span, in us (0 inside one)."""
    ups = sorted((s.start, s.end) for s in recs if s.name == "serve.copy_in")
    if not ups:
        return {}
    starts = [a for a, _ in ups]
    offsets = []
    for t, _, name in events:
        if "Memcpy HtoD" not in name:
            continue
        i = bisect.bisect_right(starts, t) - 1
        before = t - ups[i][1] if i >= 0 else float("inf")
        after = starts[i + 1] - t if i + 1 < len(ups) else float("inf")
        offsets.append(float(max(0.0, min(before, after))) * 1e6)
    return {"copies": len(offsets), "over_50us": sum(o > 50 for o in offsets),
            "max_us": max(offsets, default=0.0)}


def report(events, recs, kind: str) -> dict:
    unit, key = ("step", "steps") if kind == readers.TRAIN else ("batch", "batches")
    per = sum(spans.counted(recs, ("train.chunk", "serve.call"), key))
    held_by_id = spans.attribute(events, recs)
    held = spans.by_name(held_by_id, recs)
    idle = sum(held.values())
    out = {key: per, "idle_ms": idle * 1e3, "idle": {
        name: {f"ms_per_{unit}": s * 1e3 / per if per else None,
               "share_of_idle": 100 * s / idle if idle else None}
        for name, s in sorted(held.items(), key=lambda kv: -kv[1])}}
    lo, hi = events[0][0], max(end for _, end, _ in events)
    in_calls = spans.seconds(recs, "serve.call", lo, hi)
    if in_calls > 0:
        out["idle_in_call_share"] = 100 * spans.within(held_by_id, recs, "serve.call") / in_calls
    out["gaps"] = [{"ms": (b - a) * 1e3, "after": str(before)[:64], "before": str(after)[:64],
                    "held_ms": {k: v * 1e3 for k, v in spans.by_name(
                        spans.attribute([(a, a, ""), (b, b, "")], recs), recs).items() if v}}
                   for a, b, before, after in sorted(spans.idle_gaps(events),
                                                     key=lambda g: g[0] - g[1])[:10]]
    totals = defaultdict(lambda: [0, 0.0])
    for s in recs:
        totals[s.name][0] += 1
        totals[s.name][1] += (s.end - s.start) * 1e3
    out["spans"] = {k: {"count": c, "ms": ms} for k, (c, ms) in sorted(totals.items())}
    if kind == readers.TRAIN:
        counted = defaultdict(int)
        for launches in spans.counted(recs, ("train.replay", "train.eager"), "launches"):
            for k in spans.LAYER_KERNELS:
                counted[k] += launches.get(k, 0)
        out["launches"] = {k: {"traced": sum(1 for _, _, n in events if k in n),
                               "counted": counted[k]} for k in spans.LAYER_KERNELS}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    import torch

    from maskedsst_tpu_torch.utils import profiling

    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark runs on the card only", file=sys.stderr)
        return 2
    wl = registry.workload(args.workload)
    kind = wl["traffic"]["kind"]
    cell = registry.traffic(kind).Cell(registry.config(wl["config"]), wl["traffic"], args.seed,
                                       "cuda:0")
    cell.setup()
    setup_s = time.perf_counter() - T0
    with profiling.trace() as info:
        win = cell.window(args.seconds)
    tr = trace.parse(info["events"])
    recs = spans.as_spans(info["spans"])
    out = {"workload": args.workload, "seed": args.seed, "card": torch.cuda.get_device_name(0),
           "setup_s": setup_s, "attempted": win["attempted"], "failed": win["failed"],
           "window_s": win["window_s"], "busy_s": tr.busy_s if tr else 0.0,
           "span_s": tr.span_s if tr else 0.0,
           "idle_share": 100 * tr.idle_share if tr else None,
           "clock": {"shift_max_us": info["clock_shift_us"]}}
    if tr is not None and recs:
        out["clock"].update(upload_offsets_us(tr.events, recs))
        out.update(report(tr.events, recs, kind))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
