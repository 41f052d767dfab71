"""The program's host spans joined with a traced window's device events,
frozen for the benchmark.

While a profiler runs, the program records what its host does at its
layer boundaries (``maskedsst_tpu_torch/utils/profiling.py::span``): records
``(name, span_id, parent_id, start_ns, end_ns, counts)`` stamped with
``time.time_ns()``. Only :func:`records` reads them from the program; the
arithmetic below takes plain tuples, so that a change to the program cannot
move it.

The attribution rule: each instant of device idle time, from the end of
the device work so far to the next device event's start, inside the
trace's span (the first event's start to the last one's end), goes to the
innermost host span open at that instant: the deepest by parent links, and
of two as deep (two threads), the later started. Instants with no span open
go to :data:`OUTSIDE`.

The join needs the device events on the spans' host clock. The events of
``trace.py`` keep the card's clock as CUPTI maps it onto the host's, which
on an H100 ran up to 8 ms off for seconds of a 20 s serving window, and
they hold none of the API calls that would bound the error. So the metrics
read spans alone (``host_ms_per_step.train``) or count events
(``traced_launch_share.train``); ``attribute.py`` joins the program's own
trace, whose events ``profiling.device_events`` puts on the host clock.
"""

from __future__ import annotations

import heapq
from collections import defaultdict
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

OUTSIDE = "outside"

LAYER_KERNELS = ("fused_layer_fwd", "fused_layer_bwd", "layer_wgrad")  # names the trace holds

Events = Sequence[Tuple[float, float, str]]  # (start, end, name) in seconds, sorted by start


class Span(NamedTuple):
    name: str
    id: int
    parent: Optional[int]
    start: float  # seconds, on the device events' clock
    end: float
    counts: dict


def as_spans(recs: Sequence[tuple]) -> List[Span]:
    """The program's records, nanoseconds made seconds."""
    return [Span(name, i, parent, start / 1e9, end / 1e9, dict(counts))
            for name, i, parent, start, end, counts in recs]


def records() -> Optional[List[Span]]:
    """The spans the program recorded, or None where it records none (a
    program without ``recorded_spans``, or no span in the window)."""
    try:
        from maskedsst_tpu_torch.utils.profiling import recorded_spans
    except ImportError:
        return None
    return as_spans(recorded_spans()) or None


def traced(ctx, kind: str) -> Optional[Tuple[Events, List[Span]]]:
    """(the traced window's device events, the program's spans) of a run of
    ``kind``, or None: untraced, another kind, or no spans to read."""
    tr = ctx["trace"]
    if ctx["kind"] != kind or tr is None or not tr.events:
        return None
    spans = records()
    return None if spans is None else (tr.events, spans)


def idle_gaps(events: Events) -> List[Tuple[float, float, str, str]]:
    """(start, end, the event before, the event after) of each stretch with
    no device work, inside the span."""
    gaps, end, prev = [], None, None
    for start, stop, name in events:
        if end is not None and start > end:
            gaps.append((end, start, prev, name))
        if end is None or stop > end:
            end, prev = stop, name
    return gaps


def _depths(spans: Sequence[Span]) -> Dict[int, int]:
    parent = {s.id: s.parent for s in spans}
    depth: Dict[int, int] = {}
    for s in spans:
        chain, i = [], s.id
        while i in parent and i not in depth:
            chain.append(i)
            i = parent[i]
        d = depth.get(i, -1)
        for j in reversed(chain):
            d += 1
            depth[j] = d
    return depth


def innermost(spans: Sequence[Span]) -> List[Tuple[float, float, int]]:
    """(start, end, span id) pieces of the timeline, in order, over which the
    innermost open span stays the same; stretches with none open left out."""
    depth = _depths(spans)
    bounds = sorted({t for s in spans for t in (s.start, s.end)})
    opening = sorted(spans, key=lambda s: s.start)
    heap: list = []
    pieces: List[Tuple[float, float, int]] = []
    j = 0
    for a, b in zip(bounds, bounds[1:]):
        while j < len(opening) and opening[j].start <= a:
            s = opening[j]
            heapq.heappush(heap, (-depth[s.id], -s.start, s.id, s.end))
            j += 1
        while heap and heap[0][3] <= a:
            heapq.heappop(heap)
        if not heap:
            continue
        sid = heap[0][2]
        if pieces and pieces[-1][2] == sid and pieces[-1][1] == a:
            pieces[-1] = (pieces[-1][0], b, sid)
        else:
            pieces.append((a, b, sid))
    return pieces


def attribute(events: Events, spans: Sequence[Span]) -> Dict[object, float]:
    """Device idle seconds by the id of the innermost span open, and under
    :data:`OUTSIDE` those with none open."""
    pieces = innermost(spans)
    held: Dict[object, float] = defaultdict(float)
    total, j = 0.0, 0
    for g0, g1, _, _ in idle_gaps(events):
        total += g1 - g0
        while j < len(pieces) and pieces[j][1] <= g0:
            j += 1
        k = j
        while k < len(pieces) and pieces[k][0] < g1:
            p0, p1, sid = pieces[k]
            held[sid] += min(p1, g1) - max(p0, g0)
            k += 1
    held[OUTSIDE] = max(0.0, total - sum(held.values()))
    return dict(held)


def by_name(held: Dict[object, float], spans: Sequence[Span]) -> Dict[str, float]:
    """:func:`attribute`'s seconds summed by the innermost span's name."""
    names = {s.id: s.name for s in spans}
    out: Dict[str, float] = defaultdict(float)
    for sid, sec in held.items():
        out[OUTSIDE if sid == OUTSIDE else names[sid]] += sec
    return dict(out)


def within(held: Dict[object, float], spans: Sequence[Span], name: str) -> float:
    """:func:`attribute`'s seconds held by a span named ``name`` or by one
    inside such a span."""
    by_id = {s.id: s for s in spans}

    def under(sid) -> bool:
        while sid in by_id:
            if by_id[sid].name == name:
                return True
            sid = by_id[sid].parent
        return False

    return sum(sec for sid, sec in held.items() if sid != OUTSIDE and under(sid))


def seconds(spans: Sequence[Span], name: str, lo: float = float("-inf"),
            hi: float = float("inf")) -> float:
    """The summed duration of the spans named ``name``, each cut to [lo, hi]."""
    return sum(max(0.0, min(s.end, hi) - max(s.start, lo)) for s in spans if s.name == name)


def counted(spans: Sequence[Span], names: Sequence[str], key: str) -> list:
    """The ``key`` counts of the spans named one of ``names``."""
    return [s.counts[key] for s in spans if s.name in names and key in s.counts]
