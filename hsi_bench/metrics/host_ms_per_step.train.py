"""The host's own work a training step: the ``train.chunk`` spans' time
less the spans inside them where the host waits on the card, over the
steps counted on ``train.chunk``; beside ``device_ms_per_step.train``. The
waits: ``train.stage_wait`` (a pinned buffer's last copy) and
``train.replay`` (a graph launch returns once the card has taken the
previous one: on an H100 it held 95 % of a Houston2018 chunk's host time)."""

from hsi_bench import spans
from hsi_bench.readers import TRAIN

WAITS = ("train.stage_wait", "train.replay")


def read(ctx):
    got = spans.traced(ctx, TRAIN)
    if got is None:
        return None
    _, recs = got
    steps = sum(spans.counted(recs, ("train.chunk",), "steps"))
    if steps <= 0:
        return None
    host = spans.seconds(recs, "train.chunk") - sum(spans.seconds(recs, w) for w in WAITS)
    return 1e3 * host / steps
