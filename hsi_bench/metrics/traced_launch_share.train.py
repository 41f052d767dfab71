"""The share of the layer kernels' launches that the device trace holds:
the traced launches of ``fused_layer_fwd``, ``fused_layer_bwd`` (the row
kernel) and ``layer_wgrad`` over those the program counted on the window's
``train.replay`` and ``train.eager`` spans (100 when the trace is whole)."""

from hsi_bench import spans
from hsi_bench.readers import TRAIN



def read(ctx):
    got = spans.traced(ctx, TRAIN)
    if got is None:
        return None
    events, recs = got
    counted = sum(launches.get(k, 0) for launches in
                  spans.counted(recs, ("train.replay", "train.eager"), "launches")
                  for k in spans.LAYER_KERNELS)
    if counted <= 0:
        return None
    traced = sum(1 for _, _, name in events if any(k in name for k in spans.LAYER_KERNELS))
    return 100.0 * traced / counted
