"""The layer forward's share of its roofline in bulk serving: the eight
layer calls' least time a padded batch over ``fused_layer_fwd``'s device
time."""

from hsi_bench import costs
from hsi_bench.readers import BULK, LAYER_FWD, roofline


def read(ctx):
    batch = int(ctx["params"]["batch_size"])
    bound = costs.layers_bound_s(ctx["config"], batch, "fwd")
    return roofline(ctx, BULK, LAYER_FWD, bound, ctx["window"].get("batches", 0))
