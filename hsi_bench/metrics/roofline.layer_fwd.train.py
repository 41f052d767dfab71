"""The layer forward's share of its roofline in training: the eight layer
calls' least time over the device time of ``fused_layer_fwd``."""

from hsi_bench.readers import LAYER_FWD, train_layers


def read(ctx):
    return train_layers(ctx, "fwd", LAYER_FWD)
