"""The layer backward's share of its roofline in training: the eight layer
calls' least time (dX and dW, twice the forward's products) over the
device time of the kernels that do it (the row kernel, its small-vector
reduction, the weight-gradient kernel and its reduction)."""

from hsi_bench.readers import LAYER_BWD, train_layers


def read(ctx):
    return train_layers(ctx, "bwd", LAYER_BWD)
