"""Device ms of the copies in and out (``Memcpy``) a padded batch of bulk
serving."""

from hsi_bench.readers import BULK, COPIES, traced


def read(ctx):
    tr = traced(ctx, BULK)
    batches = ctx["window"].get("batches", 0)
    if tr is None or batches <= 0:
        return None
    return tr.seconds(COPIES) * 1e3 / batches
