"""The share of the rows the model was called on (counted by a forward
pre-hook on the served model) that are padding: 1 − cubes asked ÷ rows."""

from hsi_bench.readers import REQUESTS


def read(ctx):
    win = ctx["window"]
    if ctx["kind"] != REQUESTS or not win.get("rows_called"):
        return None
    return 100.0 * (1.0 - win["cubes_asked"] / win["rows_called"])
