"""Set-up: from the process's start to the window's start (the program's
start, its kernels built or loaded, weights, inputs, warm-up, capture)."""


def read(ctx):
    return ctx["setup_s"]
