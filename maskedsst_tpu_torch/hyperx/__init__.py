"""The DeepHyperX benchmark on the port: a standalone hyperspectral
classification benchmark over the 12 zoo nets (``models/zoo.py``), the
classic scenes, sliding-window full-scene inference and its two CLIs
(``hyperx.main``, ``hyperx.inference``)."""
