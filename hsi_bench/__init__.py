"""The benchmark of the PyTorch and CUDA port (``maskedsst_tpu_torch``).

    python3 -m hsi_bench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

A cell is ``workloads/<name>.json`` (its configuration, traffic kind and
parameters, chips, limits and why); a configuration is
``configs/<name>.json``; a traffic kind is ``traffic/<kind>.py``; each
metric, end to end or per layer, is ``metrics/<name>.py``. ``run.py``
finds all of them by name, so a later cell or metric is new files and a
new ``BENCHMARK.json`` entry. ``costs.py``, ``trace.py`` and
``reference/`` are the yardstick: frozen operation and byte counts, the
trace accounting and the card's peaks, and the plain fp32 reference that
decides ``correct``. Nothing here imports JAX or the JAX package; the
reference imports nothing of the port either.
"""
