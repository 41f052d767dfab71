"""Traffic kinds, one module each, found by name (``workloads/<cell>.json``'s
``traffic.kind``). Each defines ``Cell(config, params, seed, device)`` with
``setup()``, ``window(seconds) -> dict``, ``release()`` and ``compare()
-> {number: value}``: set-up, the measured window, freeing the program's
state, and the comparison with the reference that decides ``correct``."""
