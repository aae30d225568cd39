"""The benchmark of ``repro_torch``, the PyTorch and CUDA port: one cell (a
configuration under a traffic mix) run once by ``python3 bench/run.py``.

Everything a cell needs is found by name in files of its own:
``configs/<name>.json`` (sizes, the port's config id, the reference),
``traffic/<name>.json`` (the entry and its parameters), ``limits/<cell>.json``
(the correctness limits), ``metrics/<metric>.py`` (one reader a metric),
``arch/<name>.py`` (an architecture's operation counts and weight rules)
and ``reference/<name>.py`` (its plain PyTorch reference).  See README.md.
"""
