"""Plain PyTorch references of the benchmark's architectures, in float32.

They import nothing of the program (``repro_torch``), of the JAX package
or of the harness: they take the weights and inputs the benchmark made
and work out everything else themselves.  ``load(name)`` gives the module
a configuration's ``reference`` key names.
"""

from __future__ import annotations

import importlib


def load(name: str):
    return importlib.import_module(f"bench.reference.{name}")
