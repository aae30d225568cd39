"""One module an architecture, named by a configuration's ``reference``
key: its operation counts (the yardstick's per-architecture part), how its
published keys map onto the port's ``ModelConfig``, and how the benchmark
draws each of its weights.  Imports nothing of the program."""

from __future__ import annotations

import importlib


def load(name: str):
    return importlib.import_module(f"bench.arch.{name}")
