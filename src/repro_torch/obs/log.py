"""Module logging for the ``repro_torch`` library.

Library code must not ``print()``: it runs inside worker pools, tests and
other people's scripts.  Every module gets a child of the ``repro_torch`` root
logger via :func:`get_logger`; the CLIs opt into console output with
:func:`configure` driven by a counted ``-v/--verbose`` flag
(:func:`add_verbosity_flag`):

* default — ``WARNING`` (library is silent unless something is wrong)
* ``-v``  — ``INFO``  (phase-level progress)
* ``-vv`` — ``DEBUG`` (per-design / per-stage detail)
"""

from __future__ import annotations

import argparse
import logging
import sys

__all__ = ["get_logger", "configure", "add_verbosity_flag"]

_ROOT = "repro_torch"
_LEVELS = {0: logging.WARNING, 1: logging.INFO, 2: logging.DEBUG}
_FORMAT = "%(asctime)s %(levelname).1s %(name)s: %(message)s"


def get_logger(name: str = _ROOT) -> logging.Logger:
    """Logger under the ``repro_torch`` hierarchy (``get_logger("dse.search")`` →
    ``repro_torch.dse.search``); dunder module names pass through unchanged."""
    if name != _ROOT and not name.startswith(_ROOT + "."):
        name = f"{_ROOT}.{name}"
    return logging.getLogger(name)


def configure(verbosity: int = 0, stream=None) -> logging.Logger:
    """Install (once) a stderr handler on the ``repro_torch`` root and set the
    level from a ``-v`` count: 0 → WARNING, 1 → INFO, ≥2 → DEBUG."""
    root = logging.getLogger(_ROOT)
    root.setLevel(_LEVELS.get(min(int(verbosity), 2), logging.DEBUG))
    if not any(getattr(h, "_repro_obs", False) for h in root.handlers):
        h = logging.StreamHandler(stream or sys.stderr)
        h.setFormatter(logging.Formatter(_FORMAT, datefmt="%H:%M:%S"))
        h._repro_obs = True  # type: ignore[attr-defined]
        root.addHandler(h)
    return root


def add_verbosity_flag(parser: argparse.ArgumentParser) -> None:
    """Add the counted ``-v/--verbose`` flag the CLIs share."""
    parser.add_argument(
        "-v", "--verbose", action="count", default=0,
        help="log more: -v INFO, -vv DEBUG (default WARNING)")
