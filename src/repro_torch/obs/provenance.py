"""Run provenance: who/where/when/what for every sweep JSON the port's
report writes (a copy of the reference's ``repro.obs.provenance``).

:func:`provenance_record` stamps each artifact with a schema version, a UTC
timestamp, the git sha (+dirty marker), host/platform identifiers, the
versions of numpy and torch, the card's name where CUDA is already up in
this process, and an argv snapshot.  Collection is best-effort: a missing
git binary or a non-repo checkout degrades to ``None`` fields, never an
error.  Recording never initialises CUDA.
"""

from __future__ import annotations

import os
import platform
import subprocess
import sys
from datetime import datetime, timezone

__all__ = ["PROVENANCE_SCHEMA", "provenance_record", "git_sha"]

# the reference's schema of the provenance/metrics sections
PROVENANCE_SCHEMA = 1


def git_sha(cwd: str | None = None) -> str | None:
    """``HEAD`` sha with a ``+dirty`` suffix when the tree has local edits;
    ``None`` outside a git checkout or without a git binary."""
    cwd = cwd or os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    try:
        sha = subprocess.run(
            ["git", "rev-parse", "HEAD"], cwd=cwd, capture_output=True,
            text=True, timeout=5).stdout.strip()
        if not sha:
            return None
        dirty = subprocess.run(
            ["git", "status", "--porcelain"], cwd=cwd, capture_output=True,
            text=True, timeout=5).stdout.strip()
        return sha + ("+dirty" if dirty else "")
    except (OSError, subprocess.SubprocessError):
        return None


def provenance_record(argv: list[str] | None = None,
                      extra: dict | None = None) -> dict:
    """The ``provenance`` section of a bench artifact.

    ``argv`` defaults to ``sys.argv``; ``extra`` entries are merged on top
    (e.g. a CLI's resolved sweep parameters).
    """
    try:
        import numpy
        np_version = numpy.__version__
    except ImportError:  # the obs layer itself is numpy-free
        np_version = None
    torch = sys.modules.get("torch")  # recorded where loaded, never imported
    device = None
    if torch is not None and torch.cuda.is_initialized():
        device = torch.cuda.get_device_name(torch.cuda.current_device())
    rec = {
        "schema": PROVENANCE_SCHEMA,
        "timestamp_utc": datetime.now(timezone.utc).isoformat(
            timespec="seconds"),
        "git_sha": git_sha(),
        "host": platform.node(),
        "platform": platform.platform(),
        "python": sys.version.split()[0],
        "numpy": np_version,
        "torch": None if torch is None else torch.__version__,
        "device": device,
        "argv": list(sys.argv if argv is None else argv),
    }
    if extra:
        rec.update(extra)
    return rec
