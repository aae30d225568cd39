"""Content-hashed persistent mapping cache: the storage half of the
reference's ``repro.dse.cache``.

Mapping results are cached under a content hash of *everything that
determines the result*: workload name, true dims, the spatial-dataflow menu,
the full ``HWConfig``, data-node counts, PPU elements and the objective.
The key carries no engine: every engine returns byte-identical winners.

The store is a single JSON file in the reference's format (schema, entries,
per-entry checksums), so a file this module writes is one the reference's
``MappingCache`` loads, and the reverse — the state the port's prefill
carries across to the reference's NumPy evaluation.  ``save`` writes
atomically (temp file + rename) under a lock file with read-merge-write
semantics; ``load`` quarantines corrupt entries individually.  The mapper
front door (``best_mapping_perf(s)``) stays the reference's: the port fills
the cache in design-batched prefills (:mod:`repro_torch.dse.batch_sweep`).
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import tempfile
import time
from contextlib import contextmanager

from ..core.mapper import SpatialChoice
from ..core.perf_model import HWConfig
from ..core.workload import Workload

__all__ = ["MappingCache", "mapping_key", "atomic_write_json",
           "entry_checksum"]

_LOG = logging.getLogger("repro_torch.dse.cache")

_SCHEMA = 3  # the reference's schema: bumped there when the perf model changes

_LOCK_TIMEOUT_S = 10.0   # give up waiting and break the lock after this
_LOCK_STALE_S = 30.0     # a lock older than this is from a dead process
_LOCK_POLL_S = 0.05


def atomic_write_json(path: str, payload, **dump_kw) -> None:
    """Write JSON via temp file + rename so readers never see a torn file."""
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(payload, f, **dump_kw)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def entry_checksum(value: dict) -> str:
    """Content checksum of one cache-entry payload (stored next to the
    entry on ``save``, verified on ``load``)."""
    blob = json.dumps(value, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


@contextmanager
def _cache_lock(path: str, timeout: float = _LOCK_TIMEOUT_S):
    """Exclusive advisory lock on ``path`` via an ``O_EXCL`` lock file.

    Locks older than ``_LOCK_STALE_S`` (or held past ``timeout``) are broken —
    a sweep must never deadlock on the leavings of a crashed process."""
    lock = path + ".lock"
    d = os.path.dirname(os.path.abspath(lock)) or "."
    os.makedirs(d, exist_ok=True)
    t0 = time.monotonic()
    while True:
        try:
            fd = os.open(lock, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
            os.write(fd, str(os.getpid()).encode())
            os.close(fd)
            break
        except FileExistsError:
            try:
                age = time.time() - os.path.getmtime(lock)
            except OSError:
                continue  # holder released between open and stat — retry
            if age > _LOCK_STALE_S or time.monotonic() - t0 > timeout:
                _LOG.warning("breaking stale mapping-cache lock %s "
                             "(age %.1fs)", lock, age)
                try:
                    os.unlink(lock)
                except OSError:
                    pass
                continue
            time.sleep(_LOCK_POLL_S)
    try:
        yield
    finally:
        try:
            os.unlink(lock)
        except OSError:
            pass


def mapping_key(wl: Workload, dims: dict[str, int],
                spatials: list[SpatialChoice], hw: HWConfig,
                data_nodes_per_tensor: dict[str, int] | None,
                ppu_elements: float, objective: str) -> str:
    """Stable content hash of one mapping query."""
    payload = {
        "schema": _SCHEMA,
        "workload": wl.name,
        "iter_dims": list(wl.iter_dims),
        "dims": sorted(dims.items()),
        "spatials": [[list(s.dims), list(s.c), s.name] for s in spatials],
        "hw": [[k, v] for k, v in hw.signature()],
        "data_nodes": sorted((data_nodes_per_tensor or {}).items()),
        "ppu_elements": float(ppu_elements),
        "objective": objective,
    }
    blob = json.dumps(payload, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()[:32]


class MappingCache:
    """Dict-backed cache with optional JSON persistence."""

    def __init__(self, path: str | os.PathLike | None = None,
                 autoload: bool = True):
        self.path = os.fspath(path) if path is not None else None
        self._store: dict[str, dict] = {}
        self.hits = 0
        self.misses = 0
        self._dirty = False
        if autoload and self.path and os.path.exists(self.path):
            self.load()

    def __len__(self) -> int:
        return len(self._store)

    # -- persistence ------------------------------------------------------
    def _validated_entries(self, payload, path: str) -> dict | None:
        """Schema-check a loaded payload and drop corrupt entries.

        Returns the checksum-valid entry dict, or ``None`` on a schema
        mismatch (stale cache: evict wholesale).  Corrupt entries are
        quarantined *individually* — a single flipped byte in a shared
        store must cost one recompute, not the whole warm cache."""
        schema = payload.get("schema")
        if schema != _SCHEMA:
            _LOG.warning("mapping cache %s has schema %r (want %d) — "
                         "evicting stale cache", path, schema, _SCHEMA)
            return None
        entries = payload.get("entries", {})
        sums = payload.get("sums", {})
        good: dict[str, dict] = {}
        corrupt = 0
        for k, v in entries.items():
            s = sums.get(k)
            if s is not None and s != entry_checksum(v):
                corrupt += 1
                continue
            good[k] = v
        if corrupt:
            _LOG.warning("mapping cache %s: quarantined %d corrupt "
                         "entr%s (checksum mismatch), kept %d", path,
                         corrupt, "y" if corrupt == 1 else "ies", len(good))
        return good

    def load(self, path: str | None = None) -> int:
        path = path or self.path
        if not path or not os.path.exists(path):
            return 0
        try:
            with open(path) as f:
                payload = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            # unreadable cache == cold cache, never fatal — but a sweep
            # that *should* have been warm must be diagnosable
            _LOG.warning("mapping cache %s unreadable (%s: %s) — starting "
                         "cold", path, type(e).__name__, e)
            return 0
        entries = self._validated_entries(payload, path)
        if entries is None:
            return 0
        self._store.update(entries)
        return len(self._store)

    def save(self, path: str | None = None) -> None:
        """Persist under a lock file with read-merge-write semantics.

        Concurrent sweeps sharing one cache path converge to the union of
        their entries: the on-disk store is re-read under the lock, its
        still-valid entries are adopted, and the merged store is written
        atomically.  Entries are content-addressed and the mapper is
        deterministic, so colliding keys are identical — in-memory wins."""
        path = path or self.path
        if not path or not self._dirty:
            return
        with _cache_lock(path):
            if os.path.exists(path):
                try:
                    with open(path) as f:
                        on_disk = self._validated_entries(json.load(f), path)
                except (OSError, json.JSONDecodeError):
                    on_disk = None  # torn foreign write: overwrite it
                if on_disk:
                    for k, v in on_disk.items():
                        self._store.setdefault(k, v)
            atomic_write_json(
                path,
                {"schema": _SCHEMA, "entries": self._store,
                 "sums": {k: entry_checksum(v)
                          for k, v in self._store.items()}},
                separators=(",", ":"))
        self._dirty = False

    # -- raw access -------------------------------------------------------
    def contains(self, key: str) -> bool:
        """Membership probe that does **not** count toward hit/miss stats —
        the design-batched prefill (:mod:`repro_torch.dse.batch_sweep`)
        uses it to plan which (design, query) entries still need solving
        without skewing the cache statistics."""
        return key in self._store

    def get(self, key: str) -> dict | None:
        e = self._store.get(key)
        if e is None:
            self.misses += 1
        else:
            self.hits += 1
        return e

    def put(self, key: str, value: dict) -> None:
        self._store[key] = value
        self._dirty = True

    @property
    def stats(self) -> dict:
        total = self.hits + self.misses
        return {"entries": len(self._store), "hits": self.hits,
                "misses": self.misses,
                "hit_rate": self.hits / total if total else 0.0}
