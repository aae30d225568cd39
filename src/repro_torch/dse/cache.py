"""Content-hashed persistent mapping cache: the twin of the reference's
``repro.dse.cache``.

The mapper is the DSE hot path: ``best_mapping`` enumerates spatial
factorizations × tile splits × loop orders per layer, and a sweep evaluates
every (design, layer) pair.  Layer shapes repeat heavily, so mapping results
are cached under a content hash of *everything that determines the result*:
workload name, true dims, the spatial-dataflow menu, the full ``HWConfig``,
data-node counts, PPU elements and the objective.  The key carries no
engine: every engine returns byte-identical winners.

The store is a single JSON file in the reference's format (schema, entries,
per-entry checksums), so a file either package writes is one the other
loads, entry for entry a hit.  ``save`` writes atomically (temp file +
rename) under a lock file with read-**merge**-write semantics (entries of
concurrent sweeps sharing the path converge into a union;
``mapper_cache.lock_waits`` counts contention; stale locks are broken after
a timeout); ``load`` quarantines corrupt entries individually
(``mapper_cache.corrupt_entries``).

The mapper front door (:meth:`MappingCache.best_mapping_perfs`) answers
hits from the store and solves all misses of a query batch in one
:func:`~repro_torch.core.mapper_batch.best_mappings` pass; with
``engine="torch"`` the candidates are scored on ``device`` (the card
unless the caller names the CPU).
"""

from __future__ import annotations

import hashlib
import json
import os
import tempfile
import time
from contextlib import contextmanager

from ..core.mapper import Mapping, SpatialChoice, best_mapping
from ..core.mapper_batch import best_mappings
from ..core.perf_model import HWConfig, LayerPerf
from ..core.workload import Workload
from ..obs import METRICS, get_logger

__all__ = ["MappingCache", "mapping_key", "atomic_write_json",
           "entry_checksum"]

_LOG = get_logger("dse.cache")

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

    Waiting bumps ``mapper_cache.lock_waits`` once per acquisition; locks
    older than ``_LOCK_STALE_S`` (or held past ``timeout``) are broken —
    a sweep must never deadlock on the leavings of a crashed process."""
    lock = path + ".lock"
    d = os.path.dirname(os.path.abspath(lock)) or "."
    os.makedirs(d, exist_ok=True)
    t0 = time.monotonic()
    waited = False
    while True:
        try:
            fd = os.open(lock, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
            os.write(fd, str(os.getpid()).encode())
            os.close(fd)
            break
        except FileExistsError:
            if not waited:
                waited = True
                METRICS.counter("mapper_cache.lock_waits").inc()
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
        self._journal: dict[str, dict] = {}  # entries put() since last drain
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
            METRICS.counter("mapper_cache.schema_evictions").inc()
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
            METRICS.counter("mapper_cache.corrupt_entries").inc(corrupt)
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
            METRICS.counter("mapper_cache.load_failures").inc()
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
        self._journal.clear()  # persisted — nothing left to ship anywhere

    # -- raw access -------------------------------------------------------
    def contains(self, key: str) -> bool:
        """Membership probe that does **not** count toward hit/miss stats —
        the design-batched prefill (:mod:`repro_torch.dse.batch_sweep`)
        uses it to plan which (design, query) entries still need solving
        without skewing the cache telemetry the sweep's JSON reports."""
        return key in self._store

    def get(self, key: str) -> dict | None:
        e = self._store.get(key)
        if e is None:
            self.misses += 1
            METRICS.counter("mapper_cache.misses").inc()
        else:
            self.hits += 1
            METRICS.counter("mapper_cache.hits").inc()
        return e

    def put(self, key: str, value: dict) -> None:
        self._store[key] = value
        self._journal[key] = value
        self._dirty = True

    def snapshot(self) -> dict[str, dict]:
        """The live entry dict (read-only by convention) — ships the warm
        parent cache into freshly spawned sweep workers."""
        return self._store

    def drain_new(self) -> dict[str, dict]:
        """Entries ``put()`` since the last drain (journal is cleared).

        O(new entries) — the parallel-sweep workers call this after every
        design evaluation to ship only fresh mapping results back to the
        parent, instead of re-scanning the whole store."""
        new, self._journal = self._journal, {}
        return new

    def merge(self, entries: dict[str, dict]) -> int:
        """Adopt entries computed elsewhere (a worker process); returns the
        number of new keys.  Entries are content-addressed and the mapper is
        deterministic, so colliding keys are identical — first write wins."""
        new = 0
        for k, v in entries.items():
            if k not in self._store:
                self._store[k] = v
                new += 1
        if new:
            self._dirty = True
        return new

    @property
    def stats(self) -> dict:
        total = self.hits + self.misses
        return {"entries": len(self._store), "hits": self.hits,
                "misses": self.misses,
                "hit_rate": self.hits / total if total else 0.0}

    # -- mapper front door -------------------------------------------------
    def best_mapping_perf(self, wl: Workload, dims: dict[str, int],
                          spatials: list[SpatialChoice], hw: HWConfig,
                          data_nodes_per_tensor: dict[str, int] | None = None,
                          ppu_elements: float = 0.0,
                          objective: str = "cycles",
                          engine: str = "numpy",
                          device="cuda") -> LayerPerf:
        """Cached ``best_mapping`` returning the winning :class:`LayerPerf`.

        The entry also records the winning spatial-dataflow name, retrievable
        via :meth:`lookup_spatial`.  ``engine`` selects how misses are
        solved (``device`` is where ``engine="torch"`` scores them); it is
        deliberately **not** part of :func:`mapping_key` — every engine
        returns byte-identical winners, so an entry computed by one engine
        is a valid hit for all of them.
        """
        key = mapping_key(wl, dims, spatials, hw, data_nodes_per_tensor,
                          ppu_elements, objective)
        e = self.get(key)
        if e is not None:
            return LayerPerf.from_dict(e["perf"])
        m: Mapping = best_mapping(
            wl, dims, spatials, hw,
            data_nodes_per_tensor=data_nodes_per_tensor,
            ppu_elements=ppu_elements, objective=objective, engine=engine,
            device=device)
        self.put(key, {"perf": m.perf.as_dict(),
                       "spatial": m.spatial.name,
                       "dataflow": m.dataflow.name})
        return m.perf

    def best_mapping_perfs(self, wl: Workload,
                           queries: list[tuple[dict, float]],
                           spatials: list[SpatialChoice], hw: HWConfig,
                           data_nodes_per_tensor: dict[str, int] | None = None,
                           objective: str = "cycles",
                           engine: str = "numpy",
                           device="cuda") -> list[LayerPerf]:
        """Batched :meth:`best_mapping_perf` over ``(dims, ppu_elements)``
        queries sharing one workload/spatial-menu/data-node shape.

        Cache hits are answered immediately; all misses are solved in a
        single vectorized :func:`~repro_torch.core.mapper_batch.best_mappings`
        pass — this is the DSE evaluator's per-(design, workload-kind)
        front door.  ``engine`` selects the miss solver only (``"torch"``
        scores every candidate of the misses in one dispatch on
        ``device``): keys carry no engine field, so caches are
        interchangeable across engines (``engine="scalar"`` falls back to
        per-query reference solves).
        """
        keys = [mapping_key(wl, dims, spatials, hw, data_nodes_per_tensor,
                            ppu, objective) for dims, ppu in queries]
        out: list[LayerPerf | None] = [None] * len(queries)
        miss: list[int] = []
        for i, k in enumerate(keys):
            e = self.get(k)
            if e is not None:
                out[i] = LayerPerf.from_dict(e["perf"])
            else:
                miss.append(i)
        if miss:
            if engine == "scalar":
                solved = [best_mapping(
                    wl, queries[i][0], spatials, hw,
                    data_nodes_per_tensor=data_nodes_per_tensor,
                    ppu_elements=queries[i][1], objective=objective,
                    engine="scalar") for i in miss]
            else:
                solved = best_mappings(
                    wl, [queries[i] for i in miss], spatials, hw,
                    data_nodes_per_tensor=data_nodes_per_tensor,
                    objective=objective, engine=engine, device=device)
            for i, m in zip(miss, solved):
                self.put(keys[i], {"perf": m.perf.as_dict(),
                                   "spatial": m.spatial.name,
                                   "dataflow": m.dataflow.name})
                out[i] = m.perf
        return out  # type: ignore[return-value]

    def lookup_spatial(self, wl: Workload, dims: dict[str, int],
                       spatials: list[SpatialChoice], hw: HWConfig,
                       data_nodes_per_tensor: dict[str, int] | None = None,
                       ppu_elements: float = 0.0,
                       objective: str = "cycles") -> str | None:
        """Winning spatial-dataflow name for a query already in the cache."""
        key = mapping_key(wl, dims, spatials, hw, data_nodes_per_tensor,
                          ppu_elements, objective)
        e = self._store.get(key)
        return e["spatial"] if e else None
