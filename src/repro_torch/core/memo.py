"""Search memoization (the "mapping search must scale with mapped
execution" requirement, VW-SDK / Fast-OverlaPIM).

Three cache levels, all keyed on hashable frozen dataclasses:

* **result cache** — full ``LayerMapping`` results of a per-layer search
  (``tetris_layer`` / ``vw_sdk`` / ...), keyed by
  ``(algorithm, layer, array, effective grid, extra kwargs)``.
* **table cache** — grid-*independent* intermediate work of a search
  (the vectorized candidate-window score table, cycles.window_table),
  keyed by ``(layer, array)``.  One macro-grid sweep (Alg 2) re-scores
  the same candidate set under ~P_max.log(P_max) grids; the table is
  built once.
* **disk cache** (opt-in) — an on-disk layer under the result cache so
  a *fresh process* (a cold serving replica, a new ``benchmarks/run.py``
  invocation) skips the window search entirely.  Enabled by pointing
  ``REPRO_MAPPING_CACHE`` at a directory or calling
  :func:`set_disk_cache`; entries are pickled ``LayerMapping`` values in
  one file per key (sha256 of the canonical key repr, prefixed with
  :data:`SCHEMA_VERSION`), written atomically (tmp file + rename) so
  concurrent processes can share a directory.  Invalidation is by
  schema-version bump: bump :data:`SCHEMA_VERSION` whenever the search
  semantics or the ``LayerMapping`` data model change, and stale entries
  simply stop matching (see DESIGN.md §7 for the full rules).
  ``set_disk_cache(dir, max_bytes=...)`` (or
  ``REPRO_MAPPING_CACHE_MAX_BYTES``) bounds the directory: every insert
  prunes oldest-mtime entries first until the total fits (hits refresh
  mtime, so this is an LRU over entries), counted in
  ``stats["disk_evictions"]`` — a capped directory converges instead of
  growing until a schema bump.

Compiled network plans (:mod:`repro.exec.plan`) join the same cache via
:func:`cached_plan`, keyed on (mapping, resolved executor policy, mesh
shape, batch) under their own :data:`PLAN_VERSION` — a serving replica
with a warm disk cache skips both the window search *and* plan
compilation.

Prepared plan constants (:mod:`repro.exec.constants` — the shifted-weight
device buffers co-resident plan tiers share) get their own small
in-memory-only handle cache via :func:`cached_constants`, keyed on the
net mapping: device buffers never touch the disk layer, and a fleet
serving several models materializes each network's constants once.

Autotuner winners (:mod:`repro.tune`) persist through
:func:`load_tuning` / :func:`store_tuning`, keyed on (net mapping,
device-fleet signature, batch profile) under :data:`TUNE_VERSION`.
``load_tuning`` is a *peek* — no compute fallback — so a cold replica
with a warm disk cache adopts the tuned configuration with zero
re-measurement, and a miss simply means "not tuned yet" (callers fall
back to the ``"auto"`` policy).

Both in-memory caches are LRU-bounded (:func:`set_cache_limits`) so a
long-lived serving process cannot grow them without limit; hit / miss /
eviction and disk hit / miss / write counters are surfaced in ``stats``.

Effective grids: a tile's cycle count under grid ``(r, c)`` is
``n_windows * ceil(ar_c / r) * ceil(ac_c / c)`` with ``ar_c <= IC`` and
``ac_c <= OC`` for every candidate the searches enumerate, so every grid
with ``r >= IC`` (resp. ``c >= OC``) yields the *identical* argmin.
:func:`effective_grid` canonicalises the key; the cached mapping is
re-stamped with the caller's real grid (`dataclasses.replace`), which is
bit-identical to searching that grid directly (asserted in
tests/test_search_cache.py).

``disabled()`` turns the whole layer off — including the disk layer —
(benchmarks time the uncached path through it); ``clear()`` + ``stats``
support cache-correctness tests and the search_bench module.  ``clear()``
deliberately leaves the disk directory alone (persistence across
processes is its whole point); use :func:`clear_disk_cache` to wipe it.
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import os
import pickle
import tempfile
from collections import OrderedDict
from pathlib import Path
from typing import Any, Callable, Optional, Tuple

from .types import MacroGrid

_results: "OrderedDict[Any, Any]" = OrderedDict()
_tables: "OrderedDict[Any, Any]" = OrderedDict()
_constants: "OrderedDict[Any, Any]" = OrderedDict()
_enabled: bool = True
_aux_clears: list = []

# In-memory bounds: a whole densenet40 Alg-2 sweep at p_max=16 touches
# ~9k distinct (algorithm, layer, effective-grid) result keys, so the
# bound sits above one flagship sweep while still capping a long-lived
# serving process; tables are per-(layer, array) and much heavier.
_result_limit: int = 16384
_table_limit: int = 256
# shared-constants handles hold live DEVICE buffers (prepared
# shifted-weight blocks, repro.exec.constants) — a handful of co-resident
# networks, never a sweep's worth of entries
_constants_limit: int = 16

#: Bump whenever search semantics or the LayerMapping schema change —
#: on-disk entries written under another version never match again.
SCHEMA_VERSION = 2      # 2: op-kind axis on layer specs (ISSUE 8)

#: Separate version for compiled NetworkPlan entries (:func:`cached_plan`)
#: — bump when the plan IR (exec/plan.py dataclasses) or the compile
#: semantics change without the mapping schema moving.
PLAN_VERSION = 4        # 4: memory estimates + remat segments (ISSUE 10)

#: Version for persisted autotuner winners (:func:`load_tuning` /
#: :func:`store_tuning`) — bump when the TunedConfig schema or the
#: tuning-key layout (repro/tune) changes.
TUNE_VERSION = 2        # 2: Candidate.remat field (ISSUE 10)

_ENV_VAR = "REPRO_MAPPING_CACHE"
_MAX_BYTES_ENV_VAR = "REPRO_MAPPING_CACHE_MAX_BYTES"
_UNSET = object()
_disk_dir: Any = _UNSET        # _UNSET -> resolve from env on first use
_disk_max_bytes: Any = _UNSET  # _UNSET -> resolve from env on first use

stats = {"result_hits": 0, "result_misses": 0, "result_evictions": 0,
         "table_hits": 0, "table_misses": 0, "table_evictions": 0,
         "const_hits": 0, "const_misses": 0, "const_evictions": 0,
         "disk_hits": 0, "disk_misses": 0, "disk_writes": 0,
         "disk_evictions": 0, "disk_errors": 0}


def enabled() -> bool:
    return _enabled


def snapshot() -> dict:
    """Point-in-time copy of :data:`stats`.  Measurement code must read
    counters from a snapshot taken at its phase boundary, never from the
    live dict — later cache traffic (e.g. plan compiles during serving)
    otherwise leaks into an earlier phase's report (the serve_cnn
    search-stats bug, tests/test_serve_cnn.py)."""
    return dict(stats)


def set_cache_limits(results: Optional[int] = None,
                     tables: Optional[int] = None) -> None:
    """Re-bound the in-memory LRU caches (entries, not bytes).  Shrinking
    below the current population evicts oldest-first immediately."""
    global _result_limit, _table_limit
    if results is not None:
        _result_limit = results
        _evict(_results, _result_limit, "result_evictions")
    if tables is not None:
        _table_limit = tables
        _evict(_tables, _table_limit, "table_evictions")


def cache_limits() -> Tuple[int, int]:
    return _result_limit, _table_limit


def register_cache_clear(fn: Callable[[], None]) -> None:
    """Hook an auxiliary cache (e.g. an lru_cache) into :func:`clear`."""
    _aux_clears.append(fn)


class BoundedCounts(dict):
    """Per-key counts of actual (uncached) builds.  Past ``limit`` keys
    the oldest is forgotten, so a long-lived process cannot grow it
    without limit; it resets with :func:`clear`, since a cleared cache
    builds again."""

    def __init__(self, limit: int):
        super().__init__()
        self.limit = limit
        register_cache_clear(self.clear)

    def note(self, key) -> None:
        if key not in self:
            while len(self) >= self.limit:
                del self[next(iter(self))]
            self[key] = 0
        self[key] += 1


def clear() -> None:
    """Reset the in-memory caches and counters (not the disk layer)."""
    _results.clear()
    _tables.clear()
    _constants.clear()
    for fn in _aux_clears:
        fn()
    for k in stats:
        stats[k] = 0


@contextlib.contextmanager
def disabled():
    """Bypass (and do not populate) every cache level inside the block."""
    global _enabled
    prev = _enabled
    _enabled = False
    try:
        yield
    finally:
        _enabled = prev


def effective_grid(grid: MacroGrid, ic: int, oc: int) -> MacroGrid:
    """Clamp a grid to the largest (r, c) that can still change the
    search outcome for a layer with `ic` input / `oc` output channels."""
    return MacroGrid(min(grid.r, ic), min(grid.c, oc))


# ---------------------------------------------------------------------------
# Disk layer
# ---------------------------------------------------------------------------

def set_disk_cache(path: Optional[os.PathLike],
                   max_bytes: Optional[int] = None) -> None:
    """Point the persistent result cache at ``path`` (created on first
    write); ``None`` disables it, overriding the environment variable.
    ``max_bytes`` caps the directory's total entry size: every insert
    prunes least-recently-used entries (by mtime — hits refresh it)
    until the cache fits; ``None`` defers to
    ``REPRO_MAPPING_CACHE_MAX_BYTES`` (unbounded when that is unset
    too)."""
    global _disk_dir, _disk_max_bytes
    if max_bytes is not None and max_bytes < 0:
        raise ValueError(f"max_bytes must be >= 0, got {max_bytes} "
                         f"(omit it for an unbounded cache)")
    _disk_dir = Path(path) if path is not None else None
    _disk_max_bytes = _UNSET if max_bytes is None else max_bytes


def disk_cache_dir() -> Optional[Path]:
    """The active disk-cache directory (env ``REPRO_MAPPING_CACHE``
    unless :func:`set_disk_cache` was called), or ``None``."""
    global _disk_dir
    if _disk_dir is _UNSET:
        env = os.environ.get(_ENV_VAR)
        _disk_dir = Path(env) if env else None
    return _disk_dir


def disk_cache_max_bytes() -> Optional[int]:
    """Active size cap of the disk cache, or ``None`` (unbounded).
    A malformed ``REPRO_MAPPING_CACHE_MAX_BYTES`` raises a clear error —
    silently running uncapped is the exact failure the cap prevents."""
    global _disk_max_bytes
    if _disk_max_bytes is _UNSET:
        env = os.environ.get(_MAX_BYTES_ENV_VAR)
        try:
            _disk_max_bytes = int(env) if env else None
        except ValueError:
            raise ValueError(
                f"{_MAX_BYTES_ENV_VAR}={env!r} is not an integer byte "
                f"count (suffixes like '512M' are not supported)") \
                from None
        if _disk_max_bytes is not None and _disk_max_bytes < 0:
            _disk_max_bytes = _UNSET
            raise ValueError(
                f"{_MAX_BYTES_ENV_VAR}={env!r} must be >= 0 "
                f"(unset it for an unbounded cache)")
    return _disk_max_bytes


def clear_disk_cache() -> int:
    """Remove every entry of the active disk cache; returns the count."""
    d = disk_cache_dir()
    if d is None or not d.is_dir():
        return 0
    n = 0
    for f in d.glob("*.mapping.pkl"):
        try:
            f.unlink()
            n += 1
        except OSError:
            pass
    return n


#: Package namespace folded into every disk key.  ``repr`` of a frozen
#: dataclass names the class but not its module, so without it this
#: package and the JAX package would hash the same key to the same file
#: in a shared ``REPRO_MAPPING_CACHE`` directory and unpickle each
#: other's classes.
NAMESPACE = "repro_torch"


def _disk_path(key: Tuple) -> Path:
    canon = repr((NAMESPACE, SCHEMA_VERSION) + key).encode()
    return disk_cache_dir() / (hashlib.sha256(canon).hexdigest()
                               + ".mapping.pkl")


def _disk_load(key: Tuple) -> Any:
    """Cached value for ``key`` or ``None`` (miss / corrupt / stale)."""
    path = _disk_path(key)
    try:
        with open(path, "rb") as f:
            version, value = pickle.load(f)
    except FileNotFoundError:
        stats["disk_misses"] += 1
        return None
    except Exception:
        stats["disk_errors"] += 1
        with contextlib.suppress(OSError):
            path.unlink()           # corrupt entry: drop, recompute
        return None
    if version != SCHEMA_VERSION:   # belt-and-braces (version is keyed)
        stats["disk_misses"] += 1
        return None
    with contextlib.suppress(OSError):
        os.utime(path)              # refresh mtime: the LRU recency signal
    stats["disk_hits"] += 1
    return value


def _disk_store(key: Tuple, value: Any) -> None:
    d = disk_cache_dir()
    path = _disk_path(key)
    tmp = None
    stored = False
    try:
        d.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
        with os.fdopen(fd, "wb") as f:
            pickle.dump((SCHEMA_VERSION, value), f,
                        protocol=pickle.HIGHEST_PROTOCOL)
        os.replace(tmp, path)       # atomic: concurrent readers see
        stats["disk_writes"] += 1   # either the old file or the new one
        stored = True
    except Exception:               # full disk, unpicklable field, ...:
        stats["disk_errors"] += 1   # the cache layer must never be fatal
        if tmp is not None:
            with contextlib.suppress(OSError):
                os.unlink(tmp)
    if stored:
        # outside the swallow-all handler: a misconfigured size cap
        # (malformed env var) must surface, not count as a disk error
        _disk_prune(keep=path)


def _disk_prune(keep: Optional[Path] = None) -> None:
    """mtime-LRU eviction on insert: drop oldest entries until the
    directory's total entry size fits :func:`disk_cache_max_bytes`.  The
    just-written entry (``keep``) is never evicted — a single oversized
    entry must not thrash the cache it was stored into."""
    limit = disk_cache_max_bytes()
    d = disk_cache_dir()
    if limit is None or d is None or not d.is_dir():
        return
    entries = []
    total = 0
    for f in d.glob("*.mapping.pkl"):
        try:
            st = f.stat()
        except OSError:
            continue                # concurrently evicted by a peer
        total += st.st_size
        if keep is None or f != keep:
            entries.append((st.st_mtime, st.st_size, f))
    entries.sort()                  # oldest mtime first
    for _, size, f in entries:
        if total <= limit:
            break
        with contextlib.suppress(OSError):
            f.unlink()
            total -= size
            stats["disk_evictions"] += 1


# ---------------------------------------------------------------------------
# In-memory LRU levels
# ---------------------------------------------------------------------------

def _evict(cache: "OrderedDict[Any, Any]", limit: int,
           counter: str) -> None:
    while len(cache) > max(0, limit):
        cache.popitem(last=False)
        stats[counter] += 1


def _lru_get(cache: "OrderedDict[Any, Any]", key: Tuple,
             hit_counter: str) -> Any:
    out = cache[key]                # KeyError propagates to the caller
    cache.move_to_end(key)
    stats[hit_counter] += 1
    return out


def _lru_put(cache: "OrderedDict[Any, Any]", key: Tuple, value: Any,
             limit: int, evict_counter: str) -> None:
    cache[key] = value
    cache.move_to_end(key)
    _evict(cache, limit, evict_counter)


def cached_result(key: Tuple, compute: Callable[[], Any],
                  persist: bool = False) -> Any:
    """Result-cache lookup; ``persist=True`` additionally consults /
    populates the disk layer (when one is configured)."""
    if not _enabled:
        return compute()
    try:
        return _lru_get(_results, key, "result_hits")
    except KeyError:
        pass
    stats["result_misses"] += 1
    disk = persist and disk_cache_dir() is not None
    out = _disk_load(key) if disk else None
    if out is None:
        out = compute()
        if disk:
            _disk_store(key, out)
    _lru_put(_results, key, out, _result_limit, "result_evictions")
    return out


def cached_table(key: Tuple, compute: Callable[[], Any]) -> Any:
    if not _enabled:
        return compute()
    try:
        return _lru_get(_tables, key, "table_hits")
    except KeyError:
        pass
    stats["table_misses"] += 1
    out = compute()
    _lru_put(_tables, key, out, _table_limit, "table_evictions")
    return out


def cached_plan(key: Tuple, compute: Callable[[], Any]) -> Any:
    """Compiled-NetworkPlan cache (exec/plan.compile_plan): the result
    cache — and the disk layer, when configured — keyed on (net mapping,
    resolved executor policy, mesh shape, batch, flags) under
    :data:`PLAN_VERSION`."""
    return cached_result(("plan", PLAN_VERSION) + key, compute,
                         persist=True)


def cached_constants(key: Tuple, compute: Callable[[], Any]) -> Any:
    """Shared-constants handle cache (repro.exec.constants, ISSUE 7):
    prepared plan constants — the shifted-weight device buffers every
    tier of a plan ladder shares — keyed on the net mapping (plus the
    resolved executors and the caller's kernel token).  In-memory ONLY:
    the values are live device buffers, which have no business in the
    pickled disk layer; a cold process re-materializes them once per
    network (cheap next to plan compilation).  Bounded by its own small
    LRU (`_constants_limit`): a handful of co-resident networks is the
    design point, and each handle can hold a whole network's weights."""
    if not _enabled:
        return compute()
    try:
        return _lru_get(_constants, key, "const_hits")
    except KeyError:
        pass
    stats["const_misses"] += 1
    out = compute()
    _lru_put(_constants, key, out, _constants_limit, "const_evictions")
    return out


def _tune_key(key: Tuple) -> Tuple:
    return ("tune", TUNE_VERSION) + key


def load_tuning(key: Tuple) -> Any:
    """Persisted-autotuner PEEK: the tuned config stored under ``key``
    (in memory, else on disk when a disk cache is configured), or
    ``None`` on a miss.  Unlike :func:`cached_result` there is no
    ``compute`` fallback — measurement is expensive and belongs to the
    caller (`repro.tune.autotune`); a cold process with a warm disk
    cache therefore loads the tuned config with ZERO measurements
    (asserted via these counters in tests/test_tune.py)."""
    if not _enabled:
        return None
    k = _tune_key(key)
    try:
        return _lru_get(_results, k, "result_hits")
    except KeyError:
        pass
    stats["result_misses"] += 1
    if disk_cache_dir() is None:
        return None
    out = _disk_load(k)
    if out is not None:
        _lru_put(_results, k, out, _result_limit, "result_evictions")
    return out


def store_tuning(key: Tuple, value: Any) -> None:
    """Persist an autotuner winner under ``key`` — the in-memory result
    cache plus the disk layer (when configured), under
    :data:`TUNE_VERSION`."""
    if not _enabled:
        return
    k = _tune_key(key)
    _lru_put(_results, k, value, _result_limit, "result_evictions")
    if disk_cache_dir() is not None:
        _disk_store(k, value)


def memoized_search(name: str, layer, array, grid: MacroGrid,
                    scalar: Callable[[MacroGrid], Any],
                    vectorized: Callable[[MacroGrid], Any],
                    extra: Tuple = ()) -> Any:
    """The per-layer search wrapper every algorithm shares: scalar loop
    when disabled, else the vectorized search cached under the effective
    grid (persistently, when a disk cache is configured), re-stamped with
    the caller's grid."""
    if not _enabled:
        return scalar(grid)
    eff = effective_grid(grid, layer.ic, layer.oc)
    # the op kind rides in the key explicitly (not only via the layer's
    # repr) so a conv and a matmul spec that ever normalise to the same
    # geometry still cannot alias each other's disk entries
    op = getattr(layer, "op", "conv")
    m = cached_result((name, op, layer, array, eff) + tuple(extra),
                      lambda: vectorized(eff), persist=True)
    return m if m.grid == grid else dataclasses.replace(m, grid=grid)
