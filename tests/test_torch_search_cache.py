"""The port's memoized search (repro_torch.core.memo) against the JAX
package's: the counterparts of tests/test_search_cache.py — memoized +
vectorized search == the scalar reference search bit for bit, the LRU
bounds and the persistent on-disk result cache — each held to the JAX
package's mappings field by field where a case maps.

Two differences of the port's ``memo.py`` are stated here as tests:
its disk file names hash ``(NAMESPACE, SCHEMA_VERSION) + key`` with
``NAMESPACE = "repro_torch"``, so both packages can share one
``REPRO_MAPPING_CACHE`` directory without reading each other's pickles;
and it adds ``BoundedCounts``, the bounded per-key build counters of
plans and constants, which forget the oldest key past their limit and
reset with ``memo.clear``."""
import dataclasses
import os
import random
import subprocess
import sys
import time

import pytest

pytest.importorskip("torch")

from repro import core as jcore                                 # noqa: E402
from repro.core import memo as jmemo                            # noqa: E402
from repro_torch.core import (ArrayConfig, ConvLayerSpec,       # noqa: E402
                              MacroGrid, baselines, grid_search, map_layer,
                              map_net, memo, networks, tetris)


@pytest.fixture
def disk_cache(tmp_path):
    """Point the disk layer at a temp dir; restore pristine state after."""
    memo.clear()
    memo.set_disk_cache(tmp_path)
    try:
        yield tmp_path
    finally:
        memo.set_disk_cache(None)
        memo.clear()


@pytest.fixture
def cache_limits():
    prev = memo.cache_limits()
    try:
        yield
    finally:
        memo.set_cache_limits(*prev)


def _same(port, ref):
    assert dataclasses.astuple(port) == dataclasses.astuple(ref)


def _jax_twin(layer, arr, grid):
    return (jcore.ConvLayerSpec(layer.name, layer.i_h, layer.i_w, layer.k_h,
                                layer.k_w, layer.ic, layer.oc,
                                stride=layer.stride),
            jcore.ArrayConfig(arr.ar, arr.ac), jcore.MacroGrid(grid.r, grid.c))


def _random_cases(n, seed=3):
    rng = random.Random(seed)
    out = []
    while len(out) < n:
        i = rng.randint(5, 22)
        k = rng.choice([1, 3, 5])
        if i < k:
            continue
        layer = ConvLayerSpec("r", i, i, k, k, rng.randint(1, 48),
                              rng.randint(1, 64),
                              stride=rng.choice([1, 1, 2]))
        arr = ArrayConfig(rng.choice([64, 128, 256, 512]),
                          rng.choice([64, 128, 256, 512]))
        if k * k > arr.ar:
            continue
        grid = MacroGrid(rng.randint(1, 4), rng.randint(1, 4))
        out.append((layer, arr, grid))
    return out


@pytest.mark.parametrize("name", ["tetris", "vw", "sdk", "vwc"])
def test_vectorized_matches_scalar(name):
    """The vectorized/memoized path and the scalar first-strictly-better
    loop pick identical mappings on random geometries — and the JAX
    package's mapping."""
    search = {"tetris": tetris.tetris_layer, "vw": baselines.vw_sdk,
              "sdk": baselines.sdk, "vwc": baselines.vwc_sdk}[name]
    jsearch = {"tetris": jcore.tetris.tetris_layer,
               "vw": jcore.baselines.vw_sdk, "sdk": jcore.baselines.sdk,
               "vwc": jcore.baselines.vwc_sdk}[name]
    for layer, arr, grid in _random_cases(40):
        memo.clear()
        fast = search(layer, arr, grid)
        with memo.disabled():
            slow = search(layer, arr, grid)
        assert fast == slow, (name, layer, arr, grid)
        _same(fast, jsearch(*_jax_twin(layer, arr, grid)))


def test_effective_grid_rebase():
    """Grids beyond (IC, OC) collapse to one cache entry whose result is
    re-stamped with the caller's grid — and matches a direct search."""
    layer = ConvLayerSpec("t", 18, 18, 3, 3, 8, 8)
    arr = ArrayConfig(256, 256)
    memo.clear()
    a = tetris.tetris_layer(layer, arr, MacroGrid(9, 9))
    b = tetris.tetris_layer(layer, arr, MacroGrid(16, 12))
    assert memo.stats["result_misses"] >= 1
    assert a.tiles == b.tiles
    assert a.grid == MacroGrid(9, 9) and b.grid == MacroGrid(16, 12)
    with memo.disabled():
        assert tetris.tetris_layer(layer, arr, MacroGrid(16, 12)) == b
    _same(b, jcore.tetris.tetris_layer(
        *_jax_twin(layer, arr, MacroGrid(16, 12))))


def test_grid_search_cache_correctness():
    """Memoized grid search returns bit-identical mappings, chosen grids
    and per-grid cycle counts to the uncached path (Alg 2 contract), and
    the JAX package's best mapping."""
    layers = networks.cnn8()
    arr = ArrayConfig(512, 512)
    memo.clear()
    cached = grid_search("cnn8", layers, arr, p_max=6)
    with memo.disabled():
        uncached = grid_search("cnn8", layers, arr, p_max=6)
    assert cached.best == uncached.best
    assert cached.per_grid == uncached.per_grid
    ref = jcore.grid_search("cnn8", jcore.networks.cnn8(),
                            jcore.ArrayConfig(512, 512), p_max=6)
    _same(cached.best, ref.best)


def test_cache_hit_counts():
    layers = networks.cnn8()
    arr = ArrayConfig(512, 512)
    memo.clear()
    map_net("cnn8", layers, arr, "Tetris-SDK")
    misses = memo.stats["result_misses"]
    map_net("cnn8", layers, arr, "Tetris-SDK")
    assert memo.stats["result_misses"] == misses   # second pass all hits
    assert memo.stats["result_hits"] >= len(layers)


def test_lru_eviction_bound(cache_limits):
    """The in-memory caches cannot grow past their bounds in a long-lived
    process: oldest entries evict, counters surface it, results stay
    correct (evicted entries just recompute).  The port's BoundedCounts
    is bounded the same way and resets with the caches."""
    memo.clear()
    memo.set_cache_limits(results=4, tables=2)
    layers = [ConvLayerSpec(f"l{i}", 12 + i, 12 + i, 3, 3, 8, 8)
              for i in range(8)]
    arr = ArrayConfig(256, 256)
    first = [tetris.tetris_layer(ly, arr, MacroGrid(2, 2)) for ly in layers]
    assert len(memo._results) <= 4 and len(memo._tables) <= 2
    assert memo.stats["result_evictions"] >= 4
    assert memo.stats["table_evictions"] >= 6
    again = [tetris.tetris_layer(ly, arr, MacroGrid(2, 2)) for ly in layers]
    assert first == again
    # shrinking below the live population evicts immediately
    memo.set_cache_limits(results=1)
    assert len(memo._results) <= 1
    counts = memo.BoundedCounts(3)
    for key in ("a", "b", "a", "c", "d"):
        counts.note(key)
    assert dict(counts) == {"b": 1, "c": 1, "d": 1}   # oldest key gone
    memo.clear()
    assert dict(counts) == {}


def test_disk_cache_round_trip(disk_cache):
    """A populated disk cache survives an in-memory wipe: the re-search
    is all disk hits, zero table builds, bit-identical mappings."""
    layers = networks.cnn8()
    arr = ArrayConfig(512, 512)
    first = map_net("cnn8", layers, arr, "Tetris-SDK")
    assert memo.stats["disk_writes"] > 0
    files = list(disk_cache.glob("*.mapping.pkl"))
    assert len(files) == memo.stats["disk_writes"]
    memo.clear()                      # cold in-memory, warm disk
    again = map_net("cnn8", layers, arr, "Tetris-SDK")
    assert again == first
    assert memo.stats["table_misses"] == 0
    assert memo.stats["disk_hits"] > 0 and memo.stats["disk_writes"] == 0


def test_disk_cache_corrupt_entry_recomputes(disk_cache):
    """Truncated/garbage entries are dropped and recomputed, not fatal;
    the JAX package's entries in the same directory never are the
    port's (another file name for the same key)."""
    layer = ConvLayerSpec("t", 18, 18, 3, 3, 8, 8)
    arr = ArrayConfig(256, 256)
    m = tetris.tetris_layer(layer, arr, MacroGrid(2, 2))
    for f in disk_cache.glob("*.mapping.pkl"):
        f.write_bytes(b"not a pickle")
    memo.clear()
    m2 = tetris.tetris_layer(layer, arr, MacroGrid(2, 2))
    assert m2 == m
    assert memo.stats["disk_errors"] > 0
    assert memo.NAMESPACE == "repro_torch"
    jmemo.set_disk_cache(disk_cache)
    try:
        key = ("namespace", 1)
        assert memo._disk_path(key) != jmemo._disk_path(key)
        assert memo._disk_path(key).parent == jmemo._disk_path(key).parent
    finally:
        jmemo.set_disk_cache(None)


def test_disk_cache_bypassed_when_disabled(disk_cache):
    with memo.disabled():
        tetris.tetris_layer(ConvLayerSpec("t", 18, 18, 3, 3, 8, 8),
                            ArrayConfig(256, 256), MacroGrid(2, 2))
    assert memo.stats["disk_writes"] == 0
    assert not list(disk_cache.glob("*.mapping.pkl"))


def test_disk_cache_cold_process_densenet40(disk_cache):
    """Acceptance anchor: a cold process with a warm on-disk cache maps
    DenseNet40 at p_max=16 with ZERO search-table builds, and picks the
    identical grid/cycles."""
    warm = grid_search("densenet40", networks.densenet40(),
                       ArrayConfig(512, 512), 16)
    code = """
from repro_torch.core import ArrayConfig, grid_search, memo, networks
r = grid_search("densenet40", networks.densenet40(),
                ArrayConfig(512, 512), 16)
assert memo.stats["table_misses"] == 0, memo.stats
assert memo.stats["disk_hits"] > 0
print("COLD-OK", r.best.grid.r, r.best.grid.c, r.best.total_cycles)
"""
    env = dict(os.environ,
               REPRO_MAPPING_CACHE=str(disk_cache),
               PYTHONPATH=os.pathsep.join(
                   [os.path.join(os.path.dirname(__file__), "..", "src")]
                   + sys.path))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    b = warm.best
    assert out.stdout.split()[-4:] == [
        "COLD-OK", str(b.grid.r), str(b.grid.c), str(b.total_cycles)]


def test_paper_numbers_survive_memoization():
    """Table I anchors: CNN8 Tetris-SDK == 116 total cycles."""
    memo.clear()
    m = map_net("cnn8", networks.cnn8(), ArrayConfig(512, 512),
                "Tetris-SDK")
    assert m.total_cycles == 116
    m2 = map_layer(networks.cnn8()[1], ArrayConfig(512, 512), "Tetris-SDK")
    assert m2.cycles == 38                          # CNN8-3, Fig 12


def test_disk_cache_eviction_converges(tmp_path):
    """A size-capped disk cache prunes oldest-mtime entries on insert
    (counted in stats) instead of growing forever; the entry just
    written always survives."""
    memo.clear()
    payload = b"x" * 256
    try:
        memo.set_disk_cache(tmp_path, max_bytes=4096)
        for i in range(40):                 # ~10x the cap, distinct keys
            memo.cached_result(("evict", i), lambda: payload,
                               persist=True)
        total = sum(f.stat().st_size
                    for f in tmp_path.glob("*.mapping.pkl"))
        assert 0 < total <= 4096            # converged, not grown
        assert memo.stats["disk_evictions"] > 0
        memo.clear()
        assert memo.cached_result(("evict", 39), lambda: None,
                                  persist=True) == payload
        memo.clear()
        assert memo.cached_result(("evict", 0), lambda: "gone",
                                  persist=True) == "gone"
    finally:
        memo.set_disk_cache(None)
        memo.clear()


def test_disk_cache_eviction_is_mtime_lru(tmp_path):
    """Hits refresh an entry's mtime, so a recently-read old entry
    outlives a colder, newer one when the cap bites.  Entry ages are
    pinned with explicit os.utime so the ordering never depends on the
    filesystem's mtime granularity."""
    memo.clear()
    entry = b"z" * 128                      # ~150 B pickled
    try:
        memo.set_disk_cache(tmp_path, max_bytes=420)
        memo.cached_result(("lru", "a"), lambda: entry, persist=True)
        memo.cached_result(("lru", "b"), lambda: entry, persist=True)
        a_path = memo._disk_path(("lru", "a"))
        b_path = memo._disk_path(("lru", "b"))
        now = time.time()
        os.utime(a_path, (now - 200, now - 200))   # a is the older entry
        os.utime(b_path, (now - 100, now - 100))
        memo.clear()                        # force the next read to disk
        assert memo.cached_result(("lru", "a"), lambda: None,
                                  persist=True) == entry
        # the hit refreshed a's mtime past b's: b is now the LRU victim
        assert a_path.stat().st_mtime > b_path.stat().st_mtime
        memo.cached_result(("lru", "c"), lambda: entry, persist=True)
        memo.clear()
        assert memo.cached_result(("lru", "a"), lambda: "gone",
                                  persist=True) == entry
        memo.clear()
        assert memo.cached_result(("lru", "b"), lambda: "gone",
                                  persist=True) == "gone"
    finally:
        memo.set_disk_cache(None)
        memo.clear()


def test_disk_cache_uncapped_by_default(tmp_path):
    memo.clear()
    try:
        memo.set_disk_cache(tmp_path)
        assert memo.disk_cache_max_bytes() is None
        for i in range(8):
            memo.cached_result(("nocap", i), lambda: b"y" * 512,
                               persist=True)
        assert len(list(tmp_path.glob("*.mapping.pkl"))) == 8
        assert memo.stats["disk_evictions"] == 0
    finally:
        memo.set_disk_cache(None)
        memo.clear()
