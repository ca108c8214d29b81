"""Build the port's CUDA sources into shared libraries and load them.

Each ``csrc/*.cu`` file has a plain C interface and is compiled by
``nvcc`` for ``sm_90a`` into ``build/kernels/`` at the repository root,
under a name keyed by a hash of its source and flags, then loaded with
``ctypes``.  A library is built at its first use in a process, never at
import; an unchanged source found built is loaded as it is.
:func:`build_all` starts one ``nvcc`` per source, all at once.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_loaded: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc() -> str:
    """Path of the CUDA compiler: ``nvcc`` on PATH, else under
    ``$CUDA_HOME`` (default ``/usr/local/cuda``)."""
    found = shutil.which("nvcc")
    if found:
        return found
    path = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                           "the machine with the card")
    return str(path)


def library_path(source: str) -> Path:
    """Where ``csrc/<source>`` builds to: keyed by source and flags."""
    text = (CSRC / source).read_bytes()
    digest = hashlib.sha256(text + repr(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{Path(source).stem}-{digest[:16]}.so"


def _start(source: str):
    """Start nvcc on one source into a temporary file beside its target;
    returns (process, tmp path, target) or None when already built."""
    target = library_path(source)
    if target.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
    os.close(fd)
    cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / source)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, target


def _finish(source: str, started) -> None:
    proc, tmp, target = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed on {source} "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, target)         # atomic: a reader never sees half a file


def build_all(sources: Sequence[str]) -> Dict[str, Path]:
    """Build every source that is not built yet, one nvcc each, all
    started together; returns each source's library path."""
    with _lock:
        started = {s: _start(s) for s in sources}
        errors = []
        for s, st in started.items():
            if st is None:
                continue
            try:
                _finish(s, st)
            except RuntimeError as e:     # finish the others, then raise
                errors.append(str(e))
        if errors:
            raise RuntimeError("\n".join(errors))
    return {s: library_path(s) for s in sources}


def load(source: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<source>``, built on first use."""
    lib = _loaded.get(source)
    if lib is None:
        path = build_all([source])[source]
        lib = ctypes.CDLL(str(path))
        _loaded[source] = lib
    return lib
