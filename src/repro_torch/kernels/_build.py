"""Build the port's CUDA sources into shared libraries and load them.

Each ``csrc/*.cu`` file has a plain C interface and is compiled by
``nvcc`` for ``sm_90a`` into ``build/kernels/`` at the repository root,
under a name keyed by a hash of its source, the headers beside it and
the flags, then loaded with
``ctypes``.  A library is built at its first use in a process, never at
import; an unchanged source found built is loaded as it is.
:func:`build_all` starts one ``nvcc`` per source, all at once.
:func:`launch` calls an entry point and raises on the CUDA error it
returns; :func:`operand_dtype`, :func:`cuda_operand` and :func:`ptr`
check and prepare its tensor arguments (:func:`ptr` and
:func:`address` refuse a tensor without storage of its own), and
:func:`no_backward` refuses a call that autograd would have to
differentiate.

    PYTHONPATH=src python -m repro_torch.kernels._build --ptxas-report \
        [source.cu ...]

prints what ``ptxas`` reports for each source (registers, shared memory,
stack and spills per kernel), built once with the same flags plus
``-Xptxas -v`` into a temporary directory; ``build/kernels/`` is left as
it is.  Needs ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import tempfile
import threading
from pathlib import Path
from typing import Dict, Sequence

import torch
from torch.utils._python_dispatch import is_traceable_wrapper_subclass

from .. import tracing

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
    """Where ``csrc/<source>`` builds to: keyed by the source, every
    header of ``csrc/`` (``*.cuh``, which a source may include) and the
    flags, so a changed header rebuilds every library."""
    text = (CSRC / source).read_bytes()
    for header in sorted(CSRC.glob("*.cuh")):
        text += header.name.encode() + header.read_bytes()
    digest = hashlib.sha256(text + repr(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{Path(source).stem}-{digest[:16]}.so"


def command(source: str, out: str, extra: Sequence[str] = ()) -> list:
    """The ``nvcc`` command line that builds ``csrc/<source>`` into
    ``out``, with ``extra`` flags after the committed ones."""
    return [nvcc(), *NVCC_FLAGS, *extra, "-o", out, str(CSRC / source)]


def _start(source: str):
    """Start nvcc on one source into a temporary file beside its target;
    returns (process, tmp path, target) or None when already built."""
    target = library_path(source)
    if target.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
    os.close(fd)
    proc = subprocess.Popen(command(source, tmp), stdout=subprocess.PIPE,
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


#: The operand types of the kernel API: f32, or bf16 (summed in f32 and
#: returned in bf16), as the JAX package's kernels take them.
KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def operand_dtype(**operands: torch.Tensor) -> torch.dtype:
    """The one dtype of a kernel call's operands, f32 or bf16; raises on
    any other dtype and on operands of mixed dtypes."""
    dtypes = {t.dtype for t in operands.values()}
    if len(dtypes) != 1:
        raise ValueError("operands of mixed dtypes: " + ", ".join(
            f"{n} {t.dtype}" for n, t in operands.items()))
    dtype = dtypes.pop()
    if dtype not in KERNEL_DTYPES:
        raise ValueError(f"{'/'.join(operands)} are {dtype}; the kernels "
                         f"take f32 or bf16")
    return dtype


def needs_backward(*operands: torch.Tensor) -> bool:
    """True when autograd would have to differentiate a call on
    ``operands``: grad mode on and an operand that requires grad."""
    return torch.is_grad_enabled() and any(t.requires_grad
                                           for t in operands)


def no_backward(name: str, *operands: torch.Tensor) -> None:
    """Refuse a kernel call that autograd would have to differentiate
    (:func:`needs_backward`).  No kernel has a backward, here or in the
    reference (a Pallas kernel there), and a launch returns a tensor with
    no ``grad_fn``, so a backward would leave the operands without
    gradients.  The check is the same on both devices; the plain
    versions stay differentiable."""
    if needs_backward(*operands):
        raise RuntimeError(
            f"{name} has no backward (nor has its kernel in the reference):"
            f" call it under torch.no_grad(), or differentiate through the "
            f"plain version or the 'reference' / 'mapped' executors")


def cuda_operand(t: torch.Tensor, name: str) -> torch.Tensor:
    """``t`` as the matmul, attention and im2win kernels take it: a CUDA
    f32 or bf16 tensor with unit stride along its last dimension (a copy
    only when that stride is not 1)."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} is on {t.device}, the kernel needs a "
                         f"CUDA tensor")
    if t.dtype not in KERNEL_DTYPES:
        raise ValueError(f"{name} is {t.dtype}, the kernel takes f32 or "
                         f"bf16")
    return t if t.stride(-1) == 1 else t.contiguous()


def address(t: torch.Tensor, name: str) -> int:
    """The address of ``t``'s first element, the one number a kernel
    entry and an alignment probe may take from a tensor.  Raises
    ``TypeError``, naming the operand, for a tensor without storage of
    its own: a wrapper subclass (a ``DTensor``, whose ``data_ptr()`` is 0:
    a kernel takes each rank's local shard) or a tensor with elements
    at address 0 (``meta``).  So no kernel launches on a null operand,
    and no probe calls one aligned."""
    if is_traceable_wrapper_subclass(t):
        raise TypeError(f"{name} is a {type(t).__name__}, a wrapper "
                        f"without storage of its own: a kernel takes a "
                        f"plain tensor (a DTensor's local shard)")
    addr = t.data_ptr()
    if addr == 0 and t.numel() > 0:
        raise TypeError(f"{name} ({t.device}, {tuple(t.shape)}) has no "
                        f"storage: its address is 0")
    return addr


def ptr(t: torch.Tensor, name: str) -> ctypes.c_void_p:
    """A tensor's device address as a C pointer argument (:func:`address`
    checks it)."""
    return ctypes.c_void_p(address(t, name))


def launch(fn, device: torch.device, *args) -> None:
    """Call the C entry point ``fn(*args, stream)`` with ``device``
    current and its current stream; raise on the CUDA error it returns.
    The call is a ``kernel`` span of `repro_torch.tracing`, named by the
    entry point, while its recorder is on."""
    span = tracing.begin("kernel", fn.__name__)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, ctypes.c_void_p(stream))
    tracing.end(span)
    if err != 0:
        raise RuntimeError(f"{fn.__name__}: CUDA error {err} at launch")


def ptxas_report(source: str, out_dir: Path) -> str:
    """The ``ptxas info`` and spill lines of one build of ``csrc/<source>``
    with ``-Xptxas -v``, into ``out_dir``."""
    out = str(out_dir / (Path(source).stem + ".so"))
    proc = subprocess.run(command(source, out, ("-Xptxas", "-v")),
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source}:\n{proc.stderr}")
    return "\n".join(line for line in proc.stderr.splitlines()
                     if "ptxas info" in line or "spill" in line)


def main(argv: Sequence[str]) -> int:
    if not argv or argv[0] != "--ptxas-report":
        print("usage: python -m repro_torch.kernels._build --ptxas-report "
              "[source.cu ...]", file=sys.stderr)
        return 2
    sources = list(argv[1:]) or sorted(p.name for p in CSRC.glob("*.cu"))
    with tempfile.TemporaryDirectory() as tmp:
        for source in sources:
            print(f"== {source}")
            print(ptxas_report(source, Path(tmp)))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
