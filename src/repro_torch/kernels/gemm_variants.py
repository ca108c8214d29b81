"""Time edited builds of the GEMM body (``csrc/matmul.cu``) against the
shipped one, on one CUDA card.

    PYTHONPATH=src python -m repro_torch.kernels.gemm_variants \\
        [--edit NAME OLD NEW ...] [--rounds 5]

Each ``--edit`` replaces the text OLD, which must occur exactly once in
the source, with NEW in the variant NAME; edits that share a NAME add up.
For example ``--edit bk16 'BK = 32;' 'BK = 16;'`` builds 16-deep slabs.
The shipped source and every variant are built with the committed flags
plus ``-Xptxas -v`` (one ``nvcc`` each, all at once, into a temporary
directory), and each build's registers and spills are printed.  Every
build runs the whisper-base block's four ``tetris_matmul_f32`` launches
(M 4096 = batch 4 x seq 1024) and the stablelm-1.6b block's four
``grouped_matmul_f32`` launches (G 4, M 2048, the weights as the matmul
executor's group-major view), and both again at batch 1, at each
compiled block tile; each launch is held to ``torch.matmul`` /
``torch.bmm`` within 1e-5 of max|y|.  Times are device times from CUDA
events around 20 back-to-back calls, the median of ``--rounds`` rounds
that visit the builds and the library calls in turn, in reverse order
every other round.  Prints the card's name and power limit, a line per
(build, launch, tile), and per block and build the sum under
``gemm_launch_dims``'s tiles and under 128 x 128 alone.  Exits 1 without
a card.
"""
from __future__ import annotations

import argparse
import ctypes
import statistics
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from . import _build
from . import tetris_matmul as tm

#: (G, M, D, F) of each block's four launches
BLOCKS = {
    "whisper-base block": [(1, 4096, 512, 1536), (1, 4096, 512, 512),
                           (1, 4096, 512, 2048), (1, 4096, 2048, 512)],
    "stablelm-1.6b block": [(4, 2048, 512, 1536), (4, 2048, 512, 512),
                            (4, 2048, 512, 1408), (4, 2048, 1408, 512)],
}
BLOCKS.update({f"{name}, batch 1": [(g, m // 4, d, f) for g, m, d, f in s]
               for name, s in list(BLOCKS.items())})
ITERS = 20


def sources(edits, out_dir: Path) -> dict:
    """{build: source path}: "shipped" is csrc/matmul.cu, each variant a
    copy in ``out_dir`` with its edits applied."""
    text = (_build.CSRC / tm.SOURCE).read_text()
    paths = {"shipped": _build.CSRC / tm.SOURCE}
    for name, old, new in edits:
        src = paths[name].read_text() if name in paths else text
        if src.count(old) != 1:
            raise ValueError(f"{name}: {old!r} occurs {src.count(old)} "
                             f"times in {tm.SOURCE}, not once")
        paths[name] = out_dir / f"{name}.cu"
        paths[name].write_text(src.replace(old, new))
    return paths


def build(paths: dict, out_dir: Path) -> dict:
    """{build: (library, ptxas report)}, one nvcc each, all at once.  A
    source path is absolute, so ``_build`` compiles it where it lies."""
    def one(item):
        name, path = item
        where = out_dir / f"lib_{name}"
        where.mkdir()
        report = _build.ptxas_report(str(path), where)
        lib = ctypes.CDLL(str(where / f"{path.stem}.so"))
        return name, (tm.declare(lib), report)
    with ThreadPoolExecutor(len(paths)) as pool:
        return dict(pool.map(one, paths.items()))


def operands(shape, gen, dev):
    g, m, d, f = shape
    if g == 1:
        return (torch.randn(m, d, generator=gen, device=dev),
                torch.randn(d, f, generator=gen, device=dev),
                torch.empty(m, f, device=dev))
    w = torch.randn(d, g * f, generator=gen, device=dev)
    return (torch.randn(g, m, d, generator=gen, device=dev),
            w.reshape(d, g, f).transpose(0, 1),
            torch.empty(g, m, f, device=dev))


def runner(lib, shape, bn, x, w, out):
    """A call of the build's C entry with the tile forced to 128 x bn."""
    g, m, d, f = shape
    vec = int(tm.vector_staging(x, w, out))
    blocks = ctypes.c_int(0)
    p = [tm.ptr(t, n) for t, n in ((x, "x"), (w, "w"), (out, "out"))]
    if g == 1:
        entry = lib.tetris_matmul_f32
        args = (*p, m, f, d, x.stride(0), w.stride(0), out.stride(0))
    else:
        entry = lib.grouped_matmul_f32
        args = (*p, g, m, f, d, x.stride(1), w.stride(1), out.stride(1),
                x.stride(0), w.stride(0), out.stride(0))
    return lambda: _build.launch(entry, x.device, *args, bn, vec,
                                 ctypes.byref(blocks))


def event_ms(fn) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    fn()
    start.record()
    for _ in range(ITERS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / ITERS


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--edit", nargs=3, action="append", default=[],
                    metavar=("NAME", "OLD", "NEW"))
    ap.add_argument("--rounds", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("gemm_variants: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card)
    dev = torch.device("cuda")
    sms = tm.sm_count(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    shapes = [s for block in BLOCKS.values() for s in block]
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(sources(args.edit, Path(tmp)), Path(tmp))
        for name, (_, report) in libs.items():
            print(f"[build] {name}:\n{report}")
        cases = {}                      # (build or "library", bn, shape)
        for shape in shapes:
            x, w, out = operands(shape, gen, dev)
            lib_call = (lambda x=x, w=w: torch.matmul(x, w)) \
                if shape[0] == 1 else (lambda x=x, w=w: torch.bmm(x, w))
            want = lib_call()
            cases["library", 0, shape] = lib_call
            for name, (lib, _) in libs.items():
                for bn in tm.BNS:
                    run = runner(lib, shape, bn, x, w, out)
                    run()
                    torch.cuda.synchronize()
                    err = float((out - want).abs().max())
                    if err > 1e-5 * float(want.abs().max()):
                        raise AssertionError(f"{name} 128x{bn} {shape}: "
                                             f"error {err:.3e}")
                    cases[name, bn, shape] = run
        times = {key: [] for key in cases}
        order = list(cases)
        for r in range(args.rounds):
            for key in (order if r % 2 == 0 else order[::-1]):
                times[key].append(event_ms(cases[key]))
    med = {key: statistics.median(t) for key, t in times.items()}
    for (name, bn, (g, m, d, f)), t in med.items():
        tile = f"128x{bn}" if bn else "torch"
        print(f"{name} {tile} (G,M,D,F)=({g},{m},{d},{f}): {t:.5f} ms, "
              f"{2 * g * m * d * f / t / 1e9:.2f} TFLOP/s")
    for block, block_shapes in BLOCKS.items():
        lib_ms = sum(med["library", 0, s] for s in block_shapes)
        rule = [tm.gemm_launch_dims(g, m, f, sms).bn
                for g, m, d, f in block_shapes]
        for name in libs:
            ms = sum(med[name, bn, s] for bn, s in zip(rule, block_shapes))
            big = sum(med[name, tm.BNS[0], s] for s in block_shapes)
            print(f"[variants] {block} {name}: launch rule {ms:.5f} ms, "
                  f"128x128 alone {big:.5f} ms (library {lib_ms:.5f} ms) "
                  f"on {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
