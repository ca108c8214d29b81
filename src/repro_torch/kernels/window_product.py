"""Host-side mirror of ``csrc/window_product.cuh``, the window product
that the im2win and sdk window kernels share: the block's thread count,
the register tile, how threads split the K sum, and the shared memory a
block needs.  The launch rules of :mod:`.im2win_conv` and
:mod:`.sdk_conv` size their blocks with these; the CUDA entry points
recompute the same layout and refuse a block past :data:`SMEM_LIMIT`."""
from __future__ import annotations

import math

#: Threads of a block and the register tile each holds (rows x channels).
THREADS, TILE_ROWS, TILE_COLS = 256, 8, 4
#: Shared memory one block may use on an H100 (232,448 bytes).
SMEM_LIMIT = 227 * 1024


def round4(n: int) -> int:
    return (n + 3) // 4 * 4


def k_groups(rows: int, cols: int, k_steps: int) -> int:
    """Thread groups that split the K sum (``ks``): the threads left over
    when a block has fewer register tiles than threads, capped at the K
    steps (4 input channels of one kernel tap each) there are."""
    tiles = math.ceil(rows / TILE_ROWS) * (cols // TILE_COLS)
    return 1 if tiles >= THREADS else max(1, min(THREADS // tiles, k_steps))


def smem_bytes(n_pix: int, k_taps: int, cs: int, rows: int, cols: int,
               ks: int, patch_slots: int = 1) -> int:
    """Bytes of shared memory of a block: ``patch_slots`` patches of
    ``n_pix`` pixels, the weights (``k_taps`` taps x cs channels x cols)
    and, with ``ks > 1``, the scratch of the K-split sum.  Pixels are
    padded to a multiple of 4 channels whose quarter is odd."""
    cp = round4(cs)
    pix = cp if (cp // 4) % 2 else cp + 4
    tiles = math.ceil(rows / TILE_ROWS) * (cols // TILE_COLS)
    scratch = ks * tiles * TILE_ROWS * TILE_COLS if ks > 1 else 0
    return 4 * (patch_slots * n_pix * pix + k_taps * cp * cols + scratch)
