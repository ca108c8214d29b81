"""The port's hand-written kernels as the device trace names them: the
names its CUDA sources give their ``__global__`` functions, matched as
substrings of the trace's (demangled) kernel names.  ``gemm_f32_kernel``
is the one GEMM body of both ``tetris_matmul`` (G = 1) and
``grouped_matmul`` (G > 1)."""
from __future__ import annotations

from typing import Dict, Optional, Tuple

KERNELS: Dict[str, Tuple[str, ...]] = {
    "sdk_whole": ("sdk_whole_kernel",),
    "sdk_window": ("sdk_window_kernel",),
    "gemm": ("gemm_f32_kernel",),
    "flash_attention": ("flash_attention_kernel",),
    "im2win_conv": ("im2win_conv_kernel",),
    "ssd_chunk": ("ssd_chunk_kernel", "ssd_chunk_tc_kernel"),
}


def kernel_of(name: str) -> Optional[str]:
    """The hand-written kernel a device event belongs to, or None for
    any other device work (PyTorch's own kernels, copies, fills)."""
    for kernel, patterns in KERNELS.items():
        if any(p in name for p in patterns):
            return kernel
    return None
