"""Precision of the reference's products.

``"f32"``: operands as they are, TF32 off.  ``"tf32"``: each operand of
a product rounded to TF32 (10 mantissa bits, round to nearest even)
first, then summed in f32 as the tensor cores do; the rounding is done
here, so the control does not depend on which algorithm a library
picks."""
from __future__ import annotations

import contextlib

import torch

PRECISIONS = ("f32", "tf32")


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (f32) rounded to the nearest TF32 value, ties to even."""
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    return ((bits + 0xFFF + lsb) & -8192).view(torch.float32)


def operand(x: torch.Tensor, precision: str) -> torch.Tensor:
    """A product's operand in ``precision``."""
    if precision == "f32":
        return x
    if precision == "tf32":
        return to_tf32(x)
    raise ValueError(f"unknown precision {precision!r} "
                     f"(expected one of {PRECISIONS})")


@contextlib.contextmanager
def exact_f32():
    """TF32 off for matmuls and convolutions inside the block."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev
