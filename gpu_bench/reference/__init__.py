"""The plain reference the benchmark judges the program by: plain PyTorch,
written from the semantics alone.  It imports nothing of the program (nor
JAX) and takes nothing the program made; it reads the program's outputs
only to judge them.

Every function takes a ``precision``: ``"f64"`` is the reference (float64
throughout), ``"tf32"`` the control (float32, each matrix product's operands
rounded to TF32's 10 mantissa bits and summed in float32: what a float32
product on the tensor cores with TF32 on computes).  TF32 is the nearest
precision below the float32 with TF32 off that the configurations state.
"""
from __future__ import annotations

import torch

Tensor = torch.Tensor
PRECISIONS = ("f64", "tf32")


def dtype_of(precision: str) -> torch.dtype:
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}")
    return torch.float64 if precision == "f64" else torch.float32


def round_tf32(x: Tensor) -> Tensor:
    """float32 → float32 with 10 explicit mantissa bits, rounded to
    nearest (ties to even), as the tensor cores read TF32 operands."""
    i = x.contiguous().view(torch.int32)
    i = (i + 0xFFF + ((i >> 13) & 1)) & -0x2000
    return i.view(torch.float32)


def matmul(a: Tensor, b: Tensor, precision: str) -> Tensor:
    """``a @ b`` in the precision: float64, or TF32 operands summed in
    float32.  TF32 products of 11-bit mantissas are exact in float32, so
    this is the tensor cores' TF32 product on any device."""
    dt = dtype_of(precision)
    a, b = a.to(dt), b.to(dt)
    if precision == "tf32":
        a, b = round_tf32(a), round_tf32(b)
    return a @ b
