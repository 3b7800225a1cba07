"""Bit-level helpers: 32-bit popcount, parity and wrapping arithmetic.

PyTorch has no unsigned 32-bit shift, add or compare on the CPU, so 32-bit
values live in int64 tensors, masked to ``0xFFFFFFFF`` after every step
that could leave the range.  Products are split so that no intermediate
exceeds 2^63 (signed int64 overflow is not defined behaviour).
"""

from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF


def mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``(x * c) mod 2^32`` for int64 ``x`` in [0, 2^32) and a constant
    ``c`` in [0, 2^32), without int64 overflow."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Per-element population count of the low 32 bits (int64 math)."""
    x = x.to(torch.int64) & MASK32
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & MASK32) >> 24


def parity32(x: torch.Tensor) -> torch.Tensor:
    """Per-element parity of the low 32 bits (int64 math)."""
    x = x.to(torch.int64) & MASK32
    for s in (16, 8, 4, 2, 1):
        x = x ^ (x >> s)
    return x & 1


def first_argmin(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Index of the first minimum along ``dim`` (int64) — the strict-less
    scan of the reference (later equal values never win), made explicit
    rather than left to a library argmin's tie rule."""
    n = x.shape[dim]
    idx = torch.arange(n, device=x.device).view(
        [n if d == dim % x.dim() else 1 for d in range(x.dim())])
    is_min = x == x.amin(dim=dim, keepdim=True)
    return torch.where(is_min, idx, n).amin(dim=dim)


def to_int32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) → the int32 with the same bit pattern."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)
