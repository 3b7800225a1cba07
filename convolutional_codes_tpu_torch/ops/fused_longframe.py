"""Coordinate hash of the long-frame Monte-Carlo chain.

All randomness of the sequential Monte-Carlo paths (``ops/mc_datagen.py``)
is a pure counter hash of (seed, lane or frame id, position, salt): two
rounds of the murmur3 32-bit finalizer over a Weyl-mixed counter — the
JAX package's ``coord_bits``/``coord_uniform`` (fused_longframe.py:56-81),
bit for bit.  The CUDA twin is ``csrc/sequential.cuh``.  The long-frame
kernel (TPU kernel 6) that this module is named after is not ported yet.

CPU torch has no uint32 arithmetic, so the hash runs in int64 masked to
32 bits (``utils/bitops.py``).
"""

from __future__ import annotations

import torch

from convolutional_codes_tpu_torch.utils.bitops import MASK32, mul32


def _fmix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3 32-bit finalizer on int64 values in [0, 2^32)."""
    x = x ^ (x >> 16)
    x = mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def coord_bits(lane: torch.Tensor, pos: torch.Tensor, seed: int,
               salt: int) -> torch.Tensor:
    """32-bit hash of (seed, lane, pos, salt) as int64 in [0, 2^32);
    ``lane``/``pos`` are integer tensors that broadcast together."""
    lane = lane.to(torch.int64) & MASK32
    c = mul32(pos.to(torch.int64) & MASK32, 0x9E3779B9) ^ mul32(lane, 0x7FEB352D)
    c = (c + ((int(seed) + salt * 0x68E31DA4) & MASK32)) & MASK32
    return _fmix32(_fmix32(c) ^ lane)


def coord_uniform(lane: torch.Tensor, pos: torch.Tensor, seed: int,
                  salt: int) -> torch.Tensor:
    """float32 in (0, 1) from 31 hash bits: ``(bits >> 1) * 2^-31 + 2^-32``."""
    bits = (coord_bits(lane, pos, seed, salt) >> 1).to(torch.float32)
    return bits * torch.tensor(2.0 ** -31) + torch.tensor(2.0 ** -32)
