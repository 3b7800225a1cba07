"""Batched convolutional encoder (shift register over whole tensors).

Reference: ``common/encoder.c:84-118`` — MSB-first intake, parity of
register & polynomial per output bit (polynomial 0 at the symbol MSB), an
auto-appended K-1 zero tail, ``block_len + K - 1`` symbols per block.

Each symbol t depends on the window ``b[t], ..., b[t-K+1]`` only, so the
low-K-bit register of every position is built at once from K shifted views
of the zero-padded bit tensor (newest bit at bit K-1), and each output bit
is its parity with the polynomial — with the compat quirk of
``models/trellis.py`` applied where the code asks for it.  All integer
math runs in int64, so K up to 32 (WSPR) fits.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from convolutional_codes_tpu.models.codebook import Code
from convolutional_codes_tpu_torch.models.tables import code_tables
from convolutional_codes_tpu_torch.utils.bitops import parity32


def register_symbols(code: Code, reg: torch.Tensor) -> torch.Tensor:
    """Expected channel symbol of low-K-bit registers ``reg`` (int64)."""
    tables = code_tables(code, reg.device)
    sym = torch.zeros_like(reg)
    for p in tables.polynomials:
        x = reg & p
        bit = parity32(x)
        if tables.quirk_mask:
            bit = bit & (1 - parity32(x & tables.quirk_mask))
        sym = (sym << 1) | bit
    return sym


def encode_stream(code: Code, bits: torch.Tensor, terminate: bool = True
                  ) -> torch.Tensor:
    """Encode ``[..., L]`` bits of any length into ``[..., T]`` int32
    symbols, ``T = L + K - 1`` with ``terminate`` (the K-1 zero tail flush)
    and ``T = L`` without."""
    K = code.constraint_length
    L = bits.shape[-1]
    T = L + (K - 1 if terminate else 0)
    padded = F.pad(bits.to(torch.int64), (K - 1, K - 1 if terminate else 0))
    reg = torch.zeros(bits.shape[:-1] + (T,), dtype=torch.int64,
                      device=bits.device)
    for age in range(K):   # age 0 = the newest bit, at register bit K-1
        reg = reg | (padded[..., K - 1 - age: K - 1 - age + T] << (K - 1 - age))
    return register_symbols(code, reg).to(torch.int32)


def encode(code: Code, bits: torch.Tensor) -> torch.Tensor:
    """``[..., block_length]`` info bits → ``[..., block_length + K - 1]``
    int32 symbols in [0, 2^symlen_out)."""
    if bits.shape[-1] != code.block_length:
        raise ValueError(f"expected {code.block_length} info bits, "
                         f"got {bits.shape[-1]}")
    return encode_stream(code, bits, terminate=True)


def encode_tb(code: Code, bits_lb: torch.Tensor, terminate: bool = True
              ) -> torch.Tensor:
    """Lane-major encode: bits ``[L, B]`` → symbols ``[T, B]``."""
    return encode_stream(code, bits_lb.transpose(0, -1),
                         terminate).transpose(0, -1)
