"""Symbol → constellation-point mapper (one gather over the batch).

Reference: one (I, Q) float pair per symbol via table lookup
(``common/mapper.c:54-71``), constellation selected by bits per symbol.
"""

from __future__ import annotations

import torch

from convolutional_codes_tpu_torch.models.codebook import Code
from convolutional_codes_tpu_torch.models.constellations import get_constellation


def map_symbols_m(num_bits: int, symbols: torch.Tensor) -> torch.Tensor:
    """``[..., T]`` symbol indices → ``[..., T, 2]`` float32 (I, Q), keyed by
    bits per symbol (the uncoded chain)."""
    points = torch.as_tensor(get_constellation(num_bits), device=symbols.device)
    return points[symbols.to(torch.int64)]


def map_symbols(code: Code, symbols: torch.Tensor) -> torch.Tensor:
    """``[..., T]`` symbol indices → ``[..., T, 2]`` float32 (I, Q)."""
    return map_symbols_m(code.symlen_out, symbols)
