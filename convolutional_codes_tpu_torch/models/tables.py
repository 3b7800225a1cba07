"""Device copies of the reference's numpy code tables.

The code registry, the dense trellis and the constellations live in the
reference's pure-numpy modules ``convolutional_codes_tpu.models.{codebook,
trellis,constellations}`` (one copy of the tables and of the compat-parity
quirk).  :func:`code_tables` turns them into tensors on one device, once
per (code, device).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from convolutional_codes_tpu.models.codebook import PARITY_COMPAT, Code
from convolutional_codes_tpu.models.constellations import (
    get_constellation, min_sq_distance, register_dependent_cache)
from convolutional_codes_tpu.models.trellis import build_trellis, quirk_mask_low

#: Largest constraint length with a dense trellis (models/trellis.py:130).
DENSE_TRELLIS_MAX_K = 16


@dataclasses.dataclass(frozen=True)
class CodeTables:
    """Everything the port's ops read about a code, on one device.

    ``prev_state``/``esym_prev`` are the trellis butterfly view
    (``Trellis.prev_state``/``esym_prev``): new state ``ns`` has
    predecessors ``2j`` and ``2j+1`` (``j = ns mod S/2``) and
    ``esym_prev[ns, b]`` is the expected symbol of the transition from
    ``prev_state[ns, b]``.  They are ``None`` above K=16 (no dense trellis,
    e.g. WSPR K=32), and ``points`` is ``None`` where no constellation is
    registered for ``symlen_out`` bits.
    """

    code: Code
    polynomials: Tuple[int, ...]
    quirk_mask: int                       # compat-parity quirk, 0 for true parity
    prev_state: Optional[torch.Tensor]    # [S, 2] int64
    esym_prev: Optional[torch.Tensor]     # [S, 2] int64
    esym_prev_np: Optional[np.ndarray]    # [S, 2] int32, host copy for kernel params
    points: Optional[torch.Tensor]        # [M, 2] float32
    points_np: Optional[np.ndarray]       # [M, 2] float32
    min_sq_distance: Optional[float]      # demapper ndist
    inv_nd: Optional[float]               # 1 / ndist, as the fused chain uses it

    @property
    def num_states(self) -> int:
        return self.code.num_states

    @property
    def nwords(self) -> int:
        """int32 words per packed decision row, ceil(S / 32)."""
        return (self.code.num_states + 31) // 32


@functools.lru_cache(maxsize=None)
def _code_tables(code: Code, device: torch.device) -> CodeTables:
    K, m = code.constraint_length, code.symlen_out
    prev = esym = esym_np = None
    if K <= DENSE_TRELLIS_MAX_K:
        trellis = build_trellis(code)
        esym_np = np.ascontiguousarray(trellis.esym_prev, dtype=np.int32)
        prev = torch.as_tensor(trellis.prev_state, dtype=torch.int64, device=device)
        esym = torch.as_tensor(esym_np, dtype=torch.int64, device=device)
    points = points_np = nd = inv_nd = None
    try:
        points_np = np.ascontiguousarray(get_constellation(m), dtype=np.float32)
    except ValueError:          # no constellation for this symbol width
        pass
    if points_np is not None:
        points = torch.as_tensor(points_np, device=device)
        nd = min_sq_distance(m)
        inv_nd = float(1.0 / nd)
    qmask = quirk_mask_low(K) if code.parity == PARITY_COMPAT else 0
    return CodeTables(code=code,
                      polynomials=tuple(int(p) for p in code.polynomials),
                      quirk_mask=qmask, prev_state=prev, esym_prev=esym,
                      esym_prev_np=esym_np, points=points, points_np=points_np,
                      min_sq_distance=nd, inv_nd=inv_nd)


def code_tables(code: Code, device="cpu") -> CodeTables:
    """Cached :class:`CodeTables` of ``code`` on ``device``."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return _code_tables(code, device)


# the tables embed a constellation: drop them when one is re-registered
register_dependent_cache(_code_tables.cache_clear)
