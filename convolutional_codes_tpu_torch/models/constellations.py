"""Gray-coded unit-power QAM constellations (user-extensible registry).

The port's own copy of the JAX package's ``models/constellations.py``
(NumPy only; ``tests/test_torch_models.py`` holds the two equal).

Point tables 1-3 bits/symbol are numerically identical to the reference
(``common/constellations.c:8-32``): index 1 → 2-point diagonal BPSK, 2 → QPSK,
3 → 8-point cross "8-QAM".  Points are [2^m, 2] float32 (I, Q) with unit
average power.  ``min_sq_distance`` reproduces the reference demapper's
normalization constant ``ndist`` — the squared distance between points 0 and
1 (``demapper.c:42-45``), *by that definition*, not the true minimum.

Framework extensions beyond the reference:
  * 4 bits/symbol → square Gray 16-QAM (levels ±1, ±3 scaled to unit power;
    per-axis Gray labels 00→-3, 01→-1, 11→+1, 10→+3, so every nearest
    neighbor differs in exactly one bit).  ndist = (2/sqrt(10))^2 here is
    also the true minimum squared distance.
  * :func:`register_constellation` lets users install their own point
    tables (mirroring the codebook's user-extension story), which the
    mapper/demappers and the mapped simulation chains pick up directly.
"""

from __future__ import annotations

import functools

import numpy as np

_S2 = 0.707107          # 1/sqrt(2) as stored in constellations.c
_A = 0.408248           # 1/sqrt(6)
_B = 1.224745           # 3/sqrt(6)


def _gray16() -> np.ndarray:
    """Square Gray 16-QAM, unit average power (mean |p|^2 = 1)."""
    a = 1.0 / np.sqrt(10.0)
    level = {0b00: -3.0, 0b01: -1.0, 0b11: 1.0, 0b10: 3.0}
    pts = np.empty((16, 2), np.float32)
    for s in range(16):
        pts[s, 0] = level[(s >> 2) & 3] * a      # I from bits 3..2
        pts[s, 1] = level[s & 3] * a             # Q from bits 1..0
    return pts


_TABLES = {
    1: np.array([[_S2, _S2],
                 [-_S2, -_S2]], dtype=np.float32),
    2: np.array([[_S2, _S2],
                 [_S2, -_S2],
                 [-_S2, _S2],
                 [-_S2, -_S2]], dtype=np.float32),
    3: np.array([[_A, _A], [_A, _B],
                 [-_A, _A], [-_B, _A],
                 [_A, -_A], [_B, -_A],
                 [-_A, -_A], [-_A, -_B]], dtype=np.float32),
    4: _gray16(),
}


#: cache_clear callbacks of caches whose entries embed a point table (the
#: per-device code tables of models/tables.py): cleared on re-registration
#: so a replaced table cannot be served from a stale cache.
_dependent_cache_clears = []


def register_dependent_cache(clear) -> None:
    """Register a cache invalidator to run when a constellation table is
    replaced (``register_constellation(..., overwrite=True)``).  Modules
    that cache values built from ``get_constellation`` tables call this
    once at import time."""
    _dependent_cache_clears.append(clear)


def register_constellation(num_bits: int, points: np.ndarray,
                           overwrite: bool = False) -> np.ndarray:
    """Install a user constellation for ``num_bits`` bits/symbol.

    ``points`` must be [2^num_bits, 2]; unit average power is the caller's
    responsibility (the Eb/N0 → sigma conversion assumes it)."""
    points = np.asarray(points, np.float32)
    if points.shape != (1 << num_bits, 2):
        raise ValueError(f"points must be [{1 << num_bits}, 2], got {points.shape}")
    if num_bits in _TABLES and not overwrite:
        raise KeyError(f"constellation for {num_bits} bits already registered")
    _TABLES[num_bits] = points
    get_constellation.cache_clear()
    for clear in _dependent_cache_clears:
        clear()
    return points


@functools.lru_cache(maxsize=None)
def get_constellation(num_bits: int) -> np.ndarray:
    """Points [2^num_bits, 2] float32 (reference get_constellation)."""
    if num_bits not in _TABLES:
        raise ValueError(
            f"no constellation for {num_bits} bits/symbol "
            f"(have {sorted(_TABLES)}; use register_constellation)")
    return _TABLES[num_bits]


def min_sq_distance(num_bits: int) -> float:
    """Demapper normalization ``ndist``: squared distance of points 0 and 1."""
    c = get_constellation(num_bits)
    d = c[0] - c[1]
    return float(np.float32(d[0] * d[0]) + np.float32(d[1] * d[1]))
