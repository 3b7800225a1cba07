"""The least work of decoding supplied frames, counted from the code's shape
and the frames' count and length, never from an implementation: the
numerators of kernels 4 and 5's rooflines.

* Kernel 4, the whole-frame ACS: every state of every frame-symbol at
  ``LANE_OPS["acs_state"]`` (8 S a frame-symbol); bytes: each symbol's M
  float32 distances read and its ``nwords`` int32 words of packed
  decisions written, and a frame's S start metrics read and S final
  metrics written.
* Kernel 5, the traceback: bytes only, each frame-symbol's ``nwords``
  decision words read and its int32 bit written, and a frame's start
  state read and its carry written (8 bytes).

The least time is ``peaks.least_seconds`` of these.  A code is any object
with the fields of ``benchmark.reference.common.CodeSpec``.
"""

from __future__ import annotations

from benchmark.yardstick.opcounts import LANE_OPS
from benchmark.yardstick.peaks import least_seconds


def nwords(code) -> int:
    """32-bit words of one symbol's packed decisions."""
    return (code.num_states + 31) // 32


def acs_ops(code, symbols: int) -> float:
    return LANE_OPS["acs_state"] * code.num_states * symbols


def acs_bytes(code, symbols: int, frames: int) -> float:
    return ((code.points_per_symbol + nwords(code)) * 4 * symbols
            + 2 * code.num_states * 4 * frames)


def traceback_bytes(code, symbols: int, frames: int) -> float:
    return (nwords(code) + 1) * 4 * symbols + 8 * frames


def acs_least_seconds(code, symbols: int, frames: int) -> float:
    """The least time of kernel 4 over ``symbols`` frame-symbols of
    ``frames`` frames."""
    return least_seconds(acs_ops(code, symbols), acs_bytes(code, symbols, frames))


def traceback_least_seconds(code, symbols: int, frames: int) -> float:
    """The least time of kernel 5 over ``symbols`` frame-symbols of
    ``frames`` frames."""
    return least_seconds(0.0, traceback_bytes(code, symbols, frames))
