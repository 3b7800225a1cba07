"""Operations the long-frame Monte-Carlo work needs, counted from the code's
shape and the overlap-save scheme the configuration fixes, never from an
implementation: the numerator of kernel 6's roofline.

Counted as ``opcounts.LANE_OPS`` counts the fused chain's pieces:

* each distinct stream position's data generation, once, however many
  windows cover it: the info bit's hash and mask, the encoder register
  and its expected symbol (5); on AWGN two uniforms, Box-Muller (the
  transcendentals and 10 more) and a distance a point (6); on the BSC a
  hash, a uniform and a compare a coded bit and a Hamming distance a
  point (5);
* each window's ACS over its ``window + 2 * warmup`` symbols, every state
  at ``LANE_OPS["acs_state"]``;
* a traceback row for each of the ``window + warmup`` rows a window's
  traceback walks (from its last row down to its first payload row).

A code is any object with the fields of
``benchmark.reference.common.CodeSpec``.
"""

from __future__ import annotations

from benchmark.yardstick.opcounts import LANE_OPS


def position_ops(code, channel: str) -> float:
    """Operations of one stream position's data generation."""
    o, M = LANE_OPS, code.points_per_symbol
    ops = o["hash"] + 1 + 5
    if channel == "awgn":
        return ops + 2 * (o["hash"] + o["uniform"]) + o["transcendentals"] + 10 + 6 * M
    return ops + code.symlen_out * (o["hash"] + o["uniform"] + 1) + 5 * M


def window_ops(code, window: int, warmup: int) -> float:
    """Operations of one window's decode: the ACS of every symbol and the
    traceback's rows."""
    o = LANE_OPS
    return ((window + 2 * warmup) * o["acs_state"] * code.num_states
            + (window + warmup) * o["traceback_row"])


def stream_ops(code, channel: str, positions: int, windows: int, window: int,
               warmup: int) -> float:
    """The least operations of ``windows`` lane-windows over ``positions``
    distinct lane stream positions."""
    return positions * position_ops(code, channel) + windows * window_ops(code, window, warmup)


def launch_positions(lanes: int, windows: int, window: int, warmup: int) -> int:
    """Distinct stream positions a launch of ``windows`` consecutive windows
    in each of ``lanes`` lanes covers."""
    return lanes * (windows * window + 2 * warmup) if windows else 0
