"""Monte-Carlo accumulation on one device.

The reference runs one block at a time and sums error counters in C
variables (``AWGN-channel/main.c:212-233``).  Here a point's counters
accumulate over steps of a chain step function (the modular chain) or
inside one fused-kernel launch.  Meshes — several devices along a
``frames`` axis — are not ported yet (ROADMAP Q1 item 14).
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from convolutional_codes_tpu_torch.ops.fused_chain import (
    MAX_POINTS, MAX_STATES, MAX_SYMBOLS, mc_chain_viterbi)

#: (generator, param) -> (bit_errors, frame_errors, bits) — see sim.chain.
StepFn = Callable


def sharded_accumulate(step: StepFn, nsteps: int, generator: torch.Generator,
                       param) -> Tuple[int, int, int]:
    """Run ``nsteps`` steps of ``step`` at one sweep point, drawing from
    ``generator``; returns summed (bit_errors, frame_errors, bits) ints."""
    be = fe = nb = 0
    for _ in range(nsteps):   # counters stay on the device until the end
        sbe, sfe, snb = step(generator, param)
        be, fe, nb = be + sbe, fe + sfe, nb + snb
    return int(be), int(fe), int(nb)


def fused_mc_eligible(code, channel: str, decoder: str, demapper: str) -> bool:
    """The fused Monte-Carlo kernel covers the flagship configs — AWGN +
    soft Viterbi (either demapper) and BSC + hard Viterbi — within its
    per-thread array limits (S <= 256, M <= 8, T <= 256)."""
    if decoder != "viterbi" or channel not in ("bsc", "awgn"):
        return False
    return (code.num_states <= MAX_STATES and code.points_per_symbol <= MAX_POINTS
            and code.num_block_symbols <= MAX_SYMBOLS)


def fused_mc_accumulate(code, nsteps: int, seed: int, param, batch: int,
                        channel: str = "awgn", demapper: str = "soft",
                        device="cuda") -> Tuple[int, int, int]:
    """Fused-kernel counterpart of :func:`sharded_accumulate` for the
    Viterbi chains: ``nsteps`` in-kernel steps of ``batch`` lanes (hash RNG
    tile ``min(1024, batch)``, as the reference), seeded with
    ``seed & 0x7FFFFFFF``.  Returns (bit_errors, frame_errors, bits)."""
    be, fe = mc_chain_viterbi(code, batch, nsteps, seed & 0x7FFFFFFF, param,
                              channel, block_lanes=min(1024, batch),
                              demapper=demapper, device=device)
    return (int(be.sum(dtype=torch.int64)), int(fe.sum(dtype=torch.int64)),
            batch * code.block_length * nsteps)
