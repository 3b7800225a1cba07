"""Kernel 4's share of its roofline in the decode of supplied frames: the
least time of the window's whole-frame ACS work over kernel 4's own busy
time in the window.

The work is the program's counters (``utils/profiling.counters``) of the
traced window: ``decode_symbols``, the frame-symbols the decode calls were
given (B x T a call), and ``decode_frames`` (B a call), at what
``yardstick/decode_ops`` counts for kernel 4 (8 S operations a
frame-symbol; its distances, decisions and metrics once).  Kernel 4 is
the trace's kernels named ``stream_acs_kernel``; their busy time is the
union of their intervals in the window.  ``None`` where the program keeps
no such counters (a program without the decode's counters) or the trace
holds no such kernel."""

import re

from benchmark.metrics.fano_mc_tail_pct import program_counters
from benchmark.yardstick.decode_ops import acs_least_seconds

LAYER = "frame decode ACS (kernel 4)"
MOVES = "info_bits_per_s"
SOURCE = "program_counter"

#: kernel 4 as the trace names it (a template instance's full signature)
ACS_KERNEL = re.compile(r"\bstream_acs_kernel\b")


def kernel_busy(ctx, pattern) -> float:
    """Seconds of the window in which a kernel whose name matches
    ``pattern`` ran: the union of their intervals."""
    w0, w1 = ctx.window
    total, end = 0.0, w0
    for a, b in sorted((max(a, w0), min(b, w1)) for name, a, b in ctx.kernels
                       if pattern.search(name) and b > w0 and a < w1):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def decode_counters(counters=None):
    """(frames, symbols, chain steps) the window's decode calls counted, or
    ``None`` where the program keeps no such counters."""
    counters = program_counters() if counters is None else counters
    got = tuple(counters.get(k) for k in ("decode_frames", "decode_symbols",
                                          "decode_chain_steps"))
    return got if all(got) else None


def read(ctx, counters=None):
    counts = decode_counters(counters)
    if counts is None:
        return None
    busy = kernel_busy(ctx, ACS_KERNEL)
    if busy <= 0:
        return None
    frames, symbols, _ = counts
    return 100.0 * acs_least_seconds(ctx.code, symbols, frames) / busy
