"""The time of one dependent trellis step of kernel 4 in the decode of
supplied frames: kernel 4's busy time in the window over the window's
``decode_chain_steps`` (T a decode call: the steps of its frames' chain,
which every frame walks side by side), in nanoseconds.  At few frames a
call the chain of T dependent ACS steps binds kernel 4, not the card's
width, so this is the latency of a step as the frames see it.  ``None``
where the program keeps no such counters or the trace holds no kernel 4."""

from benchmark.metrics.decode_acs_roofline_pct import ACS_KERNEL, decode_counters, kernel_busy

LAYER = "frame decode ACS (kernel 4)"
MOVES = "info_bits_per_s"
SOURCE = "program_counter"


def read(ctx, counters=None):
    counts = decode_counters(counters)
    if counts is None:
        return None
    busy = kernel_busy(ctx, ACS_KERNEL)
    return 1e9 * busy / counts[2] if busy > 0 else None
