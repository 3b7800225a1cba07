"""The stack walk's drain tail: the share of its launches' time on the
card after the first lane found the frame queue empty, 100 x
``walk_tail_ns`` / ``walk_launch_ns``, counted as ``fano_mc_tail_pct``
counts the Fano walk's (kernel 7's clock words).  ``None`` on cells of
another decoder or where the program keeps no such counters."""

from benchmark.metrics.fano_mc_tail_pct import tail_pct

LAYER = "stack MC walk (kernel 7)"
MOVES = "info_bits_per_s"
SOURCE = "program_counter"


def read(ctx, counters=None):
    return tail_pct(ctx, "stack", counters)
