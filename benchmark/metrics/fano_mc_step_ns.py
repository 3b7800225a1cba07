"""The time of one iteration of the Fano walk on a point's longest cold
walk: the cold launches' time over their longest walks' iterations,
``walk_cold_ns`` / ``walk_cold_max_iters``, in nanoseconds.  Both are the
program's counters (``utils/profiling.counters``) of the traced window, one
of each per slot of a point that has a cold and a warm launch: the cold
launch's time between CUDA events on its stream, and the most iterations
a lane of it walked (one frame a lane, so its longest walk's).  A point of
the Fano cells lasts about as long as its longest walks, one dependent
iteration after another, so this is the latency of an iteration as those
walks see it, beside the other walks of their warps and SMs.  ``None`` on
cells of another decoder or where the program keeps no such counters."""

from benchmark.metrics.fano_mc_tail_pct import program_counters

LAYER = "Fano MC walk (kernel 8)"
MOVES = "info_bits_per_s"
SOURCE = "program_counter"


def read(ctx, counters=None):
    if ctx.workload.get("decoder") != "fano":
        return None
    counters = program_counters() if counters is None else counters
    cold, iters = counters.get("walk_cold_ns"), counters.get("walk_cold_max_iters")
    if not cold or not iters:
        return None
    return cold / iters
