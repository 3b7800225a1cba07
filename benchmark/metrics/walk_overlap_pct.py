"""How far a sequential point's two walk launches run side by side: 100 x
``walk_overlap_ns`` / ``walk_cold_ns``.  Both are the program's counters
(``utils/profiling.counters``) of the traced window, taken from CUDA events
around the cold and the warm launch of each point that has both: the time
the two were in flight together, and the cold launch's time.  The overlap
lies inside the cold launch, so the share stays at or below 100%.  A high
share means the point waits for one drain of its slowest walks, not one a
launch.  ``None`` where the program keeps no such counters."""

from benchmark.metrics.fano_mc_tail_pct import program_counters

LAYER = "sweep and accumulation (host)"
MOVES = "info_bits_per_s"
SOURCE = "program_counter"


def read(ctx, counters=None):
    counters = program_counters() if counters is None else counters
    cold, overlap = counters.get("walk_cold_ns"), counters.get("walk_overlap_ns")
    if not cold or overlap is None:
        return None
    return 100.0 * overlap / cold
