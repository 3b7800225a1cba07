"""The long-frame chain's share of its roofline: the least time the
window's long-frame Monte-Carlo work could take on the card, over the
device's busy time in the window (every kernel, whatever its name).

The work is the program's counters (``utils/profiling.counters``) of the
traced window: ``stream_positions``, the distinct stream positions its
launches generated, and ``stream_windows``, the lane-windows they decoded,
each at the operations ``yardstick/longframe_ops`` counts for it (a
position's data generation once; a window's ACS over its symbols and its
traceback's rows).  The bytes are the per-lane counters written, two int32
a lane a launch of the reference's plan of each point.  ``None`` where the
program keeps no such counters (a program without a stream leg)."""

from benchmark.metrics.fano_mc_tail_pct import program_counters
from benchmark.reference.longframe import launches
from benchmark.yardstick.longframe_ops import stream_ops
from benchmark.yardstick.peaks import least_seconds

LAYER = "long-frame MC chain (kernel 6)"
MOVES = "info_bits_per_s"
SOURCE = "program_counter"


def read(ctx, counters=None):
    wl = ctx.workload
    if "window" not in wl or not ctx.kernels:
        return None
    counters = program_counters() if counters is None else counters
    positions, windows = counters.get("stream_positions"), counters.get("stream_windows")
    if not positions or not windows:
        return None
    nbytes = sum(2 * 4 * la.lanes for _ in ctx.points for la in launches(ctx.code, wl, 0))
    ops = stream_ops(ctx.code, ctx.config["channel"], positions, windows, int(wl["window"]),
                     int(wl["warmup"]))
    w0, w1 = ctx.window
    busy = ctx.busy(w0, w1)
    return 100.0 * least_seconds(ops, nbytes) / busy if busy > 0 else None
