"""The stack walk's share of its roofline over the iterations it actually
walked: the least time the window's walks could take on the card, over
the device's busy time in the window (every kernel, whatever its name).

The work is ``yardstick/opcounts.stack_ops`` of the program's counter
``walk_iters`` (the walks' iterations in the traced window, the third row
of kernel 7's per-lane counters) as one entry summing every frame, with
each frame's data generation: the pick's cost is convex in a walk's
iterations, so spreading the sum evenly over the frames is the least it
can be, and the share cannot pass 100%.  The bytes are the per-lane
counters written.  ``None`` on other decoders or where the program keeps
no ``walk_iters``."""

from benchmark.metrics.fano_mc_iter_roofline_pct import window_frames
from benchmark.metrics.fano_mc_tail_pct import program_counters
from benchmark.yardstick.opcounts import stack_ops
from benchmark.yardstick.peaks import least_seconds

LAYER = "stack MC walk (kernel 7)"
MOVES = "info_bits_per_s"
SOURCE = "program_counter"


def read(ctx, counters=None):
    if ctx.workload.get("decoder") != "stack" or not ctx.kernels:
        return None
    counters = program_counters() if counters is None else counters
    iters = counters.get("walk_iters")
    if iters is None:
        return None
    frames, nbytes = window_frames(ctx)
    w0, w1 = ctx.window
    busy = ctx.busy(w0, w1)
    ops = stack_ops(ctx.code, ctx.config["channel"], [float(iters)], frames)
    return 100.0 * least_seconds(ops, nbytes) / busy if busy > 0 else None
