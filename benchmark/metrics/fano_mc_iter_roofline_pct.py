"""The Fano walk's share of its roofline over the iterations it actually
walked: the least time the window's walks could take on the card, over
the device's busy time in the window (every kernel, whatever its name).

The work is each frame's data generation and error count
(``yardstick/opcounts.frame_datagen_ops``) and the program's counter
``walk_iters`` (the walks' iterations in the traced window, the third row
of kernel 8's per-lane counters) at the least operations any iteration
takes.  The cheapest iteration is a backtrack that relaxes the threshold
(:data:`ITER_OPS`: the mode test, the previous node's metric read, its
compares at the root and with the threshold, the threshold lowered: 5);
a SEARCH step does more (``FANO_OPS`` counts 50-56).  The one exception,
at most one iteration a frame, is the one that finds the budget spent
(:data:`LAST_OPS`: the mode and budget tests, 2).  Every iteration so
counts at most what it does, and the share cannot pass 100%.  The bytes
are the per-lane counters written.  ``None`` on other decoders or where
the program keeps no ``walk_iters``."""

from benchmark.metrics.fano_mc_tail_pct import program_counters
from benchmark.reference.common import seq_launches
from benchmark.yardstick.opcounts import frame_datagen_ops
from benchmark.yardstick.peaks import least_seconds

LAYER = "Fano MC walk (kernel 8)"
MOVES = "info_bits_per_s"
SOURCE = "program_counter"

#: the cheapest iteration's operations, and the budget's last iteration's
ITER_OPS = {"mode": 1, "read": 1, "compare": 2, "relax": 1}
LAST_OPS = 2


def window_frames(ctx):
    """(frames, counter bytes) of the window's walk launches."""
    frames = nbytes = 0
    for _ in ctx.points:
        for la in seq_launches(ctx.code, int(ctx.workload["bits_per_point"]), 0):
            frames += la.lanes * la.steps
            nbytes += 3 * 8 * la.lanes
    return frames, nbytes


def least_ops(code, channel: str, iters: int, frames: int) -> float:
    """The least operations of ``frames`` Fano walks of ``iters`` iterations
    in all."""
    return (frames * (frame_datagen_ops(code, channel) + LAST_OPS)
            + max(0, iters - frames) * sum(ITER_OPS.values()))


def read(ctx, counters=None):
    if ctx.workload.get("decoder") != "fano" or not ctx.kernels:
        return None
    counters = program_counters() if counters is None else counters
    iters = counters.get("walk_iters")
    if iters is None:
        return None
    frames, nbytes = window_frames(ctx)
    w0, w1 = ctx.window
    busy = ctx.busy(w0, w1)
    ops = least_ops(ctx.code, ctx.config["channel"], iters, frames)
    return 100.0 * least_seconds(ops, nbytes) / busy if busy > 0 else None
