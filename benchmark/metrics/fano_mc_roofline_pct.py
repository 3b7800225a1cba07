"""The Fano walk's share of its roofline: the least time the window's
Monte-Carlo work could take on the card, over the device's busy time in
the window (every kernel, whatever its name). The work is the least the
inputs need, counted from the code's shape: each frame's data generation
and one walk step per coded symbol, a Fano step counted as the stack's
is (``yardstick/opcounts.FANO_OPS``); the walks' iterations beyond that
depend on the data and are not counted, so the share cannot pass 100%.
The bytes are the per-lane counters written. Nothing to read on other
decoders."""

from benchmark.reference.common import seq_launches
from benchmark.yardstick.opcounts import least_walk_ops
from benchmark.yardstick.peaks import least_seconds

LAYER = "Fano MC walk (kernel 8)"
MOVES = "info_bits_per_s"
SOURCE = "device_trace"


def read(ctx):
    wl, code = ctx.workload, ctx.code
    if wl.get("decoder") != "fano" or not ctx.kernels:
        return None
    ops = nbytes = 0.0
    for _ in ctx.points:
        for la in seq_launches(code, int(wl["bits_per_point"]), 0):
            ops += least_walk_ops(code, ctx.config["channel"], "fano", la.lanes * la.steps)
            nbytes += 3 * 8 * la.lanes
    w0, w1 = ctx.window
    busy = ctx.busy(w0, w1)
    return 100.0 * least_seconds(ops, nbytes) / busy if busy > 0 else None
