"""The fused chain's share of its roofline: the least time the window's
Monte-Carlo Viterbi work could take on the card, over the device's busy
time in the window (every kernel, whatever its name).  The work is counted
from the code's shape (``yardstick/opcounts.mc_chain_ops_per_symbol``: a
lane's operations a trellis symbol, AWGN with soft metrics) for every
frame of every point of the window; the bytes are the per-lane counters
written.  Nothing to read on other decoders or on the BSC."""

from benchmark.reference.viterbi import launches
from benchmark.yardstick.opcounts import mc_chain_ops_per_symbol
from benchmark.yardstick.peaks import least_seconds

LAYER = "fused chain (kernel 3)"
MOVES = "info_bits_per_s"
SOURCE = "device_trace"


def read(ctx):
    wl, code = ctx.workload, ctx.code
    if wl.get("decoder") != "viterbi" or ctx.config["channel"] != "awgn" or not ctx.kernels:
        return None
    per_symbol = mc_chain_ops_per_symbol(code)
    ops = nbytes = 0.0
    for _ in ctx.points:
        for la in launches(code, wl, 0):
            ops += per_symbol * code.num_block_symbols * la.lanes * la.steps
            nbytes += 2 * 4 * la.lanes
    w0, w1 = ctx.window
    busy = ctx.busy(w0, w1)
    return 100.0 * least_seconds(ops, nbytes) / busy if busy > 0 else None
