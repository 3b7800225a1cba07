"""Share of the window in which no kernel ran on the card: 100 x (1 - the
union of the kernels' intervals in the window / the window), from the
profiler's device events (the ctypes-launched kernels included)."""

LAYER = "device"
MOVES = "info_bits_per_s"
SOURCE = "device_trace"


def read(ctx):
    w0, w1 = ctx.window
    if w1 <= w0 or not ctx.kernels:
        return None
    return 100.0 * (1.0 - ctx.busy(w0, w1) / (w1 - w0))
