"""Host time of a point: the part of the benchmark's own span around each
``run_sweep`` call in which no kernel runs on the card (planning, launches,
host syncs and the counters' reduction), its mean over the window's
points, in milliseconds."""

LAYER = "sweep and accumulation (host)"
MOVES = "info_bits_per_s"
SOURCE = "device_trace"


def read(ctx):
    if not ctx.spans or not ctx.kernels:
        return None
    idle = [(b - a) - ctx.busy(a, b) for a, b in ctx.spans]
    return 1e3 * sum(idle) / len(idle)
