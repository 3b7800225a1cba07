"""Host time between launches, the launch's part: the device-idle time
inside the program's ``mc_launch`` spans (the host preparing and enqueuing
one Monte-Carlo kernel launch: allocations, plan, occupancy, the ctypes
call), the mean a point of the window, in milliseconds.  The spans come
from the port's own profiling (``utils/profiling.py``) and share the
device trace's clock; idle is the window's stretches in which no kernel
ran (``ctx.gaps()``), intersected with the union of the spans, so nested
or repeated spans count once.  ``None`` where the trace holds no such
span (a program without them) or no kernel."""

LAYER = "sweep and accumulation (host)"
MOVES = "info_bits_per_s"
SOURCE = "program_span"


def idle_within(ctx, name: str):
    """Milliseconds a point of the window's idle time inside the host
    spans named ``name``; ``None`` without such spans or kernels."""
    if not ctx.spans or not ctx.kernels:
        return None
    merged = []
    for a, b in sorted((a, b) for n, a, b in ctx.host_ops if n == name):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    if not merged:
        return None
    idle, k = 0.0, 0
    for g0, g1 in ctx.gaps():   # both sorted and disjoint: one pass
        while k < len(merged) and merged[k][1] <= g0:
            k += 1
        j = k
        while j < len(merged) and merged[j][0] < g1:
            idle += min(g1, merged[j][1]) - max(g0, merged[j][0])
            j += 1
    return 1e3 * idle / len(ctx.spans)


def read(ctx):
    return idle_within(ctx, "mc_launch")
