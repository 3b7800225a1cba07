"""Host time between launches, the read-back's part: the device-idle time
inside the program's ``mc_readback`` spans (the counters' reduction
launches and their blocking reads to the host: ``.sum``, ``int()``,
``.cpu()``), the mean a point of the window, in milliseconds; counted as
``launch_idle_ms`` counts its spans.  ``None`` where the trace holds no
such span (a program without them) or no kernel."""

from benchmark.metrics.launch_idle_ms import idle_within

LAYER = "sweep and accumulation (host)"
MOVES = "info_bits_per_s"
SOURCE = "program_span"


def read(ctx):
    return idle_within(ctx, "mc_readback")
