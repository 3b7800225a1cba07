"""Host time inside the decode of supplied frames: the device-idle time
inside the program's ``decode_layout``, ``decode_acs`` and
``decode_traceback`` spans (``parallel/streaming.long_frame_decode_stream``:
the layout copies and start metrics, kernel 4's enqueue, the start-state
scan, kernel 5's launches and the output transpose), the mean a batch of
the window, in milliseconds.  The spans share the device trace's clock;
idle is the window's stretches in which no kernel ran, intersected with
the spans (three siblings that never overlap).  ``None`` where the trace
holds no such span (a program without them) or no kernel."""

from benchmark.metrics.launch_idle_ms import idle_within

LAYER = "frame decode (host)"
MOVES = "info_bits_per_s"
SOURCE = "program_span"

SPANS = ("decode_layout", "decode_acs", "decode_traceback")


def read(ctx):
    idle = [idle_within(ctx, name) for name in SPANS]
    if all(x is None for x in idle):
        return None
    return sum(x for x in idle if x is not None)
