"""The Fano walk's drain tail: the share of its launches' time on the card
after the first lane found the frame queue empty, 100 x ``walk_tail_ns`` /
``walk_launch_ns``.  Both are the program's counters
(``utils/profiling.counters``) of the traced window: the launches' time
between CUDA events around each, and the time from a launch's first lane
to leave on an empty queue to its last lane's exit, which kernels 7 and 8
write from the card's ``%globaltimer``.  The events bound the kernel, so
the share stays at or below 100%.  A high share means a few long walks
hold the launch while the rest of the persistent grid has left.  ``None`` on cells of another decoder or
where the program keeps no such counters."""

LAYER = "Fano MC walk (kernel 8)"
MOVES = "info_bits_per_s"
SOURCE = "program_counter"


def program_counters() -> dict:
    """The program's counters of the traced window; empty where the program
    keeps none."""
    try:
        from convolutional_codes_tpu_torch.utils import profiling
    except ImportError:
        return {}
    counters = getattr(profiling, "counters", None)
    return counters() if callable(counters) else {}


def tail_pct(ctx, decoder: str, counters=None):
    """100 x tail / launch time of the walks of ``decoder``'s cells."""
    if ctx.workload.get("decoder") != decoder:
        return None
    counters = program_counters() if counters is None else counters
    launch, tail = counters.get("walk_launch_ns"), counters.get("walk_tail_ns")
    if not launch or tail is None:
        return None
    return 100.0 * tail / launch


def read(ctx, counters=None):
    return tail_pct(ctx, "fano", counters)
