"""Kernel 5's share of its roofline in the decode of supplied frames: the
least time of the window's traceback work over kernel 5's own busy time
in the window.

The work is the program's counters ``decode_symbols`` and
``decode_frames`` of the traced window, at the bytes
``yardstick/decode_ops`` counts for kernel 5 (each frame-symbol's
decision words read and its bit written once; a frame's start state and
carry).  Kernel 5 is the trace's kernels of the traceback, by the names
``csrc/longframe.cu`` gives them: the segments' end-state maps
(``tb_map_kernel``), their fold (``tb_fold_kernel``) and the walks
(``stream_traceback_kernel``).  ``None`` where the program keeps no such
counters or the trace holds no such kernel."""

import re

from benchmark.metrics.decode_acs_roofline_pct import decode_counters, kernel_busy
from benchmark.yardstick.decode_ops import traceback_least_seconds

LAYER = "frame decode traceback (kernel 5)"
MOVES = "info_bits_per_s"
SOURCE = "program_counter"

TRACEBACK_KERNELS = re.compile(r"\b(tb_map_kernel|tb_fold_kernel|stream_traceback_kernel)\b")


def read(ctx, counters=None):
    counts = decode_counters(counters)
    if counts is None:
        return None
    busy = kernel_busy(ctx, TRACEBACK_KERNELS)
    if busy <= 0:
        return None
    frames, symbols, _ = counts
    return 100.0 * traceback_least_seconds(ctx.code, symbols, frames) / busy
