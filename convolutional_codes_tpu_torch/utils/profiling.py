"""Tracing and profiling hooks: the port's copy of the JAX package's
``utils/profiling.py``, with the port's own spans and counters.

One switch: spans and counters record only while a ``torch.profiler``
session is active (:func:`trace`, ``run_sweep(trace_dir=...)``, the CLI's
``--trace``, or any session a caller opens around the port, as the
benchmark's ``--trace 1`` does).  Without one, :func:`annotate` returns one
shared no-op context and :func:`count` / :func:`count_later` return at
once: one check, no allocation, no ``record_function``.

* :func:`trace` captures a ``torch.profiler`` trace of the enclosed block:
  host activity always, and the card's kernels (through CUPTI, the ones
  launched from the ctypes-bound libraries of ``csrc/`` included) where a
  card is visible.  It writes one Chrome trace, ``<host>_<pid>.<n>.pt.trace.json``,
  under ``log_dir`` (TensorBoard's PyTorch profiler plugin reads the
  directory; ``chrome://tracing`` or Perfetto open the file), and does
  nothing when ``log_dir`` is falsy.
* :func:`annotate` names a region in the timeline, a
  ``torch.profiler.record_function`` span: the profiler keeps it in memory,
  writes it at the end, and stamps it on the clock of the card's kernels.
  The port's spans, nested on the host thread: ``sweep_point_<p>`` (a
  point's work), ``sweep_plan`` (``run_sweep``'s preamble), ``mc_launch``
  (the host's preparation and enqueue of one Monte-Carlo kernel launch,
  kernels 3, 6, 7 and 8),
  ``mc_readback`` (the counters' reduction launches and their blocking
  reads to the host), ``sweep_record`` (a point's record), ``build_load``
  (a kernel library built or loaded); in the decode of supplied frames
  (``parallel/streaming.long_frame_decode_stream``) ``decode_layout`` (the
  cast and transpose to ``[T, M, B]``, the start metrics), ``decode_acs``
  (kernel 4's enqueue) and ``decode_traceback`` (the start-state scan,
  kernel 5's launches and the output transpose).
* :func:`count` and :func:`count_later` add to process-wide counters,
  read with :func:`counters` and cleared with :func:`reset_counters`:
  ``walk_iters`` (the walks' iterations, ``parallel/seq_grid.py``),
  ``walk_launch_ns`` and ``walk_tail_ns`` (a walk launch's time on the
  card, from CUDA events around it, and the part of it after its first
  lane found the frame queue empty, from the kernels' own clock words:
  ``ops/sequential_common.walk_clock``), ``walk_cold_ns`` and
  ``walk_overlap_ns`` (a sequential point's cold launch's time, and the
  time its warm launch ran beside it: ``parallel/seq_grid.py``),
  ``walk_cold_max_iters`` (the iterations of the cold launch's longest
  walk, a slot's most: ``parallel/seq_grid.py``),
  ``stream_windows`` and ``stream_positions`` (a long-frame launch's
  lanes x windows, and the distinct stream positions it generates, from
  its arguments: ``parallel/streaming.py``), ``mc_reads`` (the blocking
  reads of the chunked legs' counters, one a device a point:
  ``parallel/montecarlo.Tally``), ``decode_frames``, ``decode_symbols``,
  ``decode_chain_steps`` and ``decode_pair_steps`` (a decode call's B, B x
  T, T and kernel 4's two-step exchanges, from its arguments:
  ``parallel/streaming.long_frame_decode_stream``).  A
  counter whose value lives on the device stays there until
  :func:`counters` reads it, so tracing adds no host sync to the traced
  work.

Not ported: ``enable_nan_debugging``, which sets ``jax_debug_nans`` — a
check XLA compiles into a traced graph.  The port runs eager, forward-only
tensor code and its kernels through ctypes, so there is no graph to
instrument and torch has no switch of that kind for it (its anomaly mode
checks backward passes, which the port has none of).
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, Optional, Tuple

import torch

_NO_SPAN = contextlib.nullcontext()
_counts: Dict[str, int] = {}
_pending: List[Tuple[torch.Tensor, Dict[str, Callable[[torch.Tensor], int]]]] = []


def tracing() -> bool:
    """Whether a ``torch.profiler`` session is recording: the one switch of
    the port's spans and counters."""
    return torch._C._autograd._profiler_enabled()


@contextlib.contextmanager
def trace(log_dir: Optional[str]):
    """Capture a ``torch.profiler`` trace of the enclosed block into
    ``log_dir`` (no-op when ``log_dir`` is falsy): CPU activity always, the
    card's kernels where CUDA is available."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()   # the enclosed kernels end inside the trace


def annotate(name: str):
    """A span ``name`` in the profiler's timeline while :func:`tracing`;
    otherwise one shared context that does nothing."""
    if not tracing():
        return _NO_SPAN
    return torch.profiler.record_function(name)


def count(name: str, value: int) -> None:
    """Add ``value`` to counter ``name`` while :func:`tracing`."""
    if tracing():
        _counts[name] = _counts.get(name, 0) + int(value)


def count_later(words: torch.Tensor, **reads: Callable[[torch.Tensor], int]) -> None:
    """While :func:`tracing`, keep ``words`` (device memory a kernel writes)
    and, when :func:`counters` is next called, add ``read(host copy of
    words)`` to each counter named in ``reads``."""
    if tracing():
        _pending.append((words, reads))


def counters() -> Dict[str, int]:
    """The counters so far.  Reads the pending device words first, which
    waits for the kernels that write them: call it after the traced work."""
    for words, reads in _pending:
        host = words.cpu()
        for name, read in reads.items():
            _counts[name] = _counts.get(name, 0) + int(read(host))
    _pending.clear()
    return dict(_counts)


def reset_counters() -> None:
    """Clear every counter, the pending ones included."""
    _counts.clear()
    _pending.clear()
