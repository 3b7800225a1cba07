"""Tracing and profiling hooks: the port's copy of the JAX package's
``utils/profiling.py``.

* :func:`trace` captures a ``torch.profiler`` trace of the enclosed block:
  host activity always, and the card's kernels (through CUPTI, the ones
  launched from the ctypes-bound libraries of ``csrc/`` included) where a
  card is visible.  It writes one Chrome trace, ``<host>_<pid>.<n>.pt.trace.json``,
  under ``log_dir`` (TensorBoard's PyTorch profiler plugin reads the
  directory; ``chrome://tracing`` or Perfetto open the file), and does
  nothing when ``log_dir`` is falsy.
* :func:`annotate` names a region in the timeline:
  ``torch.profiler.record_function`` and, where CUDA is available, an NVTX
  range.
* :class:`ThroughputMeter` is the decoded-bits/s meter, as it is there.

Not ported: ``enable_nan_debugging``, which sets ``jax_debug_nans`` — a
check XLA compiles into a traced graph.  The port runs eager, forward-only
tensor code and its kernels through ctypes, so there is no graph to
instrument and torch has no switch of that kind for it (its anomaly mode
checks backward passes, which the port has none of).
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import List, Optional

import torch


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


@contextlib.contextmanager
def annotate(name: str):
    """Named region visible in profiler timelines (and NVTX, with CUDA)."""
    with contextlib.ExitStack() as stack:
        stack.enter_context(torch.profiler.record_function(name))
        if torch.cuda.is_available():
            stack.enter_context(torch.cuda.nvtx.range(name))
        yield


@dataclass
class ThroughputMeter:
    """Decoded-bits/s meter with warmup discard."""

    name: str = "chain"
    warmup: int = 1
    _bits: List[int] = field(default_factory=list)
    _times: List[float] = field(default_factory=list)
    _t0: Optional[float] = None

    def start(self):
        self._t0 = time.time()

    def stop(self, bits: int):
        assert self._t0 is not None, "start() first"
        self._times.append(time.time() - self._t0)
        self._bits.append(bits)
        self._t0 = None

    @property
    def bits_per_s(self) -> float:
        b = self._bits[self.warmup:] or self._bits
        t = self._times[self.warmup:] or self._times
        return sum(b) / sum(t) if t and sum(t) > 0 else float("nan")

    def report(self) -> str:
        return f"{self.name}: {self.bits_per_s:.3e} decoded bits/s"
