"""The sequential Monte-Carlo kernels (``ops/stack_mc.py``, ``ops/fano_mc.py``;
TPU kernels 7 and 8) across a mesh.

The reference's sequential decoders are single-threaded host loops
(``AWGN-channel/{fano,stack}-decoder.c``).  Here each sweep point's global
lane set is split into contiguous blocks, one per slot, and each slot runs
one kernel launch a slice with its block's ``lane0``, so every slot decodes
a distinct block of the SAME global frame-id space: a sharded run gives the
counters of the serial same-seed ``mc_stack``/``mc_fano`` run exactly
(the JAX package's ``parallel/seq_grid.py``).  R points (same lanes and
frames a lane) run side by side on ``slots / R`` slots each, sweep-major
and frames-minor.

A point comes in slices, ``(frames_per_lane, seeds)`` each: the sweep's
cold slice of one frame a lane, then its warm slice
(``sim/sweep.sequential_points``).  On each slot the slices launch in plan
order, the first on the device's current stream and the later ones on a
side stream of that device (:func:`side_stream`, made once and reused),
which first waits on the current stream.  So the walks of both slices run
side by side on the card, and a point waits for one drain of its slowest
walks (the budget walks of the Fano cells) instead of one a slice.  Only
after every launch is enqueued does the current stream wait on the side
stream; then each slot's per-lane counters are reduced on the card and
read to the host once, and summed in int64.  Each slice's time on the
card comes from CUDA events on its stream (the host clock on the CPU,
where the plain versions run inside the call).

While a profiler session records (``utils/profiling.py``), each launch is
the span ``mc_launch``, the reductions and the reads ``mc_readback``; the
walks' iterations (the counters' third row) add to the counter
``walk_iters``, and each slot with two slices adds ``walk_cold_ns`` (its
first slice's time), ``walk_overlap_ns`` (the time both were in flight,
0 where they were not) and ``walk_cold_max_iters`` (the most iterations of
a lane of its first slice: one frame a lane, so its longest walk's).
"""

from __future__ import annotations

import functools
import time
from typing import List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from convolutional_codes_tpu_torch.models.codebook import Code
from convolutional_codes_tpu_torch.ops.fano import FANO_TIMEOUT
from convolutional_codes_tpu_torch.ops.fano_mc import mc_fano
from convolutional_codes_tpu_torch.ops.stack_mc import mc_stack
from convolutional_codes_tpu_torch.parallel.mesh import Mesh
from convolutional_codes_tpu_torch.utils import profiling


class SliceCounts(NamedTuple):
    """One slice's counters of R points, and its time on the card."""

    bit_errors: np.ndarray      #: int64 [R]
    frame_errors: np.ndarray    #: int64 [R]
    bits: np.ndarray            #: int64 [R]
    seconds: float              #: first launch's start to last launch's end, longest device


@functools.cache
def side_stream(index: int) -> torch.cuda.Stream:
    """The stream of card ``index`` that a point's later slices run on:
    made at its first use and reused by every point after it."""
    return torch.cuda.Stream(torch.device("cuda", index))


def _device(dev) -> torch.device:
    """``dev`` as a device with its index (the current card for "cuda")."""
    dev = torch.device(dev)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def _stamp(device: torch.device):
    """A mark on ``device``'s current stream: a CUDA event, or the host
    clock on the CPU."""
    if device.type != "cuda":
        return time.perf_counter()
    event = torch.cuda.Event(enable_timing=True)
    event.record(torch.cuda.current_stream(device))
    return event


def _seconds(a, b) -> float:
    """Seconds from mark ``a`` to mark ``b`` of one device."""
    if isinstance(a, float):
        return b - a
    b.synchronize()
    return a.elapsed_time(b) / 1e3


def seq_mc_grid(decoder: str, code: Code, lanes: int,
                slices: Sequence[Tuple[int, Sequence[int]]], params: Sequence[float],
                mesh: Mesh, channel: str = "awgn", demapper: str = "soft",
                timeout_per_bit: int = FANO_TIMEOUT) -> List[SliceCounts]:
    """Run ``R = len(params)`` stack or Fano sweep points across ``mesh``,
    each in ``slices``: ``(frames_per_lane, seeds)``, ``seeds[r]`` point
    ``r``'s seed of that slice.

    ``lanes`` is the GLOBAL lane count per point; the mesh's slots (in axis
    order) split into R contiguous groups of ``slots / R``, slot ``j`` of
    point ``r``'s group decoding lanes ``[j * Bl, (j + 1) * Bl)``, ``Bl =
    lanes / (slots / R)``, of that point.  The counters of slice ``i`` equal
    R serial ``mc_stack/mc_fano(code, lanes, frames_per_lane_i, seeds_i[r],
    params[r])`` runs.  Returns one :class:`SliceCounts` a slice.
    """
    if decoder == "fano":
        mc, kw = mc_fano, dict(timeout_per_bit=timeout_per_bit)
    elif decoder == "stack":
        mc, kw = mc_stack, {}
    else:
        raise ValueError(f"not a sequential decoder: {decoder!r}")
    R, ndev = len(params), mesh.size
    if not slices or any(len(seeds) != R for _, seeds in slices):
        raise ValueError("seeds/params length mismatch")
    if ndev % R:
        raise ValueError(f"{R} points do not divide {ndev} devices")
    dpp = ndev // R
    if lanes % dpp:
        raise ValueError(f"lanes {lanes} not divisible by {dpp} devices/point")
    Bl = lanes // dpp
    local = [(k, _device(dev)) for k, (dev, rank) in enumerate(mesh.slots())
             if rank == mesh.rank]
    devices = list(dict.fromkeys(d for _, d in local))
    cards = [d for d in devices if d.type == "cuda"] if len(slices) > 1 else []
    origin = {d: _stamp(d) for d in devices}   # before every other mark of the call
    for d in cards:   # the later slices start after the work enqueued before them
        side_stream(d.index).wait_stream(torch.cuda.current_stream(d))
    launched = {}   # slot: [(per-lane counters, start, end)] a slice, in plan order
    for k, dev in local:
        r, launched[k] = k // dpp, []
        for i, (fpl, seeds) in enumerate(slices):
            with torch.cuda.stream(side_stream(dev.index) if i and dev in cards else None):
                start = _stamp(dev)
                with profiling.annotate("mc_launch"):
                    out = mc(code, Bl, fpl, seeds[r], params[r], channel=channel,
                             demapper=demapper, device=dev, lane0=(k % dpp) * Bl, **kw)
                launched[k].append((out, start, _stamp(dev)))
    with profiling.annotate("mc_readback"):
        for d in cards:
            torch.cuda.current_stream(d).wait_stream(side_stream(d.index))
        counts = torch.zeros((len(slices), 3, R), dtype=torch.int64)
        for k, dev in local:   # one read a slot: the sums of all its slices
            if dev in cards:   # the later slices' counters come from the side stream
                for out, _, _ in launched[k][1:]:
                    out.record_stream(torch.cuda.current_stream(dev))
            counts[:, :, k // dpp] += torch.stack([out.sum(dim=1)
                                                   for out, _, _ in launched[k]]).cpu()
        if profiling.tracing():
            profiling.count("walk_iters", counts[:, 2].sum())
            if len(slices) > 1:   # the cold slice's longest walk a slot
                for k in launched:
                    profiling.count("walk_cold_max_iters", launched[k][0][0][2].max())
        counts = mesh.sum_over_processes(counts)

    # each launch's start and end, in seconds from its device's origin
    at = {k: [(_seconds(origin[dev], s), _seconds(origin[dev], e)) for _, s, e in launched[k]]
          for k, dev in local}
    if profiling.tracing() and len(slices) > 1:
        for k in at:
            (s0, e0), s1, e1 = at[k][0], at[k][1][0], at[k][-1][1]
            profiling.count("walk_cold_ns", round((e0 - s0) * 1e9))
            profiling.count("walk_overlap_ns", round(max(0.0, min(e0, e1) - max(s0, s1)) * 1e9))
    results = []
    for i, (fpl, _) in enumerate(slices):
        spans = [max(at[k][i][1] for k, d in local if d == dev)
                 - min(at[k][i][0] for k, d in local if d == dev) for dev in devices]
        results.append(SliceCounts(counts[i, 0].numpy(), counts[i, 1].numpy(),
                                   np.full(R, lanes * fpl * code.block_length, np.int64),
                                   max(spans)))
    return results
