"""Monte-Carlo accumulation on one device or across a mesh.

The reference runs one block at a time and sums error counters in C
variables (``AWGN-channel/main.c:212-233``).  Here a point's counters
accumulate over steps of a chain step function (the modular chain) or
inside one fused-kernel launch, on one device or on every slot of a
``frames`` mesh axis (``parallel/mesh.py``), and over the ``sweep`` axis
with one channel parameter per group of slots.

On a mesh, one process launches every slot it owns and moves on, so slots
on distinct cards overlap.  The counters stay on the devices in a
:class:`Tally`: each launch's per-lane counters are reduced in int64 into
an accumulator on that launch's device as soon as it is enqueued, so a
sweep point enqueues all of its launches back to back and reads its
counters once, with one blocking read a device, summed over processes with
``all_reduce`` where the mesh spans several (the JAX package's ``psum``).
While a profiler session records (``utils/profiling.py``), each kernel 3
launch is the span ``mc_launch``, the reductions and the reads to the host
``mc_readback``, and each blocking read adds 1 to the counter
``mc_reads``.  Slot ``d`` of
the frames axis draws from the seed ``(seed * 1315423911 + d) &
0x7FFFFFFF`` (the JAX package's fused path, montecarlo.py:238-240), for
the fused kernel and for the modular chain's generators alike, so a
sweep×frames grid gives the counters of the frames-only runs exactly.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from convolutional_codes_tpu_torch.ops.fused_chain import (
    MAX_POINTS, MAX_STATES, MAX_SYMBOLS, mc_chain_viterbi)
from convolutional_codes_tpu_torch.parallel.mesh import Mesh
from convolutional_codes_tpu_torch.utils.profiling import annotate, count

#: (generator, param) -> (bit_errors, frame_errors, bits) — see sim.chain.
StepFn = Callable


class Tally:
    """The counters of R points while their launches are in flight: on each
    device an int64 [2, R] (bit errors, frame errors) that the launches'
    reductions add to as they are enqueued, and the bits [R] on the host,
    known from the launches' shapes.  Nothing here waits for the device but
    :meth:`read`."""

    def __init__(self, R: int):
        self.errors: Dict[torch.device, torch.Tensor] = {}
        self.bits = np.zeros(R, np.int64)

    def add(self, r: int, bit_errors: torch.Tensor, frame_errors: torch.Tensor,
            bits: int) -> None:
        """Enqueue point ``r``'s counters of one launch or step, per-lane or
        summed, on their device, and add its ``bits``."""
        with annotate("mc_readback"):
            acc = self.errors.get(bit_errors.device)
            if acc is None:
                acc = self.errors[bit_errors.device] = torch.zeros(
                    (2, len(self.bits)), dtype=torch.int64, device=bit_errors.device)
            for row, x in enumerate((bit_errors, frame_errors)):
                acc[row, r].add_(x.sum(dtype=torch.int64) if x.dim() else x)
        self.bits[r] += int(bits)

    def marks(self) -> Dict[torch.device, object]:
        """Now on each of the tally's devices: a CUDA event on its current
        stream, or the host clock on the CPU, where the work is done when
        its call returns."""
        out = {}
        for dev in self.errors:
            if dev.type == "cuda":
                out[dev] = torch.cuda.Event(enable_timing=True)
                out[dev].record(torch.cuda.current_stream(dev))
            else:
                out[dev] = time.perf_counter()
        return out

    @staticmethod
    def seconds(a: dict, b: dict) -> float:
        """The longest device's time from marks ``a`` to marks ``b``, which
        waits for ``b`` (done already after :meth:`read`)."""
        def span(d):
            if isinstance(a[d], float):
                return b[d] - a[d]
            b[d].synchronize()
            return a[d].elapsed_time(b[d]) / 1e3
        return max(map(span, a), default=0.0)

    def read(self, mesh: Optional[Mesh] = None) -> np.ndarray:
        """int64 [3, R] (bit errors, frame errors, bits) on the host: one
        blocking read a device, summed over ``mesh``'s processes (None: this
        process ran every launch)."""
        with annotate("mc_readback"):
            counts = torch.zeros((3, len(self.bits)), dtype=torch.int64)
            for acc in self.errors.values():
                count("mc_reads", 1)
                counts[:2] += acc.cpu()
            counts[2] = torch.from_numpy(self.bits)
            if mesh is not None:
                counts = mesh.sum_over_processes(counts)
        return counts.numpy()


def device_seed(seed: int, d: int) -> int:
    """The seed of slot ``d`` of a frames axis (reference montecarlo.py:238-240)."""
    return (int(seed) * 1315423911 + d) & 0x7FFFFFFF


def per_device(build: Callable[[torch.device], StepFn], mesh: Mesh
               ) -> Callable[[torch.device], StepFn]:
    """A ``device -> step`` map for :func:`frames_accumulate` and
    :func:`grid_accumulate_with_keys` that calls ``build(device)`` once
    for each distinct device of this process's slots, here, and hands the
    same step to every slot on that device afterwards."""
    steps: Dict[torch.device, StepFn] = {}
    for dev, rank in mesh.slots():
        if rank == mesh.rank and dev not in steps:
            steps[dev] = build(dev)
    return steps.__getitem__


def my_slots(seeds, mesh: Mesh, axes) -> list:
    """(device, seed, point index) of this process's slots of a grid over
    ``axes`` (points over ``sweep``, frames over ``frames``; or ``frames``
    alone, one point), ``seeds`` [points, frames] matching the mesh."""
    seeds = np.asarray(seeds, dtype=np.int64)
    R, F = seeds.shape
    if [mesh.shape[a] for a in axes] != ([R, F] if len(axes) == 2 else [F]):
        raise ValueError(f"seeds {seeds.shape} do not match the mesh's {dict(mesh.shape)}")
    return [(dev, int(seeds.flat[k]) & 0x7FFFFFFF, k // F)
            for k, (dev, rank) in enumerate(mesh.slots(axes)) if rank == mesh.rank]


def step_counts(tally: Tally, step: Callable[[torch.device], StepFn], nsteps: int,
                slot_seeds: Sequence[Tuple[torch.device, int, int]], params) -> None:
    """Enqueue ``nsteps`` steps on each slot (device, seed, point index)
    with ``params[point]``, from a generator seeded with the slot's seed,
    into ``tally``."""
    steps = {dev: step(dev) for dev, _, _ in slot_seeds}
    gens = [torch.Generator(device=dev).manual_seed(s) for dev, s, _ in slot_seeds]
    for _ in range(nsteps):   # slot-minor: launches on distinct cards overlap
        for k, (dev, _, r) in enumerate(slot_seeds):
            tally.add(r, *steps[dev](gens[k], params[r]))


def sharded_accumulate(step: StepFn, nsteps: int, generator: torch.Generator, param
                       ) -> Tuple[int, int, int]:
    """Run ``nsteps`` steps at one sweep point on one device, drawing from
    ``generator``; returns summed (bit_errors, frame_errors, bits) ints.
    Across a mesh: :func:`frames_accumulate`."""
    be = fe = nb = 0
    for _ in range(nsteps):   # counters stay on the device until the end
        sbe, sfe, snb = step(generator, param)
        be, fe, nb = be + sbe, fe + sfe, nb + snb
    with annotate("mc_readback"):
        return int(be), int(fe), int(nb)


def frames_accumulate(step: Callable[[torch.device], StepFn], nsteps: int, seed: int,
                      param, mesh: Mesh) -> Tuple[int, int, int]:
    """:func:`sharded_accumulate` over the mesh's ``frames`` axis (the JAX
    package's ``sharded_accumulate(..., mesh)``): every slot of the axis
    runs ``nsteps`` steps of ``step(device)`` from its :func:`device_seed`,
    so the bits scale with the axis size.  ``step`` maps a device to the
    step bound to it (the chain's steps are built for one device;
    :func:`per_device` builds one per distinct device, once)."""
    seeds = [[device_seed(seed, d) for d in range(mesh.shape["frames"])]]
    be, fe, nb = grid_accumulate_with_keys(step, nsteps, seeds, [param], mesh,
                                           axes=("frames",))
    return int(be[0]), int(fe[0]), int(nb[0])


def grid_accumulate_with_keys(step, nsteps: int, seeds, params, mesh: Mesh,
                              axes=("sweep", "frames")
                              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Points over the ``sweep`` axis, frames over ``frames``: slot (r, d)
    runs ``nsteps`` steps of ``step(device)`` (see
    :func:`frames_accumulate`) with ``params[r]``, from a generator seeded
    with ``seeds[r][d]``.  ``run_sweep`` passes the seeds its serial leg
    derives for each point, so the grid and serial sweeps give identical
    counters.  Returns per-point int64 (bit_errors, frame_errors, bits)
    arrays [R]."""
    tally = Tally(len(params))
    step_counts(tally, step, nsteps, my_slots(seeds, mesh, axes), list(params))
    return tuple(tally.read(mesh))


def sweep_grid_accumulate(step, nsteps: int, seed: int, params, mesh: Mesh
                          ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """2-D sharding: ``params`` [R] over the ``sweep`` axis (R its size),
    frames over ``frames``; slot (r, d) draws from ``device_seed(seed,
    r * frames + d)``.  Returns per-point (bit_errors, frame_errors, bits)
    arrays [R]."""
    if "sweep" not in mesh.axis_names or "frames" not in mesh.axis_names:
        raise ValueError(f"sweep_grid_accumulate needs sweep and frames axes, "
                         f"got {mesh.axis_names}")
    R, F = len(params), mesh.shape["frames"]
    seeds = [[device_seed(seed, r * F + d) for d in range(F)] for r in range(R)]
    return grid_accumulate_with_keys(step, nsteps, seeds, params, mesh)


# ---------------------------------------------------------------------------
# The fused kernel: AWGN + soft Viterbi or BSC + hard Viterbi in one launch
# ---------------------------------------------------------------------------

def fused_mc_eligible(code, channel: str, decoder: str, demapper: str) -> bool:
    """The fused Monte-Carlo kernel covers the flagship configs — AWGN +
    soft Viterbi (either demapper) and BSC + hard Viterbi — within its
    per-thread array limits (S <= 256, M <= 8, T <= 256)."""
    if decoder != "viterbi" or channel not in ("bsc", "awgn"):
        return False
    return (code.num_states <= MAX_STATES and code.points_per_symbol <= MAX_POINTS
            and code.num_block_symbols <= MAX_SYMBOLS)


def fused_mc_accumulate(code, nsteps: int, seed: int, param, batch: int,
                        mesh: Mesh = None, channel: str = "awgn",
                        demapper: str = "soft", device="cuda") -> Tuple[int, int, int]:
    """Fused-kernel counterpart of :func:`sharded_accumulate` for the
    Viterbi chains: ``nsteps`` in-kernel steps of ``batch`` lanes (hash RNG
    tile ``min(1024, batch)``, as the reference).  Returns (bit_errors,
    frame_errors, bits).  Without a ``frames`` axis: one launch on
    ``device`` seeded with ``seed & 0x7FFFFFFF``, whose errors come back as
    int64 0-d tensors on ``device``, reduced but not read (``int()`` reads
    them), so that a caller can enqueue its next launch first.  With one: a
    launch on every slot of the axis from its :func:`device_seed`, read and
    summed over the mesh's processes into host ints."""
    if mesh is None or "frames" not in mesh.axis_names:
        with annotate("mc_launch"):
            be, fe = mc_chain_viterbi(code, batch, nsteps, int(seed) & 0x7FFFFFFF, param,
                                      channel, block_lanes=min(1024, batch),
                                      demapper=demapper, device=torch.device(device))
        with annotate("mc_readback"):
            return (be.sum(dtype=torch.int64), fe.sum(dtype=torch.int64),
                    batch * code.block_length * nsteps)
    be, fe, nb = fused_grid_accumulate(
        code, nsteps, [[device_seed(seed, d) for d in range(mesh.shape["frames"])]],
        [param], batch, mesh, channel, demapper, axes=("frames",))
    return int(be[0]), int(fe[0]), int(nb[0])


def fused_grid_accumulate(code, nsteps: int, seeds_2d, params, batch: int,
                          mesh: Mesh, channel: str = "awgn", demapper: str = "soft",
                          axes=("sweep", "frames")):
    """Fused-kernel sweep×frames accumulation: ``seeds_2d`` [R, frames]
    per-(point, slot) seeds with R the sweep axis size, ``params`` [R].
    Counter-identical to R :func:`fused_mc_accumulate` calls with those
    seeds.  Returns int64 (bit_errors, frame_errors, bits) arrays [R]."""
    tally = Tally(len(params))
    for dev, seed, r in my_slots(seeds_2d, mesh, axes):   # launches only: cards overlap
        tally.add(r, *fused_mc_accumulate(code, nsteps, seed, params[r], batch,
                                          channel=channel, demapper=demapper, device=dev))
    return tuple(tally.read(mesh))
