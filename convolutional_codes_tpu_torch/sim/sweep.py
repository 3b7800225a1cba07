"""Monte-Carlo BER/FER sweep runner with tiered sample counts.

Mirrors the reference drivers' sweeps (SNR grid and sample tiers,
``AWGN-channel/main.c:150-211``; crossover grid and tiers,
``binary-symmetric-channel/main.c:103-156``) as a resumable runner that
produces one record per point, on one device or across a mesh
(``parallel/mesh.py``).

Legs (as in the reference package's ``sim/sweep.py``), decided once a
sweep by :func:`_leg`, by the first of these rules that holds (uncoded,
stack/Fano, stream, fused, modular); every leg but the sequential one runs
its points through one chunk loop (:func:`_chunked`), which enqueues all
of a point's chunks, their counters summed on the device, and reads them
once, after the last launch:
  * fused: every config :func:`fused_mc_eligible` accepts runs in the fused
    Monte-Carlo chain — the CUDA kernel on a CUDA device, its plain version
    on the CPU — with the reference's per-chunk seeds, so a CPU run gives
    the same counters as the reference's ``interpret=True`` kernel;
  * sequential: every stack/Fano point runs the sequential Monte-Carlo
    kernels (``ops/stack_mc.py``, ``ops/fano_mc.py``; their plain versions
    on the CPU) through ``parallel/seq_grid.py``, on one slot without a
    mesh, with the reference's frame addressing (:func:`seq_plan`,
    :func:`sequential_points`), so BSC counters equal the reference's TPU
    records; a point's cold and warm slices are enqueued together, the
    warm one on a side stream, so that on the card the point waits for one
    drain of its slowest walks rather than one a slice, and both come back
    in one read-back; the reference's VMEM gates on T*M do not apply here;
  * stream: with ``stream_window`` > 0, a Viterbi point runs long
    streaming frames (``parallel/streaming.stream_mc_counts``, the fused
    long-frame kernel 6 or its plain version on the CPU): a step is one
    overlap-save window of ``stream_window`` payload symbols (halos of
    ``stream_warmup`` on both sides) in every lane, and a chunk is one
    launch of fresh, unbroken streams from window 0;
  * modular: other Viterbi configs run the step chain of ``sim/chain.py``;
  * uncoded: the nearest-point baseline.
On a mesh: points of equal step counts run side by side over the ``sweep``
axis, each summed over ``frames`` (the sweep×frames grid); stack/Fano
points run their lanes over every slot (``parallel/seq_grid.py``); stream
points run one at a time, each chunk's windows split by time range over
the slots of a mesh with a ``frames`` axis; the rest run one at a time
over the ``frames`` axis.  Every leg derives its seeds as the serial leg
does, so the grid legs give the serial legs' counters exactly.

``trace_dir`` captures one profiler trace a point (``utils/profiling.py``)
under ``trace_dir/point_<p>``, its work annotated ``sweep_point_<p>``, as
the reference's sweep does; points that run side by side share one trace,
written under each of their directories.  Under any profiler session the
preamble is the span ``sweep_plan`` and each point's record
``sweep_record``; the legs' launches and read-backs are spans of
``parallel/`` (``mc_launch``, ``mc_readback``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import hashlib
import json
import os
import shutil
import time
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from convolutional_codes_tpu_torch.models.codebook import Code, get_code
from convolutional_codes_tpu_torch.ops.channels import awgn_sigma
from convolutional_codes_tpu_torch.ops.fano import FANO_TIMEOUT
from convolutional_codes_tpu_torch.parallel.mesh import frames_axis_size, one_slot
from convolutional_codes_tpu_torch.parallel.montecarlo import (
    Tally, device_seed, fused_mc_accumulate, fused_mc_eligible, my_slots, per_device,
    step_counts)
from convolutional_codes_tpu_torch.parallel.seq_grid import seq_mc_grid
from convolutional_codes_tpu_torch.parallel.streaming import stream_mc_counts
from convolutional_codes_tpu_torch.sim.chain import make_point_step, make_uncoded_step
from convolutional_codes_tpu_torch.utils.profiling import annotate, trace

#: Default Eb/N0 grid in dB (AWGN-channel/main.c:150-152).
AWGN_SNR_GRID = (0.0, 2.0, 4.0, 6.0, 8.0, 10.0, 12.0, 14.0)

#: Default crossover grid (binary-symmetric-channel/main.c:103-109).
BSC_CROSSOVER_GRID = tuple(r / 1e6 for r in (
    1, 5, 25, 125, 625, 3125, 6250, 12500, 15625, 25000, 50000,
    78125, 100000, 200000, 300000, 390625, 400000))


def awgn_tier_bits(snr_db: float, base_bits: float = 8e8) -> int:
    """Adaptive sample tiers: /10 at <=10, <=6, <=4 dB cumulatively
    (AWGN-channel/main.c:202-211)."""
    bits = base_bits
    if snr_db <= 4.0:
        bits /= 10
    if snr_db <= 6.0:
        bits /= 10
    if snr_db <= 10.0:
        bits /= 10
    return int(bits)


def bsc_tier_bits(crossover: float, base_bits: float = 8e8) -> int:
    """Tiers: /10 above p=0.0125, 0.05, 0.2 cumulatively
    (binary-symmetric-channel/main.c:147-156)."""
    bits = base_bits
    if crossover > 0.0125:
        bits /= 10
    if crossover > 0.05:
        bits /= 10
    if crossover > 0.2:
        bits /= 10
    return int(bits)


@dataclasses.dataclass
class SweepSpec:
    """Full configuration of one sweep."""

    code: object = 0                      # registry key or Code
    channel: str = "awgn"                 # awgn | bsc | uncoded
    decoder: str = "viterbi"              # viterbi | stack | fano
    demapper: str = "soft"                # soft | hard
    points: Optional[Sequence[float]] = None   # Eb/N0 dB or crossover probs
    frames_per_step: int = 4096
    bits_per_point: Optional[float] = None     # override tiering
    base_bits: float = 8e8                # tier base (reference default)
    seed: int = 0
    timeout_per_bit: int = FANO_TIMEOUT
    trace_dir: Optional[str] = None       # one profiler trace a point under it
    stream_window: int = 0                # payload symbols a stream window; 0: terminated blocks
    stream_warmup: int = 128              # halo symbols on each side of a stream window

    def __post_init__(self):
        if self.stream_window < 0 or self.stream_warmup < 0:
            raise ValueError(f"stream_window {self.stream_window} and stream_warmup "
                             f"{self.stream_warmup} must not be negative")
        if self.stream_window and (self.decoder != "viterbi"
                                   or self.channel not in ("awgn", "bsc")):
            raise ValueError(f"stream_window runs the Viterbi decoder on awgn or bsc, "
                             f"got decoder {self.decoder!r} on {self.channel!r}")

    def resolve_code(self) -> Code:
        return self.code if isinstance(self.code, Code) else get_code(self.code)

    def resolve_points(self) -> Sequence[float]:
        if self.points is not None:
            return tuple(self.points)
        return AWGN_SNR_GRID if self.channel in ("awgn", "uncoded") else BSC_CROSSOVER_GRID


@dataclasses.dataclass
class PointRecord:
    code: str
    channel: str
    decoder: str
    demapper: str
    point: float            # Eb/N0 dB (awgn/uncoded) or crossover prob (bsc)
    param: float            # sigma or crossover actually applied
    bits: int
    bit_errors: int
    frame_errors: int       # uncoded: symbol errors (frame == one symbol); stream: bad windows
    frames: int             # uncoded: symbols; stream: windows
    ber: float
    fer: float              # uncoded: symbol error rate; stream: window error rate
    wall_s: float
    bits_per_s: float       # warm steady-state rate when measurable
    #: the first chunk of a point pays kernel build and warm-up; bits/wall
    #: of the remaining chunks are the steady-state numbers (0/0.0 when the
    #: point ran as one chunk, and bits_per_s is then the total-wall rate):
    #: the time from chunk 0's end to the last chunk's end on the card (CUDA
    #: events; the host clock on the CPU).  A stack/Fano point's warm slice
    #: runs beside its cold one: its warm_wall_s is the warm launch's time
    #: on the card (CUDA events on its stream; the host clock on the CPU)
    warm_bits: int = 0
    warm_wall_s: float = 0.0

    def to_dict(self):
        return dataclasses.asdict(self)


def _spec_fingerprint(spec: SweepSpec, code: Code) -> str:
    """Hash of everything that determines a sweep's counters, stored in the
    checkpoint as ``__spec__``.  The payload and encoding equal the
    reference package's, so a checkpoint of either package resumes in the
    other; a stream spec adds its window and warm-up."""
    payload = {
        "code": code.name,
        "polys": list(code.polynomials),
        "K": code.constraint_length,
        "L": code.block_length,
        "parity": code.parity,
        "channel": spec.channel,
        "decoder": spec.decoder,
        "demapper": spec.demapper,
        "base_bits": spec.base_bits,
        "bits_per_point": spec.bits_per_point,
        "seed": spec.seed,
        "timeout_per_bit": spec.timeout_per_bit,
        "frames_per_step": spec.frames_per_step,
    }
    if spec.stream_window:
        payload.update(stream_window=spec.stream_window, stream_warmup=spec.stream_warmup)
    return hashlib.sha256(
        json.dumps(payload, sort_keys=True).encode()).hexdigest()[:16]


def _chunk_seed(seed: int, point_idx: int, chunk_idx: int) -> int:
    """Per-(point, chunk) seed (reference sim/sweep.py:607); chunk 0 is also
    the sequential leg's point seed (:569)."""
    return (seed * 1000003 + point_idx * 7919 + chunk_idx) & 0x7FFFFFFF


#: a chunk simulates at most this many info bits: its int32 per-lane
#: counters cannot overflow
CHUNK_BITS = 1 << 30


def target_bits(spec: SweepSpec, point: float) -> int:
    """Info bits a point asks for: ``bits_per_point`` or the channel's tier."""
    if spec.bits_per_point:
        return int(spec.bits_per_point)
    tier = bsc_tier_bits if spec.channel == "bsc" else awgn_tier_bits
    return int(tier(point, spec.base_bits))


#: the sequential leg's warm slice runs with the point seed xored with this
#: (reference sim/sweep.py:579)
WARM_SEED_XOR = 0x2A5A5A5A


def seq_plan(target: int, frame_bits: int) -> Tuple[int, int]:
    """(lanes, frames per lane) of a sequential Monte-Carlo point
    (reference sim/sweep.py:424-431): 8192 lanes, or 1024 below 8192
    frames' worth of bits."""
    lanes = 8192 if target >= 8192 * frame_bits else 1024
    return lanes, max(1, -(-target // (lanes * frame_bits)))


def sequential_points(spec: SweepSpec, code: Code, batch, mesh
                      ) -> List[Tuple[int, int, int, int, float]]:
    """R = ``len(batch)`` stack/Fano points ``(index, point, param)`` of
    one :func:`seq_plan` side by side over ``mesh`` (``seq_mc_grid``; a
    one-slot mesh runs them one launch a slice each): a cold slice of one
    frame per lane with the point seeds, and a warm slice of ``fpl - 1``
    frames per lane with the seeds xored by :data:`WARM_SEED_XOR`
    (reference sim/sweep.py:558-585), enqueued together so that the two
    run side by side on the card, with one read-back for both.  Frame ``k``
    of global lane ``g`` is ``gid = g * fpl + k`` within each slice.
    Returns per point (bit_errors, frame_errors, bits, warm_bits,
    warm_wall_s): ``warm_wall_s`` is the warm slice's time on the card
    (CUDA events around its launches; the host clock on the CPU), spread
    over the R points."""
    lanes, fpl = seq_plan(target_bits(spec, batch[0][1]), code.block_length)
    kw = dict(channel=spec.channel, demapper=spec.demapper)
    if spec.decoder == "fano":
        kw["timeout_per_bit"] = spec.timeout_per_bit
    prms = [param for _, _, param in batch]
    seeds = [_chunk_seed(spec.seed, i, 0) for i, _, _ in batch]
    slices = [(1, seeds)]            # the cold slice pays the warm-up
    if fpl > 1:
        slices.append((fpl - 1, [s ^ WARM_SEED_XOR for s in seeds]))
    # the counters come back to the host: the device is done
    outs = seq_mc_grid(spec.decoder, code, lanes, slices, prms, mesh, **kw)
    be, fe, nb = (sum(out[j] for out in outs) for j in range(3))
    warm_bits, warm_wall = np.zeros_like(nb), 0.0
    if fpl > 1:
        warm_bits, warm_wall = outs[1].bits, outs[1].seconds / len(batch)
    return [(int(be[r]), int(fe[r]), int(nb[r]), int(warm_bits[r]), warm_wall)
            for r in range(len(batch))]


def _load_checkpoint(path: str, spec_fp: str) -> dict:
    try:
        with open(path) as f:
            raw = json.load(f)
    except FileNotFoundError:
        return {}
    if raw.get("__spec__") != spec_fp:
        raise ValueError(
            f"checkpoint {path} was written by a different sweep spec "
            f"(fingerprint {raw.get('__spec__')!r} != {spec_fp!r}); refusing "
            "to resume — delete it or point the sweep elsewhere")
    return {float(k): v for k, v in raw.items() if k != "__spec__"}


@contextlib.contextmanager
def point_traces(trace_dir: Optional[str], points: Sequence[float]):
    """Annotate the enclosed work ``sweep_point_<p>`` for each of
    ``points`` (run side by side) and, with ``trace_dir``, trace it under
    ``trace_dir/point_<p>``: written under the first point's directory and
    copied under the others'."""
    dirs = [os.path.join(trace_dir, f"point_{p:g}") for p in points] if trace_dir else [None]
    with trace(dirs[0]), contextlib.ExitStack() as names:
        for p in points:
            names.enter_context(annotate(f"sweep_point_{p:g}"))
        yield
    for d in dirs[1:]:
        shutil.copytree(dirs[0], d, dirs_exist_ok=True)


@dataclasses.dataclass
class _Leg:
    """What :func:`run_sweep` needs of the leg that runs a spec, decided
    once by :func:`_leg`.  ``batches(pending)`` yields the pending points
    ``(index, point, param, nsteps)`` in the batches that run side by side,
    each with the function that runs it, which returns per point
    (bit_errors, frame_errors, bits, warm_bits, warm_wall_s)."""

    code: str                           # the records' code and decoder
    decoder: str
    to_param: Callable[[float], float]  # a point's sigma or crossover
    frame_bits: int                     # info bits a frame (stream: a window)
    bits_per_call: int                  # info bits a step over every slot
    batches: Callable


def _leg(spec: SweepSpec, code: Code, mesh, device: torch.device) -> _Leg:
    """The leg that runs ``spec``, by the first of these rules that holds:
    uncoded, the nearest-point baseline through the step chain; stack or
    Fano, the sequential leg; ``stream_window`` > 0, the stream leg (kernel
    6); :func:`fused_mc_eligible`, the fused leg (kernel 3, on lanes
    rounded up to 1024s); else the modular step chain.  A stream chunk's
    windows are split over a ``frames`` mesh's slots, so its bits do not
    scale with them.  ``fused_mc_accumulate`` is looked up at each call."""
    frames, ndev = spec.frames_per_step, frames_axis_size(mesh)
    frames_mesh = mesh if mesh is not None and "frames" in mesh.axis_names else None
    name, decoder, frame_bits = code.name, spec.decoder, code.block_length
    to_param = (lambda p: float(awgn_sigma(p))) if spec.channel == "awgn" else float
    if spec.channel == "uncoded":
        width = code.symlen_out
        name, decoder, frame_bits = f"uncoded-{width}bit", "argmin", width
        to_param = lambda p: float(awgn_sigma(p, info_bits_per_symbol=width))
        batches = _chain(spec, lambda dev: make_uncoded_step(width, frames, dev),
                         frames * width, mesh, frames_mesh, device)
    elif spec.decoder in ("stack", "fano"):
        batches = functools.partial(_sequential_batches, spec, code, mesh, device)
    elif spec.stream_window > 0:
        frame_bits, ndev = spec.stream_window, 1
        one = lambda tally, seeds, n, params: stream_mc_counts(
            tally, code, frames, n, seeds[0], params[0], spec.channel, spec.demapper,
            spec.stream_window, spec.stream_warmup, frames_mesh, device)
        batches = _chunked(spec, mesh, frames * frame_bits, one)
    elif fused_mc_eligible(code, spec.channel, spec.decoder, spec.demapper):
        frames = max(1024, -(-frames // 1024) * 1024)

        def fused(tally, slots, n, params):
            for dev, seed, r in slots:   # launches only: distinct cards overlap
                tally.add(r, *fused_mc_accumulate(code, n, seed, params[r], frames,
                                                  channel=spec.channel,
                                                  demapper=spec.demapper, device=dev))

        batches = _chunked(spec, mesh, frames * frame_bits,
                           *_on_slots(fused, mesh, frames_mesh, device))
    else:
        build = lambda dev: make_point_step(code, spec.channel, spec.decoder,
                                            spec.demapper, frames, device=dev)
        batches = _chain(spec, build, frames * frame_bits, mesh, frames_mesh, device)
    return _Leg(name, decoder, to_param, frame_bits, frames * frame_bits * ndev, batches)


def _on_slots(run, mesh, frames_mesh, device):
    """``one`` and ``grid`` calls of :func:`_chunked` that enqueue ``run(tally,
    slots, n, params)`` on this process's slots (device, seed, point index):
    ``device`` alone, else every slot of the ``frames`` axis from the
    point's :func:`device_seed`, and on the sweep×frames grid point ``r``'s
    row of slots, so that the grid gives the serial leg's counters."""
    F = frames_axis_size(frames_mesh)
    if frames_mesh is None:
        one = lambda tally, seeds, n, params: run(tally, [(device, seeds[0], 0)], n, params)
    else:
        one = lambda tally, seeds, n, params: run(tally, my_slots(
            [[device_seed(seeds[0], d) for d in range(F)]], frames_mesh, ("frames",)), n, params)
    grid = lambda tally, seeds, n, params: run(tally, my_slots(
        [[device_seed(x, d) for d in range(F)] for x in seeds], mesh, ("sweep", "frames")),
        n, params)
    return one, grid


def _chain(spec: SweepSpec, build, step_bits: int, mesh, frames_mesh, device):
    """:func:`_chunked` batches of a step chain: ``build(device)`` gives a
    step bound to one device, built here for each distinct slot device."""
    step = per_device(build, frames_mesh if frames_mesh is not None else one_slot(device))
    run = lambda tally, slots, n, params: step_counts(tally, step, n, slots, params)
    return _chunked(spec, mesh, step_bits, *_on_slots(run, mesh, frames_mesh, device))


def _chunked(spec: SweepSpec, mesh, step_bits: int, one, grid=None):
    """``batches`` of a leg that runs chunk by chunk, ``step_bits`` (a
    step's info bits on one slot) sizing the chunks.  ``one(tally, [seed],
    n, [param])`` enqueues ``n`` steps of a point into the
    ``montecarlo.Tally`` ``tally``, over the ``frames`` axis where the mesh
    has one; ``grid(tally, seeds, n, params)`` enqueues R points side by
    side on a sweep×frames mesh, R the ``sweep`` axis size.  There, points
    of equal step counts run R at a time and the rest one at a time;
    elsewhere every point runs alone, in index order."""
    chunk = max(1, CHUNK_BITS // max(1, step_bits))
    frames_mesh = mesh if mesh is not None and "frames" in mesh.axis_names else None

    def run(call, over, batch):
        """The R points of ``batch`` (one step count) chunk by chunk, chunk
        ``ci`` from the points' ``_chunk_seed(spec.seed, i, ci)``, every
        chunk enqueued before the one read of the points' counters (summed
        over ``over``'s processes).  A point that fits one chunk runs a
        small cold chunk first, so that it still records a warm rate
        (reference sweep.py:601): the bits after chunk 0, which pays the
        warm-up, over the time from chunk 0's end to the last chunk's end
        (CUDA events on the card, the host clock on the CPU), amortised
        over the R points."""
        R, nsteps = len(batch), batch[0][3]
        tally, left, ci = Tally(R), nsteps, 0
        while left > 0:
            n = min(chunk, left)
            if ci == 0 and n == nsteps and n > 1:
                n = max(1, n // 8)
            call(tally, [_chunk_seed(spec.seed, it[0], ci) for it in batch], n,
                 [it[2] for it in batch])
            if ci == 0:
                cold, warm_from = n, tally.marks()
            left, ci = left - n, ci + 1
        warm_to = tally.marks() if ci > 1 else None
        be, fe, nb = tally.read(over)   # the counters are host ints: the device is done
        ww = Tally.seconds(warm_from, warm_to) / R if ci > 1 else 0.0
        return [(int(be[r]), int(fe[r]), int(nb[r]), int(nb[r]) - int(nb[r]) * cold // nsteps, ww)
                for r in range(R)]

    def batches(pending):
        rest = pending
        if grid is not None and mesh is not None and {"sweep", "frames"} <= set(mesh.axis_names):
            Ds, by_steps, rest = mesh.shape["sweep"], {}, []
            for item in pending:
                by_steps.setdefault(item[3], []).append(item)
            for group in by_steps.values():
                cut = len(group) - len(group) % Ds
                for k in range(0, cut, Ds):
                    yield group[k:k + Ds], functools.partial(run, grid, mesh)
                rest += group[cut:]
        for item in sorted(rest):
            yield [item], functools.partial(run, one, frames_mesh)

    return batches


def _sequential_batches(spec: SweepSpec, code: Code, mesh, device, pending):
    """Stack/Fano: the points of one :func:`seq_plan` side by side over the
    mesh's slots (one slot without a mesh), as many as a grouping of the
    slots that divides the lanes takes, each run by
    :func:`sequential_points`."""
    one = one_slot(device)
    grid = mesh if mesh is not None else one
    by_plan = {}
    for item in pending:
        by_plan.setdefault(seq_plan(target_bits(spec, item[1]), code.block_length),
                           []).append(item)
    for (lanes, _), group in sorted(by_plan.items()):
        while group:
            R = next((d for d in range(min(len(group), grid.size), 0, -1)
                      if grid.size % d == 0 and lanes % (grid.size // d) == 0), 0)
            # no grouping of the slots divides the lanes: the first slot alone
            batch, group = group[:max(R, 1)], group[max(R, 1):]
            slots = grid if R else one
            yield batch, lambda b, slots=slots: sequential_points(
                spec, code, [it[:3] for it in b], slots)


def run_sweep(spec: SweepSpec, mesh=None, checkpoint_path: Optional[str] = None,
              verbose: bool = True, device="cuda") -> List[PointRecord]:
    """Run the sweep on ``device`` or across ``mesh``, resumable via a JSON
    checkpoint of per-point counters ((seed, counters) is the complete
    state).  With a mesh, a chunk simulates ``frames`` axis size times the
    bits, and the pieces that run on one device run on the mesh's first
    slot."""
    with annotate("sweep_plan"):   # the code, the fingerprint, the checkpoint, the leg
        code = spec.resolve_code()
        points = spec.resolve_points()
        device = torch.device(mesh.slots()[0][0] if mesh is not None else device)
        spec_fp = _spec_fingerprint(spec, code)
        done_points = _load_checkpoint(checkpoint_path, spec_fp) if checkpoint_path else {}
        leg = _leg(spec, code, mesh, device)

        # plan: (index, point, param, nsteps) for every point not checkpointed
        records_by_idx = {}
        pending = []
        for i, point in enumerate(points):
            if point in done_points:
                records_by_idx[i] = PointRecord(**done_points[point])
                continue
            pending.append((i, point, leg.to_param(point),
                            max(1, -(-target_bits(spec, point) // leg.bits_per_call))))

    for batch, run in leg.batches(pending):
        t0 = time.time()
        with point_traces(spec.trace_dir, [it[1] for it in batch]):
            outs = run(batch)
        wall = (time.time() - t0) / len(batch)       # side by side: amortised
        for (i, point, param, _), (be, fe, nb, warm_bits, warm_wall) in zip(batch, outs):
            with annotate("sweep_record"):
                rate = (warm_bits / warm_wall if warm_wall > 0
                        else (nb / wall if wall > 0 else float("inf")))
                rec = PointRecord(
                    code=leg.code, channel=spec.channel, decoder=leg.decoder,
                    demapper=spec.demapper, point=float(point), param=param,
                    bits=nb, bit_errors=be, frame_errors=fe,
                    frames=nb // leg.frame_bits, ber=be / nb, fer=fe / (nb // leg.frame_bits),
                    wall_s=wall, bits_per_s=rate,
                    warm_bits=warm_bits, warm_wall_s=warm_wall)
                records_by_idx[i] = rec
                if verbose:
                    print(f"[{spec.channel}/{spec.decoder}/{spec.demapper} {code.name}] "
                          f"point={point:g} bits={nb:.3g} BER={rec.ber:.6e} "
                          f"FER={rec.fer:.3e} {rec.bits_per_s:.3e} bits/s", flush=True)
                if checkpoint_path:
                    done_points[point] = rec.to_dict()
                    payload = {str(k): v for k, v in done_points.items()}
                    payload["__spec__"] = spec_fp
                    with open(checkpoint_path, "w") as f:
                        json.dump(payload, f)

    return [records_by_idx[i] for i in sorted(records_by_idx)]
