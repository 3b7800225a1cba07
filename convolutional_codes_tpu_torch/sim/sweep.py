"""Monte-Carlo BER/FER sweep runner with tiered sample counts.

Mirrors the reference drivers' sweeps (SNR grid and sample tiers,
``AWGN-channel/main.c:150-211``; crossover grid and tiers,
``binary-symmetric-channel/main.c:103-156``) as a resumable runner that
produces one record per point, on one device or across a mesh
(``parallel/mesh.py``).

Legs (as in the reference package's ``sim/sweep.py``):
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
import hashlib
import json
import os
import shutil
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from convolutional_codes_tpu_torch.models.codebook import Code, get_code
from convolutional_codes_tpu_torch.ops.channels import awgn_sigma
from convolutional_codes_tpu_torch.ops.fano import FANO_TIMEOUT
from convolutional_codes_tpu_torch.parallel.mesh import frames_axis_size, one_slot
from convolutional_codes_tpu_torch.parallel.montecarlo import (
    device_seed, frames_accumulate, fused_grid_accumulate, fused_mc_accumulate,
    fused_mc_eligible, grid_accumulate_with_keys, per_device, sharded_accumulate)
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
    #: point ran as one chunk, and bits_per_s is then the total-wall rate).
    #: A stack/Fano point's warm slice runs beside its cold one: its
    #: warm_wall_s is the warm launch's time on the card (CUDA events on its
    #: stream; the host clock on the CPU), not a host wall of its own
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


def run_sweep(spec: SweepSpec, mesh=None, checkpoint_path: Optional[str] = None,
              verbose: bool = True, device="cuda") -> List[PointRecord]:
    """Run the sweep on ``device`` or across ``mesh``, resumable via a JSON
    checkpoint of per-point counters ((seed, counters) is the complete
    state).  With a mesh, a chunk simulates ``frames`` axis size times the
    bits, and the pieces that run on one device run on the mesh's first
    slot."""
    with annotate("sweep_plan"):   # the code, the fingerprint, the checkpoint, the steps
        code = spec.resolve_code()
        points = spec.resolve_points()
        device = torch.device(mesh.slots()[0][0] if mesh is not None else device)
        frames_mesh = mesh if mesh is not None and "frames" in mesh.axis_names else None
        ndev = frames_axis_size(mesh)
        uncoded = spec.channel == "uncoded"
        frames = spec.frames_per_step

        sequential = not uncoded and spec.decoder in ("stack", "fano")
        stream = spec.stream_window > 0
        frame_bits = (code.symlen_out if uncoded else
                      spec.stream_window if stream else code.block_length)
        if uncoded:
            to_param = lambda p: float(awgn_sigma(p, info_bits_per_symbol=code.symlen_out))
        else:
            to_param = (lambda p: float(awgn_sigma(p))) if spec.channel == "awgn" else float

        spec_fp = _spec_fingerprint(spec, code)
        done_points = _load_checkpoint(checkpoint_path, spec_fp) if checkpoint_path else {}

        use_fused = (not uncoded and not stream and fused_mc_eligible(
            code, spec.channel, spec.decoder, spec.demapper))
        eff_frames = max(1024, -(-frames // 1024) * 1024) if use_fused else frames
        step = None
        if uncoded or not (sequential or use_fused or stream):
            # the chain's steps are built for one device: one per distinct slot device
            build = ((lambda dev: make_uncoded_step(code.symlen_out, frames, dev)) if uncoded
                     else (lambda dev: make_point_step(code, spec.channel, spec.decoder,
                                                       spec.demapper, frames, device=dev)))
            step = per_device(build, frames_mesh) if frames_mesh else build(device)
        # a stream chunk's windows are split over the slots: its bits do not scale
        bits_per_call = eff_frames * frame_bits * (1 if stream else ndev)
        chunk = max(1, CHUNK_BITS // max(1, eff_frames * frame_bits))

        # plan: (index, point, param, nsteps) for every point not checkpointed
        records_by_idx = {}
        pending = []
        for i, point in enumerate(points):
            if point in done_points:
                records_by_idx[i] = PointRecord(**done_points[point])
                continue
            pending.append((i, point, to_param(point),
                            max(1, -(-target_bits(spec, point) // bits_per_call))))

    def finish_point(i, point, param, be, fe, nb, wall, warm_bits, warm_wall):
        with annotate("sweep_record"):
            rate = (warm_bits / warm_wall if warm_wall > 0
                    else (nb / wall if wall > 0 else float("inf")))
            rec = PointRecord(
                code=f"uncoded-{code.symlen_out}bit" if uncoded else code.name,
                channel=spec.channel,
                decoder="argmin" if uncoded else spec.decoder,
                demapper=spec.demapper, point=float(point), param=param,
                bits=nb, bit_errors=be, frame_errors=fe,
                frames=nb // frame_bits, ber=be / nb, fer=fe / (nb // frame_bits),
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

    def chunks(nsteps):
        """(chunk index, steps) of a point: a point that fits one chunk runs
        a small cold chunk first, so that it still records a warm rate
        (reference sweep.py:601).  The partition feeds the seeds, so every
        leg takes it from here."""
        left, ci = nsteps, 0
        while left > 0:
            n = min(chunk, left)
            if ci == 0 and n == nsteps and n > 1:
                n = max(1, n // 8)
            yield ci, n
            left -= n
            ci += 1

    # ---- the sweep×frames grid: equal step counts side by side over `sweep`
    if (mesh is not None and not sequential and not stream and "sweep" in mesh.axis_names
            and frames_mesh is not None):
        Ds = mesh.shape["sweep"]
        by_steps = {}
        for item in pending:
            by_steps.setdefault(item[3], []).append(item)
        pending = []
        for nsteps, group in by_steps.items():
            while len(group) >= Ds:
                batch, group = group[:Ds], group[Ds:]
                prms = [it[2] for it in batch]
                tot = np.zeros((3, Ds), np.int64)
                warm = np.zeros(Ds, np.int64)
                t0 = tc = time.time()
                ww = 0.0
                with point_traces(spec.trace_dir, [it[1] for it in batch]):
                    for ci, n in chunks(nsteps):
                        seeds = [[device_seed(_chunk_seed(spec.seed, it[0], ci), d)
                                  for d in range(ndev)] for it in batch]
                        if use_fused:
                            out = fused_grid_accumulate(code, n, seeds, prms, eff_frames,
                                                        mesh, spec.channel, spec.demapper)
                        else:
                            out = grid_accumulate_with_keys(step, n, seeds, prms, mesh)
                        tot += np.stack(out)
                        if ci > 0:                      # chunk 0 pays the warm-up
                            warm += out[2]
                            ww += time.time() - tc
                        tc = time.time()
                wall = (time.time() - t0) / Ds       # side by side: amortised
                for r, (i, point, param, _) in enumerate(batch):
                    finish_point(i, point, param, int(tot[0, r]), int(tot[1, r]),
                                 int(tot[2, r]), wall, int(warm[r]), ww / Ds)
            pending.extend(group)
        pending.sort()

    # ---- stack/Fano: points of one plan side by side over the mesh's slots
    if sequential:
        one = one_slot(device)
        grid = mesh if mesh is not None else one
        by_plan = {}
        for item in pending:
            by_plan.setdefault(seq_plan(target_bits(spec, item[1]), frame_bits),
                               []).append(item)
        pending = []
        for (lanes, _), group in sorted(by_plan.items()):
            while group:
                R = next((d for d in range(min(len(group), grid.size), 0, -1)
                          if grid.size % d == 0 and lanes % (grid.size // d) == 0), 0)
                # no grouping of the slots divides the lanes: the first slot alone
                batch, group = group[:max(R, 1)], group[max(R, 1):]
                t0 = time.time()
                with point_traces(spec.trace_dir, [it[1] for it in batch]):
                    outs = sequential_points(spec, code, [it[:3] for it in batch],
                                             grid if R else one)
                wall = (time.time() - t0) / len(batch)   # side by side: amortised
                for (i, point, param, _), (be, fe, nb, wb, ww) in zip(batch, outs):
                    finish_point(i, point, param, be, fe, nb, wall, wb, ww)

    for i, point, param, nsteps in pending:
        t0 = tc = time.time()
        be = fe = nb = wb = 0
        ww = 0.0
        with point_traces(spec.trace_dir, [point]):
            for ci, n in chunks(nsteps):
                seed_c = _chunk_seed(spec.seed, i, ci)
                if stream:
                    cbe, cfe, cnb = stream_mc_counts(
                        code, frames, n, seed_c, param, spec.channel, spec.demapper,
                        spec.stream_window, spec.stream_warmup, frames_mesh, device)
                elif use_fused:
                    cbe, cfe, cnb = fused_mc_accumulate(
                        code, n, seed_c, param, eff_frames, frames_mesh,
                        channel=spec.channel, demapper=spec.demapper, device=device)
                elif frames_mesh is not None:
                    cbe, cfe, cnb = frames_accumulate(step, n, seed_c, param, frames_mesh)
                else:
                    gen = torch.Generator(device=device).manual_seed(seed_c)
                    cbe, cfe, cnb = sharded_accumulate(step, n, gen, param)
                be += cbe          # the counters are host ints: the device is done
                fe += cfe
                nb += cnb
                if ci > 0:                          # chunk 0 pays the warm-up
                    wb += cnb
                    ww += time.time() - tc
                tc = time.time()
        finish_point(i, point, param, be, fe, nb, time.time() - t0, wb, ww)

    return [records_by_idx[i] for i in sorted(records_by_idx)]
