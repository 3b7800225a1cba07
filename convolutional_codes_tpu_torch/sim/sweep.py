"""Monte-Carlo BER/FER sweep runner with tiered sample counts.

Mirrors the reference drivers' sweeps (SNR grid and sample tiers,
``AWGN-channel/main.c:150-211``; crossover grid and tiers,
``binary-symmetric-channel/main.c:103-156``) as a resumable runner that
produces one record per point, on one device.

Legs (as in the reference package's ``sim/sweep.py``):
  * fused: every config :func:`fused_mc_eligible` accepts runs in the fused
    Monte-Carlo chain — the CUDA kernel on a CUDA device, its plain version
    on the CPU — with the reference's per-chunk seeds, so a CPU run gives
    the same counters as the reference's ``interpret=True`` kernel;
  * modular: other Viterbi configs run the step chain of ``sim/chain.py``;
  * uncoded: the nearest-point baseline.
Stack/Fano decoders, meshes and traces are not ported yet and raise.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import time
from typing import List, Optional, Sequence

import torch

from convolutional_codes_tpu.models.codebook import Code, get_code
from convolutional_codes_tpu_torch.ops.channels import awgn_sigma
from convolutional_codes_tpu_torch.parallel.montecarlo import (
    fused_mc_accumulate, fused_mc_eligible, sharded_accumulate)
from convolutional_codes_tpu_torch.sim.chain import (
    FANO_TIMEOUT, check_decoder, make_point_step, make_uncoded_step)

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
    decoder: str = "viterbi"              # viterbi (stack | fano not ported)
    demapper: str = "soft"                # soft | hard
    points: Optional[Sequence[float]] = None   # Eb/N0 dB or crossover probs
    frames_per_step: int = 4096
    bits_per_point: Optional[float] = None     # override tiering
    base_bits: float = 8e8                # tier base (reference default)
    seed: int = 0
    timeout_per_bit: int = FANO_TIMEOUT
    trace_dir: Optional[str] = None       # profiler traces (not ported)

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
    frame_errors: int       # uncoded: symbol errors (frame == one symbol)
    frames: int             # uncoded: symbols
    ber: float
    fer: float              # uncoded: symbol error rate
    wall_s: float
    bits_per_s: float       # warm steady-state rate when measurable
    #: the first chunk of a point pays kernel build and warm-up; bits/wall
    #: of the remaining chunks are the steady-state numbers (0/0.0 when the
    #: point ran as one chunk, and bits_per_s is then the total-wall rate)
    warm_bits: int = 0
    warm_wall_s: float = 0.0

    def to_dict(self):
        return dataclasses.asdict(self)


def _spec_fingerprint(spec: SweepSpec, code: Code) -> str:
    """Hash of everything that determines a sweep's counters, stored in the
    checkpoint as ``__spec__``.  The payload and encoding equal the
    reference package's, so a checkpoint of either package resumes in the
    other."""
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
    return hashlib.sha256(
        json.dumps(payload, sort_keys=True).encode()).hexdigest()[:16]


def _chunk_seed(seed: int, point_idx: int, chunk_idx: int) -> int:
    """Per-(point, chunk) seed (reference sim/sweep.py:607)."""
    return (seed * 1000003 + point_idx * 7919 + chunk_idx) & 0x7FFFFFFF


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


def run_sweep(spec: SweepSpec, mesh=None, checkpoint_path: Optional[str] = None,
              verbose: bool = True, device="cuda") -> List[PointRecord]:
    """Run the sweep on ``device``, resumable via a JSON checkpoint of
    per-point counters ((seed, counters) is the complete state)."""
    if mesh is not None:
        raise NotImplementedError("meshes are not ported yet (ROADMAP Q1 item 14)")
    if spec.trace_dir:
        raise NotImplementedError("profiler traces are not ported yet "
                                  "(ROADMAP Q1 item 15)")
    code = spec.resolve_code()
    points = spec.resolve_points()
    device = torch.device(device)
    uncoded = spec.channel == "uncoded"
    frames = spec.frames_per_step

    if uncoded:
        step = make_uncoded_step(code.symlen_out, frames, device)
        frame_bits = code.symlen_out
        tier = lambda p: awgn_tier_bits(p, spec.base_bits)
        to_param = lambda p: float(awgn_sigma(p, info_bits_per_symbol=code.symlen_out))
    else:
        check_decoder(spec.decoder)
        frame_bits = code.block_length
        if spec.channel == "awgn":
            tier = lambda p: awgn_tier_bits(p, spec.base_bits)
            to_param = lambda p: float(awgn_sigma(p))
        else:
            tier = lambda p: bsc_tier_bits(p, spec.base_bits)
            to_param = float

    spec_fp = _spec_fingerprint(spec, code)
    done_points = _load_checkpoint(checkpoint_path, spec_fp) if checkpoint_path else {}

    use_fused = (not uncoded and fused_mc_eligible(
        code, spec.channel, spec.decoder, spec.demapper))
    if use_fused:
        eff_frames = max(1024, -(-frames // 1024) * 1024)
    else:
        eff_frames = frames
        if not uncoded:
            step = make_point_step(code, spec.channel, spec.decoder, spec.demapper,
                                   frames, device)
    bits_per_call = eff_frames * frame_bits
    # chunk the accumulation so int32 per-lane counters cannot overflow
    chunk = max(1, (1 << 30) // max(1, bits_per_call))

    records_by_idx = {}

    def finish_point(i, point, param, be, fe, nb, wall, warm_bits, warm_wall):
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

    for i, point in enumerate(points):
        if point in done_points:
            records_by_idx[i] = PointRecord(**done_points[point])
            continue
        param = to_param(point)
        nsteps = max(1, -(-int(spec.bits_per_point or tier(point)) // bits_per_call))
        t0 = tc = time.time()
        be = fe = nb = wb = 0
        ww = 0.0
        left, ci = nsteps, 0
        while left > 0:
            n = min(chunk, left)
            # a point that fits one chunk runs a small cold chunk first, so
            # that it still records a warm rate (reference sweep.py:601)
            if ci == 0 and n == nsteps and n > 1:
                n = max(1, n // 8)
            seed_c = _chunk_seed(spec.seed, i, ci)
            if use_fused:
                cbe, cfe, cnb = fused_mc_accumulate(
                    code, n, seed_c, param, eff_frames, channel=spec.channel,
                    demapper=spec.demapper, device=device)
            else:
                gen = torch.Generator(device=device).manual_seed(seed_c)
                cbe, cfe, cnb = sharded_accumulate(step, n, gen, param)
            be += cbe          # the counters are host ints: the device is done
            fe += cfe
            nb += cnb
            if ci > 0:                          # chunk 0 pays the warm-up
                wb += cnb
                ww += time.time() - tc
            left -= n
            ci += 1
            tc = time.time()
        finish_point(i, point, param, be, fe, nb, time.time() - t0, wb, ww)

    return [records_by_idx[i] for i in sorted(records_by_idx)]
