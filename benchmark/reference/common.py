"""Plain PyTorch pieces the reference decoders share: the code from its
configuration file, 32-bit hashing, the encoder, the trellis, the
constellation and demapper, and how ``run_sweep`` addresses a point's
frames.

Everything here is worked out again from the configuration's file and the
seed; nothing is read from the program under test.  The hashes, the
encoder's parity quirk and the frame addressing are frozen copies of the
semantics the port documents (its ``ops/fused_chain.py``,
``ops/fused_longframe.py``, ``ops/encoder.py``, ``models/trellis.py`` and
``sim/sweep.py``), written again here so that a change in the program
cannot change its own yardstick.

32-bit values live in int64 tensors, masked after every step that could
leave the range.  ``dtype`` arguments select the float precision of the
channel and the metrics: float32 as the configurations state it, or a lower
one for the control (``benchmark/control.py``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Iterator, List, Sequence, Tuple

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
TWO_PI = 2.0 * math.pi


# --------------------------------------------------------------------------
# the code
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CodeSpec:
    """A convolutional code as the configuration file states it."""

    name: str
    symlen_out: int
    constraint_length: int
    block_length: int
    polynomials: Tuple[int, ...]
    parity: str
    bit_metrics: Tuple[int, int]
    fano_bit_metrics: Tuple[int, int]
    metric_weight: float
    fano_metric_weight: float

    @classmethod
    def from_config(cls, cfg: dict) -> "CodeSpec":
        c = cfg["code"]
        return cls(name=c["name"], symlen_out=int(c["symlen_out"]),
                   constraint_length=int(c["constraint_length"]),
                   block_length=int(c["block_length"]),
                   polynomials=tuple(int(p) for p in c["polynomials"]),
                   parity=c["parity"], bit_metrics=tuple(c["bit_metrics"]),
                   fano_bit_metrics=tuple(c["fano_bit_metrics"]),
                   metric_weight=float(c["metric_weight"]),
                   fano_metric_weight=float(c["fano_metric_weight"]))

    @property
    def num_states(self) -> int:
        return 1 << (self.constraint_length - 1)

    @property
    def num_block_symbols(self) -> int:
        """Symbols of a terminated block: L info bits and K - 1 tail bits."""
        return self.block_length + self.constraint_length - 1

    @property
    def points_per_symbol(self) -> int:
        return 1 << self.symlen_out

    @property
    def quirk_mask(self) -> int:
        """The C reference's parity quirk in low-K-bit register space: its
        parity routine returns 0 whenever the XOR of 64-bit register bits
        {4, 12, ..., 60} of (register & polynomial) is 1."""
        if self.parity != "compat":
            return 0
        K = self.constraint_length
        return sum(1 << (j - 64 + K) for j in range(4, 61, 8) if 0 <= j - 64 + K < K)


# --------------------------------------------------------------------------
# 32-bit arithmetic and the two counter hashes
# --------------------------------------------------------------------------

def mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``(x * c) mod 2^32`` for int64 x in [0, 2^32), without overflow."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def popcount32(x: torch.Tensor) -> torch.Tensor:
    x = x.to(torch.int64) & MASK32
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & MASK32) >> 24


def parity32(x: torch.Tensor) -> torch.Tensor:
    x = x.to(torch.int64) & MASK32
    for s in (16, 8, 4, 2, 1):
        x = x ^ (x >> s)
    return x & 1


def lowbias32(x: torch.Tensor) -> torch.Tensor:
    x = x ^ (x >> 16)
    x = mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def fmix32(x: torch.Tensor) -> torch.Tensor:
    x = x ^ (x >> 16)
    x = mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def to_uniform(bits: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """31 hash bits to (0, 1): ``(bits >> 1) * 2^-31 + 2^-32`` in float32,
    then in ``dtype``."""
    u = (bits >> 1).to(torch.float32) * torch.tensor(2.0 ** -31) + torch.tensor(2.0 ** -32)
    return u.to(dtype)


def tile_bits(idx: torch.Tensor, base: torch.Tensor, salt: int) -> torch.Tensor:
    """The fused chain's stream: hash of a flat in-tile index and the
    step's base."""
    x = (mul32(idx, 0x9E3779B9) + base) & MASK32
    return lowbias32(lowbias32(x) ^ ((salt * 0x85EBCA6B) & MASK32))


def tile_base(seed: int, tile: torch.Tensor) -> torch.Tensor:
    """The fused chain's per-tile base: lowbias32(seed * phi ^ (tile + 1) * c)."""
    s = mul32(torch.full_like(tile, seed & MASK32), 0x9E3779B9)
    return lowbias32(s ^ mul32(tile + 1, 0xC2B2AE35))


def coord_bits(frame: torch.Tensor, pos: torch.Tensor, seed: int, salt: int) -> torch.Tensor:
    """The sequential walks' stream: hash of (seed, frame id, position, salt)."""
    frame = frame.to(torch.int64) & MASK32
    c = mul32(pos.to(torch.int64) & MASK32, 0x9E3779B9) ^ mul32(frame, 0x7FEB352D)
    c = (c + ((int(seed) + salt * 0x68E31DA4) & MASK32)) & MASK32
    return fmix32(fmix32(c) ^ frame)


# --------------------------------------------------------------------------
# encoder and trellis
# --------------------------------------------------------------------------

def register_symbols(code: CodeSpec, reg: torch.Tensor) -> torch.Tensor:
    """Expected symbol of low-K-bit registers (newest bit at bit K-1);
    polynomial 0 at the symbol's most significant bit."""
    sym = torch.zeros_like(reg)
    qmask = code.quirk_mask
    for p in code.polynomials:
        x = reg & p
        bit = parity32(x)
        if qmask:
            bit = bit & (1 - parity32(x & qmask))
        sym = (sym << 1) | bit
    return sym


def encode(code: CodeSpec, bits: torch.Tensor) -> torch.Tensor:
    """``[N, L]`` info bits to ``[N, T]`` int64 symbols, with the K - 1 zero tail."""
    K, L = code.constraint_length, bits.shape[-1]
    T = L + K - 1
    padded = torch.nn.functional.pad(bits.to(torch.int64), (K - 1, K - 1))
    reg = torch.zeros(bits.shape[:-1] + (T,), dtype=torch.int64, device=bits.device)
    for age in range(K):
        reg = reg | (padded[..., K - 1 - age: K - 1 - age + T] << (K - 1 - age))
    return register_symbols(code, reg)


def butterfly(code: CodeSpec, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(prev_state [S, 2], esym_prev [S, 2]): new state ``ns`` has the
    predecessors ``2j`` and ``2j + 1`` (``j = ns mod S/2``), entered with
    input ``ns >> (K - 2)``, and ``esym_prev`` is that transition's symbol."""
    K, S = code.constraint_length, code.num_states
    ns = torch.arange(S, dtype=torch.int64, device=device)
    j = ns & ((S >> 1) - 1)
    prev = torch.stack([2 * j, 2 * j + 1], dim=1)
    inp = (ns >> (K - 2))[:, None]
    return prev, register_symbols(code, prev | (inp << (K - 1)))


# --------------------------------------------------------------------------
# channel and demapper
# --------------------------------------------------------------------------

def constellation(cfg: dict, device) -> Tuple[torch.Tensor, float]:
    """The configuration's points [M, 2] float32 and the demapper's
    ``1 / ndist``, ndist the squared distance of points 0 and 1 as float32."""
    pts = np.asarray(cfg["constellation"], dtype=np.float32)
    d = pts[0] - pts[1]
    nd = float(np.float32(d[0] * d[0]) + np.float32(d[1] * d[1]))
    return torch.as_tensor(pts, device=device), float(1.0 / nd)


def awgn_sigma(ebn0_db: float) -> float:
    """Noise std dev a component at Eb/N0 (one info bit a channel symbol):
    ``1/sqrt(2) * 10^(-EbN0/20)``, the power in float64, rounded to float32
    once, then the float32 product."""
    exponent = np.float32(-np.float32(ebn0_db) / np.float32(20.0))
    scale = np.float32(10.0 ** np.float64(exponent))
    return float(np.float32(np.float32(1.0 / math.sqrt(2.0)) * scale))


def channel_param(cfg: dict, point: float) -> float:
    return awgn_sigma(point) if cfg["channel"] == "awgn" else float(point)


def distances(points: torch.Tensor, inv_nd: float, rxi: torch.Tensor,
              rxq: torch.Tensor) -> torch.Tensor:
    """[..] received (I, Q) to [M, ..] ``((di*di)+(dq*dq))*inv_nd``, in the
    received values' dtype."""
    dt = rxi.dtype
    inv = torch.tensor(inv_nd, dtype=torch.float32).to(dt)
    out = []
    for px, py in points.tolist():
        di = rxi - torch.tensor(px, dtype=torch.float32).to(dt)
        dq = rxq - torch.tensor(py, dtype=torch.float32).to(dt)
        out.append(((di * di) + (dq * dq)) * inv)
    return torch.stack(out)


def snap(points: torch.Tensor, dists: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Nearest point by a strict-less scan (the first wins): its (I, Q)."""
    pts = points.to(dists.dtype)
    best, sxi, sxq = dists[0], pts[0, 0].expand_as(dists[0]), pts[0, 1].expand_as(dists[0])
    for e in range(1, dists.shape[0]):
        better = dists[e] < best
        best = torch.where(better, dists[e], best)
        sxi = torch.where(better, pts[e, 0], sxi)
        sxq = torch.where(better, pts[e, 1], sxq)
    return sxi, sxq


def box_muller(u0: torch.Tensor, u1: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(r cos theta, r sin theta) with r = sqrt(-2 log u0), theta = 2 pi u1."""
    r = torch.sqrt(-2.0 * torch.log(u0))
    theta = torch.tensor(TWO_PI, dtype=torch.float32).to(u1.dtype) * u1
    return r * torch.cos(theta), r * torch.sin(theta)


def seq_frames(code: CodeSpec, cfg: dict, gid: torch.Tensor, seed: int, param: float,
               dtype=torch.float32) -> Tuple[torch.Tensor, torch.Tensor]:
    """The frames of global ids ``gid`` [N] as the sequential walks make
    them: (info bits [N, L] int64, channel output).  The output is [N, T, M]
    demapper distances on AWGN and [N, T] received symbols on the BSC.
    Info bits from salt 0, AWGN from salts 1 and 2, BSC flips of coded bit
    k from salt 1 + k."""
    T, L = code.num_block_symbols, code.block_length
    seed = int(seed) & 0x7FFFFFFF
    g = gid.to(torch.int64)[:, None]
    row = torch.arange(T, dtype=torch.int64, device=gid.device)[None, :]
    bits = coord_bits(g, row[:, :L], seed, 0) & 1
    esym = encode(code, bits)
    param_t = torch.tensor(float(param), dtype=torch.float32).to(dtype)
    if cfg["channel"] == "awgn":
        points, inv_nd = constellation(cfg, gid.device)
        u0 = to_uniform(coord_bits(g, row, seed, 1), dtype)
        u1 = to_uniform(coord_bits(g, row, seed, 2), dtype)
        nc, ns = box_muller(u0, u1)
        pts = points.to(dtype)
        rxi = pts[esym, 0] + param_t * nc
        rxq = pts[esym, 1] + param_t * ns
        d = distances(points, inv_nd, rxi, rxq)
        if cfg["demapper"] == "hard":
            d = distances(points, inv_nd, *snap(points, d))
        return bits, d.permute(1, 2, 0).contiguous()
    fmask = torch.zeros_like(esym)
    for k in range(code.symlen_out):
        flip = to_uniform(coord_bits(g, row, seed, 1 + k), dtype) < param_t
        fmask = fmask | (flip.to(torch.int64) << k)
    return bits, esym ^ fmask


def transition_metrics(code: CodeSpec, cfg: dict, rx: torch.Tensor, weight: float,
                       hard_metrics, dtype=torch.float32) -> torch.Tensor:
    """Branch metric of every expected symbol at every position, [N, T, M]:
    soft ``1 + w * dist`` (the product rounded before the add), hard
    ``hamming * wrong + (symlen - hamming) * correct``."""
    M = code.points_per_symbol
    e = torch.arange(M, dtype=torch.int64, device=rx.device)
    if cfg["channel"] == "awgn":
        w = torch.tensor(float(weight), dtype=torch.float32).to(dtype)
        return 1.0 + w * rx.to(dtype)
    h = popcount32(rx[..., None] ^ e)
    correct, wrong = int(hard_metrics[0]), int(hard_metrics[1])
    return (h * wrong + (code.symlen_out - h) * correct).to(torch.float32).to(dtype)


# --------------------------------------------------------------------------
# how run_sweep addresses a point (a one-point SweepSpec on one device)
# --------------------------------------------------------------------------

#: the sequential leg's second launch runs with the point seed xored with this
WARM_SEED_XOR = 0x2A5A5A5A


def chunk_seed(seed: int, chunk: int) -> int:
    """The seed of chunk ``chunk`` of the only point of a sweep seeded ``seed``."""
    return (int(seed) * 1000003 + chunk) & 0x7FFFFFFF


@dataclasses.dataclass(frozen=True)
class Launch:
    """One kernel launch of a point: its seed, lanes and frames per lane
    (``steps``: whole frames a lane runs in the launch)."""

    seed: int
    lanes: int
    steps: int


def fused_launches(code: CodeSpec, frames_per_step: int, bits_per_point: int,
                   seed: int) -> List[Launch]:
    """The fused chain's launches of a point: lanes rounded up to 1024,
    steps of every lane's frames until the bits are reached, in chunks of
    at most 2^30 bits (and a point that fits one chunk runs an eighth
    first)."""
    lanes = max(1024, -(-frames_per_step // 1024) * 1024)
    nsteps = max(1, -(-int(bits_per_point) // (lanes * code.block_length)))
    chunk = max(1, (1 << 30) // (lanes * code.block_length))
    out, left, ci = [], nsteps, 0
    while left > 0:
        n = min(chunk, left)
        if ci == 0 and n == nsteps and n > 1:
            n = max(1, n // 8)
        out.append(Launch(chunk_seed(seed, ci), lanes, n))
        left -= n
        ci += 1
    return out


def seq_launches(code: CodeSpec, bits_per_point: int, seed: int) -> List[Launch]:
    """The sequential walks' launches of a point: 8192 lanes (1024 below
    8192 frames' worth of bits), one frame a lane with the point seed, then
    the rest of the frames a lane with the seed xored by WARM_SEED_XOR."""
    L = code.block_length
    lanes = 8192 if bits_per_point >= 8192 * L else 1024
    fpl = max(1, -(-int(bits_per_point) // (lanes * L)))
    s = chunk_seed(seed, 0)
    out = [Launch(s, lanes, 1)]
    if fpl > 1:
        out.append(Launch(s ^ WARM_SEED_XOR, lanes, fpl - 1))
    return out


def launch_bits(code: CodeSpec, launches: Sequence[Launch]) -> int:
    return sum(la.lanes * la.steps * code.block_length for la in launches)


def lane_frames(launch: Launch, lanes: torch.Tensor) -> Iterator[torch.Tensor]:
    """Global frame ids of ``lanes`` in a sequential launch: frame ``k`` of
    lane ``g`` is ``g * steps + k``; [len(lanes), steps]."""
    k = torch.arange(launch.steps, dtype=torch.int64, device=lanes.device)
    return lanes.to(torch.int64)[:, None] * launch.steps + k[None, :]
