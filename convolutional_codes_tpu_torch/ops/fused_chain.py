"""Fused Monte-Carlo Viterbi chain: the CUDA kernel and its plain version.

One kernel launch (``csrc/fused_chain.cu``) runs ``nsteps`` whole
Monte-Carlo steps per lane — info bits, encoder, channel, demapper, ACS,
traceback and error counting — and writes only per-lane counters.  It
replaces the TPU kernel ``_mc_kernel`` (fused_chain.py:400) behind
``mc_chain_viterbi`` (:641), loop schedule only.

The random numbers are the reference's interpret-mode counter hash
(``_interp_bits``/``_interp_uniform`` with the ``_hbase_for``/
``_step_base`` seeding), keyed by logical tile ``lane // Bt`` and in-tile
index, with ``Bt = block_lanes`` as in the reference.  So for a given
(seed, batch, Bt) the CUDA kernel, the plain version below and the
reference package's ``interpret=True`` kernel draw the same bits: BSC
counters agree exactly; AWGN counters agree up to the last-ulp differences
of log/sqrt/sin/cos between the three math libraries.

``mc_chain_viterbi`` takes a ``device``: CPU runs the plain version, CUDA
launches the kernel (counted in ``mc_chain_viterbi.launches``) or raises.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Tuple

import numpy as np
import torch

from convolutional_codes_tpu.models.codebook import Code
from convolutional_codes_tpu_torch.models.tables import code_tables
from convolutional_codes_tpu_torch.ops.encoder import encode_tb
from convolutional_codes_tpu_torch.ops.viterbi import (
    BIG_METRIC, HARD_METRIC_SAT, acs_scan, traceback_from)
from convolutional_codes_tpu_torch.utils.bitops import (
    MASK32, first_argmin, mul32, popcount32)
from convolutional_codes_tpu_torch.utils.build import check_status, load_library

#: Kernel limits: per-thread metric arrays for S <= 256 (K <= 9) and
#: branch-metric arrays for M <= 8 (as the reference's fused kernel), and
#: a per-thread decision array of MAX_SYMBOLS trellis steps.
MAX_STATES = 256
MAX_POINTS = 8
MAX_SYMBOLS = 256

CHANNELS = ("awgn", "bsc")
DEMAPPERS = ("soft", "hard")

_TWO_PI = 2.0 * math.pi


def _lowbias32(x: torch.Tensor) -> torch.Tensor:
    """32-bit avalanche hash (lowbias32) on int64 values in [0, 2^32)."""
    x = x ^ (x >> 16)
    x = mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def _interp_bits(idx: torch.Tensor, base: torch.Tensor, salt: int) -> torch.Tensor:
    """Counter-hash 32-bit stream at flat indices ``idx`` (the reference's
    ``_interp_bits`` with the iota made explicit), int64 in [0, 2^32)."""
    x = (mul32(idx, 0x9E3779B9) + base) & MASK32
    return _lowbias32(_lowbias32(x) ^ ((salt * 0x85EBCA6B) & MASK32))


def _interp_uniform(idx: torch.Tensor, base: torch.Tensor, salt: int) -> torch.Tensor:
    """31 hash bits → float32 in (0, 1): ``(bits >> 1) * 2^-31 + 2^-32``."""
    bits = (_interp_bits(idx, base, salt) >> 1).to(torch.float32)
    return bits * torch.tensor(2.0 ** -31) + torch.tensor(2.0 ** -32)


def _hbase(seed: int, tile: torch.Tensor) -> torch.Tensor:
    """Per-tile hash base (``_hbase_for``): lowbias32(seed*φ ^ (tile+1)*c)."""
    s = mul32(torch.full_like(tile, seed & MASK32), 0x9E3779B9)
    return _lowbias32(s ^ mul32(tile + 1, 0xC2B2AE35))


def _dist_vec(tables, rxi: torch.Tensor, rxq: torch.Tensor) -> torch.Tensor:
    """[..] received (I, Q) → [M, ..] ``((di*di)+(dq*dq))*inv_nd``."""
    inv_nd = torch.tensor(tables.inv_nd, dtype=torch.float32)
    out = []
    for px, py in tables.points_np.tolist():
        di = rxi - torch.tensor(px, dtype=torch.float32)
        dq = rxq - torch.tensor(py, dtype=torch.float32)
        out.append(((di * di) + (dq * dq)) * inv_nd)
    return torch.stack(out)


def _snap(tables, dists: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Nearest point by strict-less scan (first wins) → its (I, Q)."""
    pts = tables.points
    best = dists[0]
    sxi = pts[0, 0].expand_as(best)
    sxq = pts[0, 1].expand_as(best)
    for e in range(1, dists.shape[0]):
        better = dists[e] < best
        best = torch.where(better, dists[e], best)
        sxi = torch.where(better, pts[e, 0], sxi)
        sxq = torch.where(better, pts[e, 1], sxq)
    return sxi, sxq


def _check_args(code: Code, batch: int, Bt: int, channel: str, demapper: str) -> None:
    if channel not in CHANNELS:
        raise ValueError(f"channel must be one of {CHANNELS}, got {channel!r}")
    if demapper not in DEMAPPERS:
        raise ValueError(f"demapper must be one of {DEMAPPERS}, got {demapper!r}")
    if batch % Bt:
        raise ValueError(f"batch {batch} not divisible by tile {Bt}")
    if (code.num_states > MAX_STATES or code.points_per_symbol > MAX_POINTS
            or code.num_block_symbols > MAX_SYMBOLS):
        raise NotImplementedError(
            f"fused MC chain supports S <= {MAX_STATES}, M <= {MAX_POINTS} and "
            f"T <= {MAX_SYMBOLS}; {code.name} has S={code.num_states}, "
            f"M={code.points_per_symbol}, T={code.num_block_symbols}")


def mc_chain_viterbi_ref(code: Code, batch: int, nsteps: int, seed, param,
                         channel: str = "awgn", block_lanes: int = 1024,
                         demapper: str = "soft", device="cpu"
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`mc_chain_viterbi`: the same per-element
    expressions and draws as the kernel, as whole-tensor ops over every
    lane at once (stages in bulk, then the plain ACS scan and traceback)."""
    Bt = min(block_lanes, batch)
    _check_args(code, batch, Bt, channel, demapper)
    device = torch.device(device)
    tables = code_tables(code, device)
    T, L, S = code.num_block_symbols, code.block_length, code.num_states
    M, symlen = code.points_per_symbol, code.symlen_out
    hard = channel == "bsc"
    lane = torch.arange(batch, dtype=torch.int64, device=device)
    hbase = _hbase(int(seed), lane // Bt)
    t_idx = torch.arange(T, dtype=torch.int64, device=device)[:, None]
    plane = t_idx * Bt + (lane % Bt)[None, :]                # [T, B] flat index
    param_f = torch.tensor(float(param), dtype=torch.float32)
    e_idx = torch.arange(M, dtype=torch.int64, device=device)[None, :, None]
    init = torch.full((S, batch), float(HARD_METRIC_SAT) if hard else BIG_METRIC,
                      dtype=torch.float32, device=device)
    init[0] = 0.0
    errs = torch.zeros(batch, dtype=torch.int32, device=device)
    ferrs = torch.zeros(batch, dtype=torch.int32, device=device)
    for step in range(nsteps):
        sbase = (hbase + ((step * 0x85EBCA6B) & MASK32)) & MASK32
        bits = torch.where(t_idx < L, _interp_bits(plane, sbase, 0) & 1, 0)
        syms = encode_tb(code, bits[:L]).to(torch.int64)     # [T, B]
        if hard:
            fmask = torch.zeros_like(syms)
            for k in range(symlen):
                u = _interp_uniform(k * T * Bt + plane, sbase, 1)
                fmask = fmask | ((u < param_f).to(torch.int64) << k)
            rx = syms ^ fmask
            dists = popcount32(rx[:, None, :] ^ e_idx).to(torch.float32)
        else:
            u0 = _interp_uniform(plane, sbase, 2)
            u1 = _interp_uniform(T * Bt + plane, sbase, 2)
            r = torch.sqrt(-2.0 * torch.log(u0))
            theta = torch.tensor(_TWO_PI, dtype=torch.float32) * u1
            rxi = tables.points[syms, 0] + param_f * (r * torch.cos(theta))
            rxq = tables.points[syms, 1] + param_f * (r * torch.sin(theta))
            dists = _dist_vec(tables, rxi, rxq)              # [M, T, B]
            if demapper == "hard":
                dists = _dist_vec(tables, *_snap(tables, dists))
            dists = dists.permute(1, 0, 2)                   # [T, M, B]
        fm, dec = acs_scan(code, dists.contiguous(), init, hard)
        decoded = traceback_from(code, dec, first_argmin(fm, dim=0))  # [B, T]
        mism = decoded[:, :L] != bits[:L].T
        errs += mism.sum(1, dtype=torch.int32)
        ferrs += mism.any(1).to(torch.int32)
    return errs, ferrs


@functools.lru_cache(maxsize=None)
def _lib():
    lib = load_library("fused_chain")
    P, I, U, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float
    lib.cc_mc_chain.argtypes = [P, I, I, I, U, F, I, I, I, I, I, I, P, P, P, U, F, P]
    lib.cc_mc_chain.restype = I
    return lib


def mc_chain_viterbi(code: Code, batch: int, nsteps: int, seed, param,
                     channel: str = "awgn", block_lanes: int = 1024,
                     demapper: str = "soft", device="cuda"
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run ``nsteps`` whole Monte-Carlo steps of the Viterbi chain per lane.

    ``channel``: "awgn" (param = sigma, soft decode; ``demapper`` "soft" or
    "hard" snap-then-distance) or "bsc" (param = crossover probability,
    hard decode with 0xFF00-saturating metrics).  ``block_lanes`` is the
    logical tile of the hash RNG (the reference's Pallas block).  Returns
    per-lane (bit_errors [B], frame_errors [B]) int32 counters; the run
    simulates batch * nsteps * block_length info bits.
    """
    device = torch.device(device)
    if device.type == "cpu":
        return mc_chain_viterbi_ref(code, batch, nsteps, seed, param, channel,
                                    block_lanes, demapper, device)
    if device.type != "cuda":
        raise ValueError(f"mc_chain_viterbi runs on CPU or CUDA, got {device}")
    Bt = min(block_lanes, batch)
    _check_args(code, batch, Bt, channel, demapper)
    tables = code_tables(code, device)
    polys = np.asarray(tables.polynomials, dtype=np.uint32)
    out = torch.empty((2, batch), dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        status = _lib().cc_mc_chain(
            out.data_ptr(), batch, Bt, int(nsteps), int(seed) & MASK32, float(param),
            int(channel == "bsc"), int(demapper == "hard"), code.constraint_length,
            code.block_length, code.num_block_symbols, code.symlen_out,
            tables.esym_prev_np.ctypes.data, tables.points_np.ctypes.data,
            polys.ctypes.data, tables.quirk_mask, tables.inv_nd,
            torch.cuda.current_stream().cuda_stream)
    check_status(status, "mc_chain_viterbi")
    mc_chain_viterbi.launches += 1
    return out[0], out[1]


mc_chain_viterbi.launches = 0
