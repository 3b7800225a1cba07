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
The plain channel stage, :func:`awgn_distances` and :func:`bsc_flip_mask`,
is also the plain versions' of kernels 6, 7 and 8 (``fused_longframe``,
``mc_datagen``), each keyed by its own hash.

``variant="fast_demap"`` (the JAX package's opt-in variant, fused_chain.py
:140-249) replaces the squared-distance vector by its linear form
(:func:`_dist_vec_lin`), in the kernel (its instances built apart, in
``csrc/fused_chain_lin.cu``) and the plain version alike: a
statistical-contract variant, its BER equal to the exact demapper's up to
float rounding.  The JAX package's other tokens (``bf16_acs`` and the
measurement ablations) are not ported.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Tuple

import numpy as np
import torch

from convolutional_codes_tpu_torch.models.codebook import Code
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
#: variant tokens of the JAX package's kernel that the port does not take,
#: and why (ROADMAP, "Do not port")
UNPORTED_VARIANTS = {
    "bf16_acs": "it documents a lever the TPU closed; the card's ACS stays float32",
    "cheap_bm": "a measurement-only ablation (its statistics are invalid)",
    "static_noise": "a measurement-only ablation (its statistics are invalid)",
    "cheap_enc": "a measurement-only ablation (its statistics are invalid)",
    "no_tb": "a measurement-only ablation (its statistics are invalid)",
}

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


def flip_threshold(param: float) -> int:
    """The least 31-bit integer b whose uniform ``b * 2^-31 + 2^-32``
    (float32, as :func:`_interp_uniform` and ``fused_longframe.coord_uniform``)
    is not below ``param``: a BSC coded bit flips exactly where its draw's
    ``bits >> 1`` is below it, as the uniform is non-decreasing in b.  2^31
    where every draw flips."""
    p = np.float32(param)
    lo, hi = 0, 1 << 31
    while lo < hi:   # the least b with u(b) >= p, by bisection
        mid = (lo + hi) // 2
        u = np.float32(mid) * np.float32(2.0 ** -31) + np.float32(2.0 ** -32)
        if u >= p:
            hi = mid
        else:
            lo = mid + 1
    return lo


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


@functools.lru_cache(maxsize=None)
def _lin_terms(points: Tuple[Tuple[float, float], ...], inv_nd: float):
    """The linear form's constants, as the JAX package's ``dist_vec_lin``
    (fused_chain.py:207-246) derives them: per unique nonzero |I| and |Q|
    coordinate the float32 factor ``-2 inv_nd |a|``, per point the float32
    ``|p_e|^2 inv_nd`` (numpy float32 arithmetic, as there), and whether
    the constellation is constant-modulus (then that term is dropped)."""
    pts = np.asarray(points, dtype=np.float32)
    fac_i = {a: np.float32(-2.0 * inv_nd * a) for a in {abs(float(x)) for x in pts[:, 0]} if a}
    fac_q = {a: np.float32(-2.0 * inv_nd * a) for a in {abs(float(y)) for y in pts[:, 1]} if a}
    pe2 = [float((pts[e, 0] ** 2 + pts[e, 1] ** 2) * inv_nd) for e in range(len(pts))]
    const_mod = len({round(x, 12) for x in pe2}) == 1
    return fac_i, fac_q, pe2, const_mod


def _dist_vec_lin(tables, rxi: torch.Tensor, rxq: torch.Tensor) -> torch.Tensor:
    """[..] received (I, Q) → [M, ..] linear-form distances (``fast_demap``):
    ``(|p_e|^2 - 2 <rx, p_e>) inv_nd`` with the terms common to every e at
    a position dropped (``|rx|^2``, and ``|p_e|^2`` where the constellation
    is constant-modulus), so the ACS compares are unchanged in exact
    arithmetic.  The JAX package's expression order: one product per
    unique |coordinate|, then signed sums, hand-CSE'd across points."""
    fac_i, fac_q, pe2, const_mod = _lin_terms(
        tuple(map(tuple, tables.points_np.tolist())), tables.inv_nd)
    pre_i = {a: rxi * torch.tensor(f) for a, f in fac_i.items()}
    pre_q = {a: rxq * torch.tensor(f) for a, f in fac_q.items()}
    memo = {}

    def lin(pi, pq):
        if (pi, pq) in memo:
            return memo[(pi, pq)]
        if (-pi, -pq) in memo:
            v = -memo[(-pi, -pq)]
        elif pi == 0.0:
            v = pre_q[abs(pq)] if pq > 0 else -pre_q[abs(pq)]
        elif pq == 0.0:
            v = pre_i[abs(pi)] if pi > 0 else -pre_i[abs(pi)]
        else:
            ti, tq = pre_i[abs(pi)], pre_q[abs(pq)]
            if pi > 0:
                v = ti + tq if pq > 0 else ti - tq
            else:
                v = tq - ti if pq > 0 else -(ti + tq)
        memo[(pi, pq)] = v
        return v

    out = []
    for e, (px, py) in enumerate(tables.points_np.tolist()):
        v = lin(px, py)
        out.append(v if const_mod else v + torch.tensor(pe2[e], dtype=torch.float32))
    return torch.stack(out)


def lin_params(tables) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The kernel's form of :func:`_dist_vec_lin`, float32 [M] each: point
    e's distance is ``(rxi * ci[e] + rxq * cq[e]) + pe2[e]``, with ``ci[e]
    = sign(I_e) fac(|I_e|)`` (0 where I_e = 0), likewise ``cq``, and
    ``pe2`` zero where the constellation is constant-modulus.  Each value
    equals :func:`_dist_vec_lin`'s: negation is exact, so ``rxi * -f =
    -(rxi * f)``, and the signed sums there are these sums reordered; a
    zero term changes at most the sign of a zero, which no compare sees."""
    fac_i, fac_q, pe2, const_mod = _lin_terms(
        tuple(map(tuple, tables.points_np.tolist())), tables.inv_nd)
    pts = tables.points_np
    ci = np.array([np.sign(x) * fac_i.get(abs(float(x)), 0.0) for x in pts[:, 0]], np.float32)
    cq = np.array([np.sign(y) * fac_q.get(abs(float(y)), 0.0) for y in pts[:, 1]], np.float32)
    return ci, cq, np.zeros(len(pts), np.float32) if const_mod else np.float32(pe2)


def parse_variant(variant: str) -> bool:
    """Whether ``variant`` (comma-separated tokens) asks for the linear
    demapper; any token other than ``fast_demap`` raises."""
    tokens = {t for t in variant.split(",") if t}
    for t in sorted(tokens - {"fast_demap"}):
        why = UNPORTED_VARIANTS.get(t, "the JAX package has no such token")
        raise ValueError(f"variant token {t!r} is not supported by the port: {why}")
    return "fast_demap" in tokens


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


def awgn_distances(tables, syms: torch.Tensor, u0: torch.Tensor, u1: torch.Tensor, sigma,
                   demapper: str, dist_vec=_dist_vec) -> torch.Tensor:
    """The plain AWGN stage of kernels 3, 6, 7 and 8: sent symbols ``syms``
    (int64 indices) plus Box-Muller noise from the float32 uniforms ``u0``
    and ``u1`` scaled by ``sigma``, demapped to ``[M, ...]`` distances by
    ``dist_vec`` (:func:`_dist_vec`, or :func:`_dist_vec_lin` for
    ``fast_demap``), of the received point (``"soft"``) or of its nearest
    point (``"hard"``).  The kernels' float32 expression order:
    ``sqrt(-2 log u0)``, ``float32(2 pi) * u1``, ``point + sigma * (r *
    cos)``."""
    sigma = torch.tensor(float(sigma), dtype=torch.float32)
    r = torch.sqrt(-2.0 * torch.log(u0))
    theta = torch.tensor(_TWO_PI, dtype=torch.float32) * u1
    rxi = tables.points[syms, 0] + sigma * (r * torch.cos(theta))
    rxq = tables.points[syms, 1] + sigma * (r * torch.sin(theta))
    dists = dist_vec(tables, rxi, rxq)
    if demapper == "hard":
        dists = dist_vec(tables, *_snap(tables, dists))
    return dists


def bsc_flip_mask(syms: torch.Tensor, width: int, uniform, crossover) -> torch.Tensor:
    """The plain BSC stage of kernels 3, 6, 7 and 8: the flip mask of
    ``width``-bit sent symbols, bit ``k`` set where ``uniform(k)``, coded
    bit k's float32 draw, is below the float32 crossover."""
    crossover = torch.tensor(float(crossover), dtype=torch.float32)
    fmask = torch.zeros_like(syms)
    for k in range(width):
        fmask = fmask | ((uniform(k) < crossover).to(torch.int64) << k)
    return fmask


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
                         demapper: str = "soft", device="cpu", variant: str = ""
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`mc_chain_viterbi`: the same per-element
    expressions and draws as the kernel, as whole-tensor ops over every
    lane at once (stages in bulk, then the plain ACS scan and traceback)."""
    Bt = min(block_lanes, batch)
    _check_args(code, batch, Bt, channel, demapper)
    dist_vec = _dist_vec_lin if parse_variant(variant) else _dist_vec
    device = torch.device(device)
    tables = code_tables(code, device)
    T, L, S = code.num_block_symbols, code.block_length, code.num_states
    M, symlen = code.points_per_symbol, code.symlen_out
    hard = channel == "bsc"
    lane = torch.arange(batch, dtype=torch.int64, device=device)
    hbase = _hbase(int(seed), lane // Bt)
    t_idx = torch.arange(T, dtype=torch.int64, device=device)[:, None]
    plane = t_idx * Bt + (lane % Bt)[None, :]                # [T, B] flat index
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
            rx = syms ^ bsc_flip_mask(
                syms, symlen, lambda k: _interp_uniform(k * T * Bt + plane, sbase, 1), param)
            dists = popcount32(rx[:, None, :] ^ e_idx).to(torch.float32)
        else:
            u0 = _interp_uniform(plane, sbase, 2)
            u1 = _interp_uniform(T * Bt + plane, sbase, 2)
            dists = awgn_distances(tables, syms, u0, u1, param, demapper, dist_vec)  # [M, T, B]
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
    lib.cc_mc_chain.argtypes = [P, I, I, I, U, F, U, I, I, I, I, I, I, P, P, P, U, F, P]
    lib.cc_mc_chain.restype = I
    lib.cc_sincos_check.argtypes = [P, U, U, P]
    lib.cc_sincos_check.restype = I
    return lib


@functools.lru_cache(maxsize=None)
def _lib_lin():
    """``fast_demap``'s instances, a library of their own
    (``csrc/fused_chain_lin.cu``) that builds beside the exact one."""
    lib = load_library("fused_chain_lin")
    P, I, U, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float
    lib.cc_mc_chain_lin.argtypes = [P, I, I, I, U, F, I, I, I, I, I, P, P, P, U, F, P, P, P, P]
    lib.cc_mc_chain_lin.restype = I
    return lib


def mc_chain_viterbi(code: Code, batch: int, nsteps: int, seed, param,
                     channel: str = "awgn", block_lanes: int = 1024,
                     demapper: str = "soft", device="cuda", variant: str = ""
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run ``nsteps`` whole Monte-Carlo steps of the Viterbi chain per lane.

    ``channel``: "awgn" (param = sigma, soft decode; ``demapper`` "soft" or
    "hard" snap-then-distance) or "bsc" (param = crossover probability,
    hard decode with 0xFF00-saturating metrics).  ``block_lanes`` is the
    logical tile of the hash RNG (the reference's Pallas block).  Returns
    per-lane (bit_errors [B], frame_errors [B]) int32 counters; the run
    simulates batch * nsteps * block_length info bits.  ``variant``:
    "" (the exact demapper) or "fast_demap" (the linear form, AWGN only;
    no effect on the BSC); any other token raises ``ValueError``.
    """
    device = torch.device(device)
    if device.type == "cpu":
        return mc_chain_viterbi_ref(code, batch, nsteps, seed, param, channel,
                                    block_lanes, demapper, device, variant)
    if device.type != "cuda":
        raise ValueError(f"mc_chain_viterbi runs on CPU or CUDA, got {device}")
    Bt = min(block_lanes, batch)
    _check_args(code, batch, Bt, channel, demapper)
    lin = parse_variant(variant)
    tables = code_tables(code, device)
    polys = np.asarray(tables.polynomials, dtype=np.uint32)
    out = torch.empty((2, batch), dtype=torch.int32, device=device)
    head = (out.data_ptr(), batch, Bt, int(nsteps), int(seed) & MASK32, float(param))
    code_args = (code.constraint_length, code.block_length, code.num_block_symbols,
                 code.symlen_out, tables.esym_prev_np.ctypes.data,
                 tables.points_np.ctypes.data, polys.ctypes.data, tables.quirk_mask,
                 tables.inv_nd)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        if lin and channel == "awgn":
            ci, cq, pe2 = lin_params(tables)
            status = _lib_lin().cc_mc_chain_lin(
                *head, int(demapper == "hard"), *code_args, ci.ctypes.data, cq.ctypes.data,
                pe2.ctypes.data, stream)
        else:
            status = _lib().cc_mc_chain(
                *head, flip_threshold(param) if channel == "bsc" else 0,
                int(channel == "bsc"), int(demapper == "hard"), *code_args, stream)
    check_status(status, "mc_chain_viterbi")
    mc_chain_viterbi.launches += 1
    return out[0], out[1]


mc_chain_viterbi.launches = 0


def sincos_mismatches(n: int, seed: int, device="cuda") -> Tuple[int, int]:
    """The kernel's ``sincosf`` against the pair ``sinf``, ``cosf`` on the
    card: the angles 2π u of the chain's Box-Muller for the uniforms u of
    flat indices 0 .. n-1 (salt 2, the hash base of ``seed``'s tile 0 and
    step 0).  Returns how many sines and how many cosines differ in any bit
    (both 0 where the kernel draws the bits of the pair)."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"sincos_mismatches runs on the card, got {device}")
    sbase = int(_hbase(int(seed), torch.zeros(1, dtype=torch.int64))[0])
    counts = torch.zeros(2, dtype=torch.int64, device=device)
    with torch.cuda.device(device):
        status = _lib().cc_sincos_check(counts.data_ptr(), int(n), sbase,
                                        torch.cuda.current_stream().cuda_stream)
    check_status(status, "sincos_mismatches")
    s, c = counts.tolist()
    return s, c


def mc_awgn_viterbi(code: Code, batch: int, nsteps: int, seed, sigma,
                    block_lanes: int = 1024, device="cuda"):
    """:func:`mc_chain_viterbi` on the AWGN channel (soft decode)."""
    return mc_chain_viterbi(code, batch, nsteps, seed, sigma, "awgn", block_lanes,
                            device=device)


def mc_bsc_viterbi(code: Code, batch: int, nsteps: int, seed, crossover,
                   block_lanes: int = 1024, device="cuda"):
    """:func:`mc_chain_viterbi` on the BSC (hard decode)."""
    return mc_chain_viterbi(code, batch, nsteps, seed, crossover, "bsc", block_lanes,
                            device=device)
