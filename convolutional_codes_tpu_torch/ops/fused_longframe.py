"""Fused long-frame Monte-Carlo Viterbi chain (BASELINE configs 0 and 2):
the CUDA kernel, its plain version, and the coordinate hash they share.

Every lane simulates its own unterminated coded stream and decodes it in
overlap-save windows: ``window`` payload symbols with ``warmup``-symbol
halos on both sides, from uniform (zero) start metrics; the left halo warms
the metrics up, the right halo lets the traceback re-converge onto the
survivor path, and only payload bits are error-counted.  Window ``win0 +
step`` of a lane covers stream positions ``(win0 + step) * window - warmup``
on; the K-1 info bits before them seed the encoder register.

All randomness is a pure counter hash of (seed, global lane, stream
position, salt): two rounds of the murmur3 32-bit finalizer over a
Weyl-mixed counter — the JAX package's ``coord_bits``/``coord_uniform``
(fused_longframe.py:56-81), bit for bit — so a position draws the same
bits and noise in every window that covers it, and a run split by window
ranges (``win0``) sums to the whole run exactly.  The CUDA twin of the hash
is ``csrc/sequential.cuh``.  CPU torch has no uint32 arithmetic, so the
hash runs in int64 masked to 32 bits (``utils/bitops.py``).

``mc_longframe_viterbi`` launches ``csrc/longframe_mc.cu``, which replaces
the TPU kernel ``_mc_longframe_kernel`` (fused_longframe.py:84) behind
``mc_longframe_viterbi`` (:223); it takes a ``device``: CPU runs
:func:`mc_longframe_viterbi_ref`, CUDA launches the kernel (counted in
``mc_longframe_viterbi.launches``) or raises.  The kernel's decision
scratch holds only the rows its traceback reads, packed for S < 32
(:func:`decision_scratch_shape`), the payload's info bits stored beside it
(:func:`info_scratch_shape`); :func:`threads_per_lane` says how many
threads share a lane.  BSC counters agree exactly between the two; AWGN
counters up to the last-ulp differences of log/sqrt/sin/cos between math
libraries.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from convolutional_codes_tpu_torch.models.codebook import Code
from convolutional_codes_tpu_torch.models.tables import code_tables
from convolutional_codes_tpu_torch.ops.encoder import register_symbols
from convolutional_codes_tpu_torch.ops.fused_chain import (
    CHANNELS, DEMAPPERS, MAX_STATES, awgn_distances, bsc_flip_mask, flip_threshold)
from convolutional_codes_tpu_torch.ops.viterbi import (
    HARD_METRIC_SAT, acs_scan, hard_branch_metrics, traceback_from)
from convolutional_codes_tpu_torch.utils.bitops import MASK32, first_argmin, mul32
from convolutional_codes_tpu_torch.utils.build import check_status, load_library


def _fmix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3 32-bit finalizer on int64 values in [0, 2^32)."""
    x = x ^ (x >> 16)
    x = mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def coord_bits(lane: torch.Tensor, pos: torch.Tensor, seed: int,
               salt: int) -> torch.Tensor:
    """32-bit hash of (seed, lane, pos, salt) as int64 in [0, 2^32);
    ``lane``/``pos`` are integer tensors that broadcast together."""
    lane = lane.to(torch.int64) & MASK32
    c = mul32(pos.to(torch.int64) & MASK32, 0x9E3779B9) ^ mul32(lane, 0x7FEB352D)
    c = (c + ((int(seed) + salt * 0x68E31DA4) & MASK32)) & MASK32
    return _fmix32(_fmix32(c) ^ lane)


def coord_uniform(lane: torch.Tensor, pos: torch.Tensor, seed: int,
                  salt: int) -> torch.Tensor:
    """float32 in (0, 1) from 31 hash bits: ``(bits >> 1) * 2^-31 + 2^-32``."""
    bits = (coord_bits(lane, pos, seed, salt) >> 1).to(torch.float32)
    return bits * torch.tensor(2.0 ** -31) + torch.tensor(2.0 ** -32)


def _check_args(code: Code, channel: str, demapper: str, window: int,
                warmup: int) -> int:
    """The limits of the long-frame chain; returns the window length with
    halos, ``Tw = window + 2 * warmup``."""
    if channel not in CHANNELS:
        raise ValueError(f"channel must be one of {CHANNELS}, got {channel!r}")
    if demapper not in DEMAPPERS:
        raise ValueError(f"demapper must be one of {DEMAPPERS}, got {demapper!r}")
    if window < 1 or warmup < 0:
        raise ValueError(f"need window >= 1 and warmup >= 0, got {window}, {warmup}")
    Tw = window + 2 * warmup
    if channel == "bsc" and 2 * Tw >= HARD_METRIC_SAT:
        raise ValueError(f"window+halos {Tw} too long for saturating hard metrics "
                         "(metric ceiling 0xFF00)")
    if code.num_states > MAX_STATES:
        raise NotImplementedError(
            f"the long-frame chain supports S <= {MAX_STATES} (K <= 9); "
            f"{code.name} has S={code.num_states}")
    # any M, as the JAX package's kernel; which, like it, builds its stage
    # helpers from the constellation on both channels
    if code_tables(code).points_np is None:
        raise ValueError(f"no constellation for {code.symlen_out} bits/symbol")
    return Tw


def stream_segment_host(code: Code, lane_ids, seed: int, param, channel: str,
                        start: int, length: int, demapper: str = "soft", device=None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The exact stream segment the kernel simulates for the given lanes:
    info bits and branch metrics at stream positions ``start`` ..
    ``start + length - 1`` — same hash, same flip and Box-Muller draws, same
    float32 expressions — as whole-tensor ops.  Returns (bits [B, length]
    int32, dists [B, length, 2^m] float32: demapper distances on AWGN,
    Hamming distances on BSC), on ``device`` (default: that of
    ``lane_ids``, else the CPU)."""
    K = code.constraint_length
    lanes = torch.as_tensor(lane_ids, dtype=torch.int64, device=device)[:, None]
    tables = code_tables(code, lanes.device)
    pos = torch.arange(start - (K - 1), start + length, dtype=torch.int64,
                       device=lanes.device)[None, :]
    bits = coord_bits(lanes, pos, seed, 0) & 1                  # [B, length + K-1]
    reg = torch.zeros((lanes.shape[0], length), dtype=torch.int64, device=lanes.device)
    for age in range(K):   # age 0 = the newest bit, at register bit K-1
        reg = reg | (bits[:, K - 1 - age: K - 1 - age + length] << (K - 1 - age))
    esym = register_symbols(code, reg)
    ppos = pos[:, K - 1:]
    if channel == "bsc":
        fmask = bsc_flip_mask(esym, code.symlen_out,
                              lambda k: coord_uniform(lanes, ppos, seed, 1 + k), param)
        dists = hard_branch_metrics(code, esym ^ fmask).to(torch.float32)
    else:
        u0 = coord_uniform(lanes, ppos, seed, 1)
        u1 = coord_uniform(lanes, ppos, seed, 2)
        dvec = awgn_distances(tables, esym, u0, u1, param, demapper)  # [M, B, length]
        dists = dvec.permute(1, 2, 0).contiguous()
    return bits[:, K - 1:].to(torch.int32), dists


def mc_longframe_viterbi_ref(code: Code, lanes: int, nsteps: int, seed, param,
                             channel: str = "awgn", demapper: str = "soft",
                             window: int = 1920, warmup: int = 128, win0: int = 0,
                             device="cpu") -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`mc_longframe_viterbi`: one window at a time
    for all lanes — the segment from :func:`stream_segment_host`, the plain
    ACS scan from zero metrics, the first-argmin end state and the plain
    traceback — with errors counted on the payload rows."""
    Tw = _check_args(code, channel, demapper, window, warmup)
    device = torch.device(device)
    lane_ids = torch.arange(lanes, dtype=torch.int64, device=device)
    zeros = torch.zeros((code.num_states, lanes), dtype=torch.float32, device=device)
    pay = slice(warmup, warmup + window)
    errs = torch.zeros(lanes, dtype=torch.int32, device=device)
    werrs = torch.zeros(lanes, dtype=torch.int32, device=device)
    for step in range(nsteps):
        bits, dists = stream_segment_host(code, lane_ids, seed, param, channel,
                                          (win0 + step) * window - warmup, Tw, demapper)
        fm, dec = acs_scan(code, dists.permute(1, 2, 0).contiguous(), zeros,
                           channel == "bsc")
        decoded = traceback_from(code, dec, first_argmin(fm, dim=0))
        mism = decoded[:, pay] != bits[:, pay]
        errs += mism.sum(1, dtype=torch.int32)
        werrs += mism.any(1).to(torch.int32)
    return errs, werrs


def decision_scratch_shape(num_states: int, window: int, warmup: int,
                           lanes: int) -> Tuple[int, int, int]:
    """Shape of the kernel's decision scratch, ``(items, words per item,
    lanes)`` of 32-bit words: the rows the traceback reads, t >= W of the
    ``window + 2 warmup``, ``ceil(S/32)`` words each; for S < 32, ``P = 32 /
    S`` rows share one word, aligned to multiples of P: item ``q`` holds
    rows ``(q + W // P) P + i`` in bits ``i S ..``."""
    per_word = 32 // num_states if num_states < 32 else 1
    Tw = window + 2 * warmup
    return -(-Tw // per_word) - warmup // per_word, -(-num_states // 32), lanes


def info_scratch_shape(window: int, warmup: int, lanes: int) -> Tuple[int, int]:
    """Shape of the stored info bits, 32 rows a word aligned to multiples of
    32: word ``j`` holds rows ``32 (j + W // 32) + i`` in bit ``i``, from
    the word of row W to the word of the last payload row W + window - 1."""
    return (warmup + window - 1) // 32 - warmup // 32 + 1, lanes


def threads_per_lane(num_states: int) -> int:
    """Threads that share a lane's states in the kernel: one up to S = 64,
    ``S / 32`` from S = 128 (32 states a thread).  At 65,536 lanes x 2
    windows the groups beat one thread a lane 1.5x at S = 128 and 3.6x at
    S = 256, and groups of 2-8 lost to it at S = 64 (PERF.md)."""
    return 1 if num_states <= 64 else num_states // 32


@functools.lru_cache(maxsize=None)
def _lib():
    lib = load_library("longframe_mc")
    P, I, U, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float
    lib.cc_mc_longframe.argtypes = [P, P, P, I, I, I, I, I, U, F, I, I, I, I, P, P, P, U, F,
                                    U, I, P]
    lib.cc_mc_longframe.restype = I
    return lib


def mc_longframe_viterbi(code: Code, lanes: int, nsteps: int, seed, param,
                         channel: str = "awgn", demapper: str = "soft",
                         window: int = 1920, warmup: int = 128, win0: int = 0,
                         device="cuda") -> Tuple[torch.Tensor, torch.Tensor]:
    """Monte-Carlo long-frame Viterbi chain: each of ``lanes`` coded streams
    advances ``nsteps`` windows (``win0`` on) of ``window`` payload symbols
    plus ``warmup``-symbol halos.

    ``channel``: "awgn" (param = sigma, soft metrics; ``demapper`` "soft"
    or "hard" snap-then-distance) or "bsc" (param = crossover probability,
    0xFF00-saturating Hamming metrics).  Returns per-lane (bit_errors,
    window_errors) int32; the run simulates ``lanes * nsteps * window``
    info bits.

    ``win0`` is the first window's index in each lane's stream.  One-device
    callers leave it at 0; ``parallel/streaming.streaming_mc_accumulate``
    shards a run's windows over a mesh's slots by time range with it, where
    window ranges that tile ``[0, n)`` sum to the ``n``-window counters
    exactly.
    """
    device = torch.device(device)
    if device.type == "cpu":
        return mc_longframe_viterbi_ref(code, lanes, nsteps, seed, param, channel,
                                        demapper, window, warmup, win0, device)
    if device.type != "cuda":
        raise ValueError(f"mc_longframe_viterbi runs on CPU or CUDA, got {device}")
    if not torch.cuda.is_available():
        raise RuntimeError("mc_longframe_viterbi: no CUDA device (pass device='cpu' "
                           "for the plain version)")
    from convolutional_codes_tpu_torch.ops.mc_datagen import seq_params  # imports this module

    _check_args(code, channel, demapper, window, warmup)
    if lanes <= 0 or nsteps < 0:
        raise ValueError(f"need lanes > 0 and nsteps >= 0, got {lanes}, {nsteps}")
    tables = code_tables(code, device)
    points, polys, qmask, inv_nd = seq_params(code, channel, device)
    scratch = torch.empty(decision_scratch_shape(code.num_states, window, warmup, lanes),
                          dtype=torch.int32, device=device)
    info = torch.empty(info_scratch_shape(window, warmup, lanes), dtype=torch.int32,
                       device=device)
    out = torch.empty((2, lanes), dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        status = _lib().cc_mc_longframe(
            out.data_ptr(), scratch.data_ptr(), info.data_ptr(),
            lanes, int(nsteps), int(win0), warmup, window, int(seed) & MASK32, float(param),
            int(channel == "awgn"), int(demapper == "hard"), code.constraint_length,
            code.symlen_out, tables.esym_prev_np.ctypes.data, points.ctypes.data,
            polys.ctypes.data, qmask, inv_nd,
            flip_threshold(param) if channel == "bsc" else 0,
            threads_per_lane(code.num_states), torch.cuda.current_stream().cuda_stream)
    check_status(status, "mc_longframe_viterbi")
    mc_longframe_viterbi.launches += 1
    return out[0], out[1]


mc_longframe_viterbi.launches = 0
