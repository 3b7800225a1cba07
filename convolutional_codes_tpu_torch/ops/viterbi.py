"""Batched Viterbi decoders: the plain PyTorch reference and the dispatcher.

Reference semantics (soft: ``AWGN-channel/viterbi-decoder.c``, hard:
``binary-symmetric-channel/viterbi-decoder.c``):
  * block decoding over ``T = block_len + K - 1`` symbols,
  * init: state 0 metric 0, all others +INF / 0xFF00 (decoder_reset),
  * ACS over all states x 2 inputs, strict-less compare so the smaller
    predecessor index wins ties (receive_symbol loops s ascending),
  * hard metrics are Hamming distances saturated at 0xFF00 (:127-130),
  * full-block traceback from the first minimum end state (traceback();
    the reference does NOT force end state 0 despite tail termination).

Layouts follow the reference package: metrics ``[S, B]`` inside the scan,
decisions bit-packed along states into ``[T, ceil(S/32), B]`` int32 (bit
``s % 32`` of word ``s // 32`` is new state s's chosen-predecessor bit).

Dispatch (replaces the reference's ``_pallas_eligible``): a CUDA tensor
with S <= 256 decodes in the CUDA kernels of :mod:`.viterbi_cuda`; a CPU
tensor, or S > 256 on any device, runs the plain scan below.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from convolutional_codes_tpu.models.codebook import Code
from convolutional_codes_tpu_torch.models.tables import code_tables
from convolutional_codes_tpu_torch.utils.bitops import MASK32, first_argmin, to_int32

#: Hard-decision metric saturation value (binary-symmetric-channel/
#: viterbi-decoder.c:127-130 and decoder_reset :222-232).
HARD_METRIC_SAT = 0xFF00

#: Finite stand-in for +inf soft start metrics in the kernels: absorbing
#: under float32 adds (any real branch metric is below its 7.6e22 ulp), so
#: decisions and final metrics equal those of an +inf start.
BIG_METRIC = 1e30

#: Largest state count the CUDA kernels take (K <= 9).
KERNEL_MAX_STATES = 256


@functools.lru_cache(maxsize=None)
def _popcount_table(num_bits: int) -> np.ndarray:
    """[2^m, 2^m] int32: popcount(r ^ e) — Hamming branch-metric lookup."""
    n = 1 << num_bits
    r = np.arange(n)[:, None] ^ np.arange(n)[None, :]
    return np.array([[bin(x).count("1") for x in row] for row in r], dtype=np.int32)


def hard_branch_metrics(code: Code, received: torch.Tensor) -> torch.Tensor:
    """``[..., T]`` received symbols → ``[..., T, 2^m]`` int32 Hamming
    distances to every possible expected symbol."""
    table = torch.as_tensor(_popcount_table(code.symlen_out), device=received.device)
    return table[received.to(torch.int64)]


def initial_metrics(code: Code, batch: int, hard: bool, device="cpu") -> torch.Tensor:
    """State-0-pinned start metrics ``[B, S]`` (decoder_reset: state 0 → 0,
    the rest INF; int32 0xFF00 in hard mode)."""
    S = code.num_states
    if hard:
        init = torch.full((batch, S), HARD_METRIC_SAT, dtype=torch.int32, device=device)
    else:
        init = torch.full((batch, S), float("inf"), dtype=torch.float32, device=device)
    init[:, 0] = 0
    return init


def acs_scan(code: Code, bm_tmb: torch.Tensor, init_sb: torch.Tensor, hard: bool
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain forward ACS in the kernel layout, in the dtype of ``init_sb``.

    ``bm_tmb``: [T, M, B] branch metrics; ``init_sb``: [S, B] start metrics.
    Returns (final metrics [S, B], packed decisions [T, nwords, B] int32).
    """
    tables = code_tables(code, bm_tmb.device)
    S, nwords = tables.num_states, tables.nwords
    prev0, prev1 = tables.prev_state[:, 0], tables.prev_state[:, 1]
    esym0, esym1 = tables.esym_prev[:, 0], tables.esym_prev[:, 1]
    T, _, B = bm_tmb.shape
    bm_tmb = bm_tmb.to(init_sb.dtype)
    weight = (1 << torch.arange(32, dtype=torch.int64, device=bm_tmb.device))[:, None]
    decisions = torch.empty((T, nwords, B), dtype=torch.int32, device=bm_tmb.device)
    metrics = init_sb
    for t in range(T):
        cand0 = metrics[prev0] + bm_tmb[t][esym0]
        cand1 = metrics[prev1] + bm_tmb[t][esym1]
        if hard:
            cand0 = torch.clamp_max(cand0, HARD_METRIC_SAT)
            cand1 = torch.clamp_max(cand1, HARD_METRIC_SAT)
        dec = cand1 < cand0                                  # strict: ties → 0
        metrics = torch.where(dec, cand1, cand0)
        bits = torch.zeros((nwords * 32, B), dtype=torch.int64, device=dec.device)
        bits[:S] = dec
        decisions[t] = to_int32((bits.view(nwords, 32, B) * weight).sum(1))
    return metrics, decisions


def acs_forward(code: Code, branch_metrics: torch.Tensor, hard: bool,
                init: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward ACS pass from arbitrary start metrics.

    branch_metrics: [B, T, 2^m]; init: [B, S] (int32 hard / float32 soft).
    Returns (final_metrics [B, S], decisions [T, ceil(S/32), B] int32).
    """
    dtype = torch.int32 if hard else torch.float32
    fm, dec = acs_scan(code, branch_metrics.permute(1, 2, 0),
                       init.to(dtype).T, hard)
    return fm.T, dec


def traceback_from(code: Code, decisions: torch.Tensor,
                   start_states: torch.Tensor) -> torch.Tensor:
    """Traceback from explicit per-frame start states.

    ``decisions``: packed [T, nwords, B]; ``start_states``: [B].  Returns
    bits [B, T] int32 (the input bit into each state on the path).
    """
    T = decisions.shape[0]
    S = code.num_states
    K = code.constraint_length
    half_mask = (S >> 1) - 1
    cur = start_states.to(torch.int64)
    bits = torch.empty((T,) + cur.shape, dtype=torch.int32, device=cur.device)
    for t in range(T - 1, -1, -1):
        word = torch.gather(decisions[t], 0, (cur >> 5)[None])[0].to(torch.int64)
        b = ((word & MASK32) >> (cur & 31)) & 1
        bits[t] = (cur >> (K - 2)).to(torch.int32)
        cur = ((cur & half_mask) << 1) | b
    return bits.T


def _decode(code: Code, bm: torch.Tensor, hard: bool
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """bm [B, T, M] → (bits [B, T] int32, winning path metric [B])."""
    if bm.is_cuda and code.num_states <= KERNEL_MAX_STATES:
        from convolutional_codes_tpu_torch.ops.viterbi_cuda import (
            acs_forward_cuda, traceback_cuda)
        S, B = code.num_states, bm.shape[0]
        d_tmb = bm.to(torch.float32).permute(1, 2, 0).contiguous()
        init = torch.full((S, B), float(HARD_METRIC_SAT) if hard else BIG_METRIC,
                          dtype=torch.float32, device=bm.device)
        init[0] = 0.0
        fm, dec = acs_forward_cuda(code, d_tmb, init, hard)
        bits, min_metric = traceback_cuda(code, dec, fm)
        if hard:
            min_metric = min_metric.to(torch.int32)
        return bits.T, min_metric
    final_metrics, decisions = acs_forward(
        code, bm, hard, initial_metrics(code, bm.shape[0], hard, bm.device))
    end_state = first_argmin(final_metrics, dim=-1)
    bits = traceback_from(code, decisions, end_state)
    return bits, final_metrics.amin(dim=-1)


def viterbi_decode_soft(code: Code, distances) -> torch.Tensor:
    """Soft-decision block Viterbi: ``[B, T, 2^m]`` demapper distance
    vectors → ``[B, block_len]`` int32 decoded info bits (tail stripped)."""
    distances = torch.as_tensor(distances).to(torch.float32)
    bits, _ = _decode(code, distances, hard=False)
    return bits[:, : code.block_length]


def viterbi_decode_hard(code: Code, received) -> Tuple[torch.Tensor, torch.Tensor]:
    """Hard-decision block Viterbi on ``[B, T]`` received symbols (masked to
    symlen_out bits).  Returns (``[B, block_len]`` int32 decoded bits,
    ``[B]`` int32 winning path metric —
    binary-symmetric-channel/include/decoder.h:9)."""
    bm = hard_branch_metrics(code, torch.as_tensor(received))
    bits, metric = _decode(code, bm, hard=True)
    return bits[:, : code.block_length], metric
