"""Plain Fano sequential decoder: a lockstep masked machine over a batch of
frames.

Reference semantics (soft: ``AWGN-channel/fano-decoder.c``, hard:
``binary-symmetric-channel/fano-decoder.c``), as the JAX package's
``ops/fano.py`` (:125-199) and its Monte-Carlo kernel (fano_mc.py:153-260)
hold them:
  * one path with a running threshold, step FANO_DELTA = 17, and a budget
    of ``timeout_per_bit * T`` SEARCH steps per frame (BACKTRACK steps
    cost none);
  * per node both branch metrics and successors, sorted best-first with a
    strict ``<`` (ties keep input 0); ``decoded`` flips whenever the other
    branch is selected;
  * a forward move when the selected successor's metric reaches the
    threshold, tightening the threshold when the node is first reached;
    otherwise back up while the predecessor still reaches it, else relax
    the threshold by DELTA and retry from the best branch;
  * on budget exhaustion the best-so-far bits are emitted; nodes beyond
    the deepest visit keep ``decoded = 0``.

Each micro-step is one SEARCH step and, chained into the same micro-step
as in the JAX kernel, the first BACKTRACK step of a frame whose SEARCH
failed; every other BACKTRACK step is a micro-step of its own.  The
per-frame walk is the reference's.  Thresholds stay multiples of DELTA, so
the tightening loop ``while ms >= thr + DELTA: thr += DELTA`` is replaced by
its closed form ``floor((ms - thr) / DELTA)`` with two correction steps
(IEEE division), exact either way.  Metrics are float32 for both channels;
hard metrics are small integers, exact in float32.  Products are rounded
before adds (``ops/sequential_common.py``).

This is the plain version of the CUDA kernel in ``csrc/fano_mc.cu`` and the
CPU path of ``ops/fano_mc.py``.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from convolutional_codes_tpu_torch.models.codebook import Code
from convolutional_codes_tpu_torch.ops.sequential_common import (
    hard_transition_metrics, make_branch_fn, run_lockstep, soft_transition_metrics)

FANO_TIMEOUT = 10000   # SEARCH steps per decoded bit (fano-decoder.c:14)
FANO_DELTA = 17.0      # threshold step (fano-decoder.c:15)


def fano_machine(code: Code, symbols: torch.Tensor, soft: bool,
                 timeout_per_bit: int = FANO_TIMEOUT
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Decode ``[B, T, 2^m]`` float32 distances (soft) or ``[B, T]`` int
    received symbols (hard).  Returns (bits [B, block_length] int32,
    diagnostics {metric, timeout_left, depth, timed_out, iters}); ``iters``
    counts each frame's micro-steps."""
    B, T = symbols.shape[0], code.num_block_symbols
    dev = symbols.device
    branch = make_branch_fn(code)
    ar = torch.arange(B, device=dev)
    delta = torch.tensor(FANO_DELTA, dtype=torch.float32)
    if not soft:
        symbols = symbols.to(torch.int64)

    def node_metrics(s, t):
        """Branch data, sorted best-first, of the nodes at symbol ``t``."""
        ns0, e0 = branch(s, 0)
        ns1, e1 = branch(s, 1)
        if soft:
            tm0, tm1 = soft_transition_metrics(code.fano_metric_weight,
                                               symbols[ar, t], e0, e1)
        else:
            tm0, tm1 = hard_transition_metrics(code.fano_bit_metrics, code.symlen_out,
                                               symbols[ar, t], e0, e1)
        swap = tm0 < tm1
        return (torch.where(swap, ns1, ns0), torch.where(swap, ns0, ns1),
                torch.where(swap, tm1, tm0), torch.where(swap, tm0, tm1),
                swap.to(torch.int8))

    def zeros(dtype):
        return torch.zeros((B, T), dtype=dtype, device=dev)

    nstate, succ0, succ1 = zeros(torch.int64), zeros(torch.int64), zeros(torch.int64)
    nmetric, tm0, tm1 = zeros(torch.float32), zeros(torch.float32), zeros(torch.float32)
    selected, decoded = zeros(torch.int8), zeros(torch.int8)
    zero = torch.zeros(B, dtype=torch.int64, device=dev)
    succ0[:, 0], succ1[:, 0], tm0[:, 0], tm1[:, 0], decoded[:, 0] = node_metrics(zero, zero)

    cur = zero.clone()
    thr = torch.zeros(B, dtype=torch.float32, device=dev)
    timeout = torch.full((B,), int(timeout_per_bit) * T, dtype=torch.int64, device=dev)
    backtrack = torch.zeros(B, dtype=torch.bool, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    iters = torch.zeros(B, dtype=torch.int64, device=dev)

    def put(arr, idx, val, mask):
        arr[ar, idx] = torch.where(mask, val, arr[ar, idx])

    def update(arr, mask, val):
        arr.copy_(torch.where(mask, val, arr))

    def micro_step():
        iters.add_((~done).to(torch.int64))
        # ---- SEARCH step (fano-decoder.c:183-236)
        search = ~backtrack & ~done
        exhausted = search & (timeout == 0)
        act = search & ~exhausted
        update(timeout, act, timeout - 1)
        sel = selected[ar, cur]
        m_cur = nmetric[ar, cur]
        ms = m_cur + torch.where(sel == 0, tm0[ar, cur], tm1[ar, cur])
        fwd = act & (ms >= thr)
        # tightening: the closed form of the += DELTA loop
        gate = fwd & (m_cur < thr + delta)
        k = torch.floor((ms - thr) / delta).to(torch.int64)
        k = torch.where(ms >= thr + (k + 1).to(torch.float32) * delta, k + 1, k)
        k = torch.where(ms < thr + k.to(torch.float32) * delta, k - 1, k)
        update(thr, gate, thr + k.clamp(min=0).to(torch.float32) * delta)
        # forward move, and the branch data of the node entered
        finished = fwd & (cur + 1 == T)
        step_fwd = fwd & ~finished
        ssel = torch.where(sel == 0, succ0[ar, cur], succ1[ar, cur])
        update(cur, step_fwd, cur + 1)
        put(nstate, cur, ssel, step_fwd)
        put(nmetric, cur, ms, step_fwd)
        b0, b1, bt0, bt1, bdec = node_metrics(nstate[ar, cur], cur)
        put(succ0, cur, b0, step_fwd)
        put(succ1, cur, b1, step_fwd)
        put(tm0, cur, bt0, step_fwd)
        put(tm1, cur, bt1, step_fwd)
        put(decoded, cur, bdec, step_fwd)
        put(selected, cur, torch.zeros_like(bdec), step_fwd)
        backtrack.bitwise_or_(act & ~fwd)
        # ---- BACKTRACK step (fano-decoder.c:237-264), chained
        back = backtrack & ~done
        pm = nmetric[ar, (cur - 1).clamp(min=0)]
        can_back = back & (cur > 0) & (pm >= thr)
        relax = back & ~can_back
        update(thr, relax, thr - delta)
        flip = relax & (selected[ar, cur] != 0)
        put(decoded, cur, decoded[ar, cur] ^ 1, flip)
        put(selected, cur, torch.zeros_like(sel), flip)
        update(cur, can_back, cur - 1)
        take_second = can_back & (selected[ar, cur] == 0)
        put(decoded, cur, decoded[ar, cur] ^ 1, take_second)
        put(selected, cur, torch.ones_like(sel), take_second)
        backtrack.bitwise_and_(~(relax | take_second))
        done.bitwise_or_(finished | exhausted)

    run_lockstep(micro_step, done)
    diag = {"metric": nmetric[ar, cur], "timeout_left": timeout, "depth": cur,
            "timed_out": timeout == 0, "iters": iters}
    return decoded[:, :code.block_length].to(torch.int32), diag


def fano_decode_soft(code: Code, distances: torch.Tensor,
                     timeout_per_bit: int = FANO_TIMEOUT) -> torch.Tensor:
    """``[B, T, 2^m]`` demapper distances → ``[B, block_len]`` decoded bits."""
    return fano_machine(code, distances.to(torch.float32), True, timeout_per_bit)[0]


def fano_decode_hard(code: Code, received: torch.Tensor,
                     timeout_per_bit: int = FANO_TIMEOUT) -> torch.Tensor:
    """``[B, T]`` received symbols → ``[B, block_len]`` decoded bits."""
    return fano_machine(code, received, False, timeout_per_bit)[0]


def fano_decode_soft_with_diag(code: Code, distances: torch.Tensor,
                               timeout_per_bit: int = FANO_TIMEOUT):
    """Like :func:`fano_decode_soft`, also returning per-frame diagnostics
    {metric, timeout_left, depth, timed_out, iters} — the observable state
    the reference exposes via its VERBOSE trace and metric callback."""
    return fano_machine(code, distances.to(torch.float32), True, timeout_per_bit)


def fano_decode_hard_with_diag(code: Code, received: torch.Tensor,
                               timeout_per_bit: int = FANO_TIMEOUT):
    return fano_machine(code, received, False, timeout_per_bit)
