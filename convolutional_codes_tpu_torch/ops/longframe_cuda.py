"""Streaming long-frame Viterbi kernels (``csrc/longframe.cu``) and their
plain versions: the exact decode of supplied frames of any length.

``stream_acs_cuda`` replaces the TPU kernel ``stream_acs_pallas``
(longframe_pallas.py:112) and ``stream_traceback_cuda`` replaces
``stream_traceback_pallas`` (:192), with the same layouts: ``[T, M, B]``
float32 distances and ``[S, B]`` float32 start metrics in, ``[S, B]`` final
metrics and ``[T, nwords, B]`` int32 packed decisions out; packed
decisions and ``[B]`` start states in, ``[T, B]`` int32 bits and the
``[B]`` int32 state before row 0 (the carry of a segmented traceback) out.
The TPU kernels cut T into VMEM chunks; these take any T.  They launch
the device kernels of :mod:`ops.viterbi_cuda`'s wrappers (TPU kernels 1-2),
with their own launch counters.

Both compute what :func:`ops.viterbi.acs_scan` and
:func:`ops.viterbi.traceback_carry` compute, with the same float32
operations per state, so kernel and plain version agree bit for bit.

A CPU tensor runs the plain version; a CUDA tensor launches the kernel or
raises.  Each wrapper counts its launches in its ``launches`` attribute.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from convolutional_codes_tpu_torch.models.codebook import Code
from convolutional_codes_tpu_torch.ops.viterbi import traceback_carry
from convolutional_codes_tpu_torch.ops.viterbi_cuda import (
    TracebackPlan, _acs, _runs_plain, _traceback, acs_forward_ref)


def pair_steps(code: Code, T: int) -> int:
    """The exchanges kernel 4 makes over T steps in its two-step body, as
    its dispatch decides (``csrc/longframe.cu`` ``acs_two_step``: S = 64
    with M = 2-16 staged, two trellis steps an exchange): T // 2 there, 0
    for every other code."""
    return T // 2 if code.num_states == 64 and code.points_per_symbol <= 16 else 0


#: Plain version of :func:`stream_acs_cuda`: the plain ACS scan, as for
#: kernel 1 (float32 metrics).
stream_acs_ref = acs_forward_ref


def stream_traceback_ref(code: Code, decisions: torch.Tensor, start: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`stream_traceback_cuda`: (bits [T, B] int32,
    state before row 0 [B] int32)."""
    bits, carry = traceback_carry(code, decisions, start)
    return bits.T.contiguous(), carry.to(torch.int32)


def stream_acs_cuda(code: Code, dists_tmb: torch.Tensor, init_sb: torch.Tensor,
                    hard: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward ACS over a ``[T, M, B]`` float32 distance stream of any
    length T >= 1 from ``[S, B]`` float32 start metrics (BIG_METRIC, not
    inf).  Returns (final metrics [S, B] float32, decisions [T, nwords, B]
    int32)."""
    if _runs_plain(dists_tmb, "stream_acs_cuda"):
        return stream_acs_ref(code, dists_tmb, init_sb, hard)
    out = _acs(code, dists_tmb, init_sb, hard, "stream_acs_cuda")
    stream_acs_cuda.launches += 1
    return out


stream_acs_cuda.launches = 0


def stream_traceback_cuda(code: Code, decisions: torch.Tensor, start: torch.Tensor,
                          plan: Optional[TracebackPlan] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Traceback over packed ``[T, nwords, B]`` int32 decisions from the
    ``[B]`` int32 start states.  Returns (bits [T, B] int32, state before
    row 0 [B] int32): tracing rows [T/2, T) and then rows [0, T/2) from the
    carry gives the bits of one whole traceback.  ``plan``: the kernel's
    design (default ``viterbi_cuda.traceback_plan``: segments of a frame
    side by side at few long frames; the plain version ignores it)."""
    if _runs_plain(decisions, "stream_traceback_cuda"):
        return stream_traceback_ref(code, decisions, start)
    out = _traceback(code, decisions, start, None, "stream_traceback_cuda", plan)
    stream_traceback_cuda.launches += 1
    return out


stream_traceback_cuda.launches = 0
