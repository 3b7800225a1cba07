"""CUDA Viterbi kernels (``csrc/viterbi.cu``) and their plain versions.

``acs_forward_cuda`` replaces the TPU kernel ``acs_forward_pallas``
(viterbi_pallas.py:157) and ``traceback_cuda`` replaces
``traceback_pallas`` (:232), with the same kernel-entry layouts:
``[T, M, B]`` float32 distances and ``[S, B]`` float32 start metrics in,
``[S, B]`` final metrics and ``[T, nwords, B]`` int32 packed decisions out;
``[T, B]`` int32 bits from the traceback.  The traceback kernel also does
the end-state argmin, so it takes the final metrics rather than start
states, and returns the winning metric beside the bits.

A CPU tensor runs the plain version (``acs_forward_ref``/
``traceback_ref``); a CUDA tensor launches the kernel or raises.  Each
wrapper counts its launches in its ``launches`` attribute.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from convolutional_codes_tpu.models.codebook import Code
from convolutional_codes_tpu_torch.models.tables import code_tables
from convolutional_codes_tpu_torch.ops.viterbi import (
    KERNEL_MAX_STATES, acs_scan, traceback_from)
from convolutional_codes_tpu_torch.utils.bitops import first_argmin
from convolutional_codes_tpu_torch.utils.build import check_status, load_library

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.lru_cache(maxsize=None)
def _lib():
    lib = load_library("viterbi")
    lib.cc_acs_forward.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P]
    lib.cc_acs_forward.restype = _I
    lib.cc_traceback.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P]
    lib.cc_traceback.restype = _I
    return lib


def _check(name: str, x: torch.Tensor, shape, dtype, device) -> None:
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_code(code: Code) -> None:
    if code.num_states > KERNEL_MAX_STATES or code.points_per_symbol > 8:
        raise ValueError(f"the CUDA Viterbi kernels take S <= {KERNEL_MAX_STATES} "
                         f"and M <= 8; {code.name} has S={code.num_states}, "
                         f"M={code.points_per_symbol}")


def acs_forward_ref(code: Code, dists_tmb: torch.Tensor, init_sb: torch.Tensor,
                    hard: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`acs_forward_cuda` (float32 metrics)."""
    return acs_scan(code, dists_tmb.to(torch.float32), init_sb.to(torch.float32), hard)


def traceback_ref(code: Code, decisions: torch.Tensor, final_metrics: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`traceback_cuda`: first-argmin end state, then
    traceback.  Returns (bits [T, B] int32, winning metric [B] float32)."""
    start = first_argmin(final_metrics, dim=0)
    bits = traceback_from(code, decisions, start).T.contiguous()
    return bits, final_metrics.amin(dim=0)


def acs_forward_cuda(code: Code, dists_tmb: torch.Tensor, init_sb: torch.Tensor,
                     hard: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward ACS over a ``[T, M, B]`` float32 distance stream from
    ``[S, B]`` float32 start metrics (BIG_METRIC, not inf).  Returns
    (final metrics [S, B] float32, decisions [T, nwords, B] int32)."""
    if dists_tmb.device.type == "cpu":
        return acs_forward_ref(code, dists_tmb, init_sb, hard)
    if dists_tmb.device.type != "cuda":
        raise ValueError(f"acs_forward_cuda takes CPU or CUDA tensors, "
                         f"got {dists_tmb.device}")
    _check_code(code)
    tables = code_tables(code, dists_tmb.device)
    T, M, B = dists_tmb.shape
    S = code.num_states
    _check("dists_tmb", dists_tmb, (T, code.points_per_symbol, B), torch.float32,
           dists_tmb.device)
    _check("init_sb", init_sb, (S, B), torch.float32, dists_tmb.device)
    fm = torch.empty((S, B), dtype=torch.float32, device=dists_tmb.device)
    dec = torch.empty((T, tables.nwords, B), dtype=torch.int32, device=dists_tmb.device)
    with torch.cuda.device(dists_tmb.device):
        status = _lib().cc_acs_forward(
            dists_tmb.data_ptr(), init_sb.data_ptr(), fm.data_ptr(), dec.data_ptr(),
            T, M, B, S, int(hard), tables.esym_prev_np.ctypes.data,
            torch.cuda.current_stream().cuda_stream)
    check_status(status, "acs_forward_cuda")
    acs_forward_cuda.launches += 1
    return fm, dec


acs_forward_cuda.launches = 0


def traceback_cuda(code: Code, decisions: torch.Tensor, final_metrics: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Argmin end state (first wins ties) and traceback over packed
    ``[T, nwords, B]`` int32 decisions.  Returns (bits [T, B] int32,
    winning metric [B] float32)."""
    if decisions.device.type == "cpu":
        return traceback_ref(code, decisions, final_metrics)
    if decisions.device.type != "cuda":
        raise ValueError(f"traceback_cuda takes CPU or CUDA tensors, "
                         f"got {decisions.device}")
    _check_code(code)
    T, nwords, B = decisions.shape
    S = code.num_states
    _check("decisions", decisions, (T, (S + 31) // 32, B), torch.int32, decisions.device)
    _check("final_metrics", final_metrics, (S, B), torch.float32, decisions.device)
    bits = torch.empty((T, B), dtype=torch.int32, device=decisions.device)
    best = torch.empty((B,), dtype=torch.float32, device=decisions.device)
    with torch.cuda.device(decisions.device):
        status = _lib().cc_traceback(
            decisions.data_ptr(), final_metrics.data_ptr(), bits.data_ptr(),
            best.data_ptr(), T, B, S, code.constraint_length, nwords,
            torch.cuda.current_stream().cuda_stream)
    check_status(status, "traceback_cuda")
    traceback_cuda.launches += 1
    return bits, best


traceback_cuda.launches = 0
