"""CUDA Viterbi kernels (``csrc/longframe.cu``) and their plain versions.

``acs_forward_cuda`` replaces the TPU kernel ``acs_forward_pallas``
(viterbi_pallas.py:157) and ``traceback_cuda`` replaces
``traceback_pallas`` (:232), with the same kernel-entry layouts:
``[T, M, B]`` float32 distances and ``[S, B]`` float32 start metrics in,
``[S, B]`` final metrics and ``[T, nwords, B]`` int32 packed decisions out;
``[T, B]`` int32 bits from the traceback.  The traceback also does the
end-state argmin, so it takes the final metrics rather than start states,
and returns the winning metric beside the bits.

They launch the same device kernels as the streaming decode of
:mod:`ops.longframe_cuda` (whose wrappers are built on :func:`_acs` and
:func:`_traceback` here): a kernel laid out by state serves the short
terminated blocks of the modular chain as well as streams of any length,
and :func:`traceback_plan` picks the traceback's design from the shape —
one walk per frame where the frames fill the card, segments of a frame
walked side by side where they do not.

A CPU tensor runs the plain version (``acs_forward_ref``/
``traceback_ref``); a CUDA tensor launches the kernel or raises.  Each
wrapper counts its launches in its ``launches`` attribute.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional, Tuple

import torch

from convolutional_codes_tpu_torch.models.codebook import Code
from convolutional_codes_tpu_torch.models.tables import code_tables
from convolutional_codes_tpu_torch.ops.viterbi import (
    KERNEL_MAX_STATES, acs_scan, traceback_from)
from convolutional_codes_tpu_torch.utils.bitops import first_argmin

#: Largest constellation the ACS kernel takes: 256 points, 8 coded bits a
#: symbol, the widest code the JAX package registers (``models/codebook``:
#: symlen_out 1-8); M = 2-16 have instances of their own
#: (``csrc/acs.cuh`` CC_DISPATCH16), M = 32-256 one per S with M at run time
KERNEL_MAX_POINTS = 256
from convolutional_codes_tpu_torch.utils.build import check_status, load_library

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.lru_cache(maxsize=None)
def _lib():
    lib = load_library("longframe")
    lib.cc_stream_acs.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P]
    lib.cc_stream_acs.restype = _I
    lib.cc_stream_traceback.argtypes = [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                        _I, _P]
    lib.cc_stream_traceback.restype = _I
    return lib


def _runs_plain(x: torch.Tensor, what: str) -> bool:
    """True for a CPU tensor (the plain version runs), False for a CUDA one
    (the kernel launches); raises for any other device."""
    if x.device.type == "cpu":
        return True
    if x.device.type != "cuda":
        raise ValueError(f"{what} takes CPU or CUDA tensors, got {x.device}")
    return False


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
    if code.num_states > KERNEL_MAX_STATES or code.points_per_symbol > KERNEL_MAX_POINTS:
        raise ValueError(f"the CUDA Viterbi kernels take S <= {KERNEL_MAX_STATES} "
                         f"and M <= {KERNEL_MAX_POINTS}; {code.name} has "
                         f"S={code.num_states}, M={code.points_per_symbol}")


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


def _acs(code: Code, dists_tmb: torch.Tensor, init_sb: torch.Tensor, hard: bool,
         what: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the ACS kernel on CUDA tensors: (fm [S, B], dec [T, nwords, B])."""
    _check_code(code)
    tables = code_tables(code, dists_tmb.device)
    T, M, B = dists_tmb.shape
    S = code.num_states
    if T < 1:
        raise ValueError(f"{what} needs T >= 1")
    _check("dists_tmb", dists_tmb, (T, code.points_per_symbol, B), torch.float32,
           dists_tmb.device)
    _check("init_sb", init_sb, (S, B), torch.float32, dists_tmb.device)
    fm = torch.empty((S, B), dtype=torch.float32, device=dists_tmb.device)
    dec = torch.empty((T, tables.nwords, B), dtype=torch.int32, device=dists_tmb.device)
    with torch.cuda.device(dists_tmb.device):
        status = _lib().cc_stream_acs(
            dists_tmb.data_ptr(), init_sb.data_ptr(), fm.data_ptr(), dec.data_ptr(),
            T, M, B, S, int(hard), tables.esym_prev_np.ctypes.data,
            torch.cuda.current_stream().cuda_stream)
    check_status(status, what)
    return fm, dec


#: Rows per segment of the segmented traceback.
SEGMENT_ROWS = 128
_MAX_SEGMENTS = 65535            # the grid's y extent
_MAP_SMEM_BYTES = 48 * 1024      # a segment's staged decisions: L x nwords x 8 frames x 4 B


class TracebackPlan(NamedTuple):
    """How the traceback kernels walk ``[T, nwords, B]`` decisions.

    ``design`` "frame": one thread walks each whole frame (``segment`` =
    T).  "segments": each frame is cut into ``ceil(T / segment)``
    segments whose end-state maps are computed side by side, folded from
    the last segment back, and walked again from the true end states."""
    design: str
    segment: int


def frame_walk_min_frames(S: int) -> int:
    """Frames from which one walk per frame beats the segments at S states.
    The segment maps cost a warp per frame and row, the walks (once the
    frames fill the card) about nwords loads per frame and row.  chip_smoke.py's
    phase 5 times both designs at T = 4,096 (PERF.md): segments win at B =
    4,096 and lose at 8,192 for S = 4 and 32 (6,144 lies between), lose at
    4,096 for S = 64 and tie there for S = 256."""
    return 6144 if S <= 32 else 4096


def traceback_plan(B: int, T: int, S: int) -> TracebackPlan:
    """The traceback's design for B frames of T rows and S states: one walk
    per frame where the frames fill the card (B >=
    :func:`frame_walk_min_frames`) or a frame is one segment; segments of
    :data:`SEGMENT_ROWS` rows otherwise (longer where the grid's 65,535
    segments need it)."""
    L = max(SEGMENT_ROWS, -(-T // _MAX_SEGMENTS))
    nwords = (S + 31) // 32
    if B >= frame_walk_min_frames(S) or T <= L or L * nwords * 32 > _MAP_SMEM_BYTES:
        return TracebackPlan("frame", T)
    return TracebackPlan("segments", L)


def _traceback(code: Code, decisions: torch.Tensor, start: Optional[torch.Tensor],
               final_metrics: Optional[torch.Tensor], what: str,
               plan: Optional[TracebackPlan] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the traceback kernels on CUDA tensors from ``[B]`` int32 start
    states, or, when ``start`` is None, from the first state of least
    ``[S, B]`` final metric, as ``plan`` (default :func:`traceback_plan`)
    says.  Returns (bits [T, B] int32, the state before row 0 [B] int32
    from start states, else the winning metric [B] float32)."""
    _check_code(code)
    T, nwords, B = decisions.shape
    S = code.num_states
    if T < 1:
        raise ValueError(f"{what} needs T >= 1")
    dev = decisions.device
    _check("decisions", decisions, (T, (S + 31) // 32, B), torch.int32, dev)
    plan = traceback_plan(B, T, S) if plan is None else plan
    L = min(plan.segment, T)
    G = math.ceil(T / L)
    if L < 1 or G > _MAX_SEGMENTS or (G > 1 and L * nwords * 32 > _MAP_SMEM_BYTES):
        raise ValueError(f"{what}: no traceback with segments of {plan.segment} rows "
                         f"at T={T}, S={S}")
    bits = torch.empty((T, B), dtype=torch.int32, device=dev)
    if start is not None:
        _check("start", start, (B,), torch.int32, dev)
        out = torch.empty((B,), dtype=torch.int32, device=dev)
        ptrs = (start.data_ptr(), None, out.data_ptr(), None)
    else:
        _check("final_metrics", final_metrics, (S, B), torch.float32, dev)
        out = torch.empty((B,), dtype=torch.float32, device=dev)
        ptrs = (None, final_metrics.data_ptr(), None, out.data_ptr())
    start_p, fm_p, carry_p, best_p = ptrs
    maps = ends = None
    if G > 1:   # scratch of the segments: end-state maps and true end states
        maps = torch.empty((B, G, S), dtype=torch.uint8, device=dev)
        ends = torch.empty((G, B), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        status = _lib().cc_stream_traceback(
            decisions.data_ptr(), start_p, fm_p, bits.data_ptr(), carry_p, best_p,
            None if maps is None else maps.data_ptr(),
            None if ends is None else ends.data_ptr(),
            T, B, S, code.constraint_length, nwords, L,
            torch.cuda.current_stream().cuda_stream)
    check_status(status, what)
    return bits, out


def acs_forward_cuda(code: Code, dists_tmb: torch.Tensor, init_sb: torch.Tensor,
                     hard: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward ACS over a ``[T, M, B]`` float32 distance stream from
    ``[S, B]`` float32 start metrics (BIG_METRIC, not inf).  Returns
    (final metrics [S, B] float32, decisions [T, nwords, B] int32)."""
    if _runs_plain(dists_tmb, "acs_forward_cuda"):
        return acs_forward_ref(code, dists_tmb, init_sb, hard)
    out = _acs(code, dists_tmb, init_sb, hard, "acs_forward_cuda")
    acs_forward_cuda.launches += 1
    return out


acs_forward_cuda.launches = 0


def traceback_cuda(code: Code, decisions: torch.Tensor, final_metrics: torch.Tensor,
                   plan: Optional[TracebackPlan] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Argmin end state (first wins ties) and traceback over packed
    ``[T, nwords, B]`` int32 decisions.  Returns (bits [T, B] int32,
    winning metric [B] float32).  ``plan``: the kernel's design (default
    :func:`traceback_plan`; the plain version ignores it)."""
    if _runs_plain(decisions, "traceback_cuda"):
        return traceback_ref(code, decisions, final_metrics)
    out = _traceback(code, decisions, None, final_metrics, "traceback_cuda", plan)
    traceback_cuda.launches += 1
    return out


traceback_cuda.launches = 0
