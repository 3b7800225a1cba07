"""Stack-decoder Monte-Carlo: the CUDA kernel and its plain version.

One launch of ``csrc/stack_mc.cu`` runs ``lanes * frames_per_lane``
frames: lane ``g`` decodes frames ``gid = g * frames_per_lane + k`` with the
64-path stack search, generating each in the thread from the coordinate
hash (``ops/mc_datagen.py``) and banking its errors.  It replaces the TPU
kernel ``_stack_mc_kernel`` (stack_mc.py:84) behind ``mc_stack`` (:419).

Unlike the JAX package's ``mc_stack``, which returns totals, both versions
here return per-lane int64 counters ``[3, lanes]``: bit errors, frame
errors and the walk's iterations (micro-steps of the chained machine,
``ops/stack.py``).  The counters depend on (seed, gid) only, so the plain
version — every frame generated with ``frames_host`` and decoded at once
by the plain machine — gives the kernel's counters: exactly on BSC, and on
AWGN up to the last-ulp differences of log/sqrt/sin/cos between math
libraries.

``mc_stack`` takes a ``device``: CPU runs :func:`mc_stack_ref`, CUDA
launches the kernel (counted in ``mc_stack.launches``) or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from convolutional_codes_tpu_torch.models.codebook import Code
from convolutional_codes_tpu_torch.ops.mc_datagen import check_args, frames_host, seq_params
from convolutional_codes_tpu_torch.ops.stack import STACK_DEPTH, stack_machine
from convolutional_codes_tpu_torch.utils.build import check_status, load_library

#: bytes of path bits the plain machine may hold at once ([frames, 64, T]
#: uint8), which sets how many frames it decodes per pass
_REF_BITS_BYTES = 1 << 26


def count_errors(out: torch.Tensor, lane: torch.Tensor, dec: torch.Tensor,
                 bits: torch.Tensor, iters: torch.Tensor) -> None:
    """Add decoded frames' bit errors, frame errors and walk iterations to
    the per-lane counters ``out`` [3, lanes] at lanes ``lane``."""
    err = (dec != bits[:, :dec.shape[1]]).sum(dim=1)
    out[0].index_add_(0, lane, err)
    out[1].index_add_(0, lane, (err > 0).to(torch.int64))
    out[2].index_add_(0, lane, iters)


def mc_stack_ref(code: Code, lanes: int, frames_per_lane: int, seed: int, param,
                 channel: str = "awgn", demapper: str = "soft", device="cpu"
                 ) -> torch.Tensor:
    """Plain version of :func:`mc_stack`: the same frames from
    ``frames_host``, decoded by the plain lockstep machine in passes of up
    to ``_REF_BITS_BYTES`` of path bits; per-lane counters [3, lanes]."""
    check_args(code, channel, demapper)
    device = torch.device(device)
    N = lanes * frames_per_lane
    per_pass = max(1, _REF_BITS_BYTES // (STACK_DEPTH * code.num_block_symbols))
    out = torch.zeros((3, lanes), dtype=torch.int64, device=device)
    for g0 in range(0, N, per_pass):
        gids = torch.arange(g0, min(N, g0 + per_pass), device=device)
        bits, syms = frames_host(code, gids, seed, param, channel, demapper, device)
        dec, _, iters = stack_machine(code, syms, channel == "awgn")
        count_errors(out, gids // frames_per_lane, dec, bits, iters)
    return out


@functools.lru_cache(maxsize=None)
def _lib():
    lib = load_library("stack_mc")
    P, I, U, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float
    lib.cc_stack_scratch_words.argtypes = [I, I]
    lib.cc_stack_scratch_words.restype = ctypes.c_longlong
    lib.cc_mc_stack.argtypes = [P, P, P, I, I, U, F, I, I, I, I, I, I, P, P, U, F, F, I,
                                I, P]
    lib.cc_mc_stack.restype = I
    return lib


def _launch(code: Code, lanes: int, fpl: int, seed: int, param, channel: str,
            demapper: str, device) -> torch.Tensor:
    lib = _lib()
    T, M = code.num_block_symbols, code.points_per_symbol
    soft = channel == "awgn"
    syms = torch.empty((T, M, lanes) if soft else (T, lanes),
                       dtype=torch.float32 if soft else torch.int32, device=device)
    scratch = torch.empty(lib.cc_stack_scratch_words(T, lanes), dtype=torch.int32,
                          device=device)
    out = torch.empty((3, lanes), dtype=torch.int64, device=device)
    points, polys, qmask, inv_nd = seq_params(code, channel, device)
    with torch.cuda.device(device):
        status = lib.cc_mc_stack(
            out.data_ptr(), scratch.data_ptr(), syms.data_ptr(), lanes, fpl,
            int(seed) & 0x7FFFFFFF, float(param), int(soft), int(demapper == "hard"),
            code.constraint_length, code.block_length, T, code.symlen_out,
            points.ctypes.data, polys.ctypes.data, qmask, inv_nd,
            float(code.metric_weight), int(code.bit_metrics[0]),
            int(code.bit_metrics[1]), torch.cuda.current_stream().cuda_stream)
    check_status(status, "stack_mc")
    return out


def mc_stack(code: Code, lanes: int, frames_per_lane: int, seed: int, param,
             channel: str = "awgn", demapper: str = "soft", device="cuda"
             ) -> torch.Tensor:
    """Run ``lanes * frames_per_lane`` stack-decoded Monte-Carlo frames.

    ``channel``: "awgn" (param = sigma; ``demapper`` "soft" or "hard"
    snap-then-distance) or "bsc" (param = crossover probability).  The seed
    is taken ``& 0x7FFFFFFF``.  Returns per-lane int64 counters [3, lanes]:
    bit errors, frame errors, walk iterations.
    """
    device = torch.device(device)
    if device.type == "cpu":
        return mc_stack_ref(code, lanes, frames_per_lane, seed, param, channel,
                            demapper, device)
    if device.type != "cuda":
        raise ValueError(f"mc_stack runs on CPU or CUDA, got {device}")
    check_args(code, channel, demapper)
    if lanes <= 0 or frames_per_lane <= 0:
        raise ValueError(f"need lanes > 0 and frames_per_lane > 0, got "
                         f"{lanes}, {frames_per_lane}")
    out = _launch(code, lanes, frames_per_lane, seed, param, channel, demapper, device)
    mc_stack.launches += 1
    return out


mc_stack.launches = 0
