"""Fano-decoder Monte-Carlo: the CUDA kernel and its plain version.

One launch of ``csrc/fano_mc.cu`` runs ``lanes * frames_per_lane``
frames: lane ``g`` decodes frames ``gid = g * frames_per_lane + k`` with
the Fano walk, generating each in the thread from the coordinate hash
(``ops/mc_datagen.py``) and banking its errors.  It replaces the TPU
kernel ``_fano_mc_kernel`` (fano_mc.py:65) behind ``mc_fano`` (:443).

As ``ops/stack_mc.py``: both versions return per-lane int64 counters
``[3, lanes]`` (bit errors, frame errors, walk iterations — micro-steps of
the chained machine, ``ops/fano.py``) instead of the JAX package's totals,
and the plain version gives the kernel's counters, exactly on BSC and on
AWGN up to the last-ulp differences of log/sqrt/sin/cos.

``mc_fano`` takes a ``device``: CPU runs :func:`mc_fano_ref`, CUDA launches
the kernel (counted in ``mc_fano.launches``) or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from convolutional_codes_tpu_torch.models.codebook import Code
from convolutional_codes_tpu_torch.ops.fano import FANO_TIMEOUT, fano_machine
from convolutional_codes_tpu_torch.ops.mc_datagen import check_args, frames_host, seq_params
from convolutional_codes_tpu_torch.ops.stack_mc import count_errors
from convolutional_codes_tpu_torch.utils.build import check_status, load_library

#: frames the plain machine decodes per pass
_REF_FRAMES = 1 << 14


def _timeout(code: Code, timeout_per_bit: int) -> int:
    timeout = int(timeout_per_bit) * code.num_block_symbols
    if not 0 <= timeout < 2 ** 31:
        raise ValueError(f"timeout_per_bit {timeout_per_bit} out of range")
    return timeout


def mc_fano_ref(code: Code, lanes: int, frames_per_lane: int, seed: int, param,
                channel: str = "awgn", demapper: str = "soft",
                timeout_per_bit: int = FANO_TIMEOUT, device="cpu") -> torch.Tensor:
    """Plain version of :func:`mc_fano`: the same frames from
    ``frames_host``, decoded by the plain lockstep machine in passes of
    ``_REF_FRAMES`` frames; per-lane counters [3, lanes]."""
    check_args(code, channel, demapper)
    _timeout(code, timeout_per_bit)
    device = torch.device(device)
    N = lanes * frames_per_lane
    out = torch.zeros((3, lanes), dtype=torch.int64, device=device)
    for g0 in range(0, N, _REF_FRAMES):
        gids = torch.arange(g0, min(N, g0 + _REF_FRAMES), device=device)
        bits, syms = frames_host(code, gids, seed, param, channel, demapper, device)
        dec, diag = fano_machine(code, syms, channel == "awgn", timeout_per_bit)
        count_errors(out, gids // frames_per_lane, dec, bits, diag["iters"])
    return out


@functools.lru_cache(maxsize=None)
def _lib():
    lib = load_library("fano_mc")
    P, I, U, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float
    lib.cc_fano_scratch_words.argtypes = [I, I]
    lib.cc_fano_scratch_words.restype = ctypes.c_longlong
    lib.cc_mc_fano.argtypes = [P, P, P, I, I, U, F, I, I, I, I, I, I, P, P, U, F, F, I,
                               I, I, P]
    lib.cc_mc_fano.restype = I
    return lib


def _launch(code: Code, lanes: int, fpl: int, seed: int, param, channel: str,
            demapper: str, timeout_per_bit: int, device) -> torch.Tensor:
    lib = _lib()
    T, M = code.num_block_symbols, code.points_per_symbol
    soft = channel == "awgn"
    syms = torch.empty((T, M, lanes) if soft else (T, lanes),
                       dtype=torch.float32 if soft else torch.int32, device=device)
    scratch = torch.empty(lib.cc_fano_scratch_words(T, lanes), dtype=torch.int32,
                          device=device)
    out = torch.empty((3, lanes), dtype=torch.int64, device=device)
    points, polys, qmask, inv_nd = seq_params(code, channel, device)
    with torch.cuda.device(device):
        status = lib.cc_mc_fano(
            out.data_ptr(), scratch.data_ptr(), syms.data_ptr(), lanes, fpl,
            int(seed) & 0x7FFFFFFF, float(param), int(soft), int(demapper == "hard"),
            code.constraint_length, code.block_length, T, code.symlen_out,
            points.ctypes.data, polys.ctypes.data, qmask, inv_nd,
            float(code.fano_metric_weight), int(code.fano_bit_metrics[0]),
            int(code.fano_bit_metrics[1]), _timeout(code, timeout_per_bit),
            torch.cuda.current_stream().cuda_stream)
    check_status(status, "fano_mc")
    return out


def mc_fano(code: Code, lanes: int, frames_per_lane: int, seed: int, param,
            channel: str = "awgn", demapper: str = "soft",
            timeout_per_bit: int = FANO_TIMEOUT, device="cuda") -> torch.Tensor:
    """Run ``lanes * frames_per_lane`` Fano-decoded Monte-Carlo frames.

    ``channel``: "awgn" (param = sigma; ``demapper`` "soft" or "hard"
    snap-then-distance) or "bsc" (param = crossover probability);
    ``timeout_per_bit`` sets the budget of ``timeout_per_bit * T`` SEARCH
    steps per frame.  The seed is taken ``& 0x7FFFFFFF``.  Returns per-lane
    int64 counters [3, lanes]: bit errors, frame errors, walk iterations.
    """
    device = torch.device(device)
    if device.type == "cpu":
        return mc_fano_ref(code, lanes, frames_per_lane, seed, param, channel,
                           demapper, timeout_per_bit, device)
    if device.type != "cuda":
        raise ValueError(f"mc_fano runs on CPU or CUDA, got {device}")
    check_args(code, channel, demapper)
    if lanes <= 0 or frames_per_lane <= 0:
        raise ValueError(f"need lanes > 0 and frames_per_lane > 0, got "
                         f"{lanes}, {frames_per_lane}")
    out = _launch(code, lanes, frames_per_lane, seed, param, channel, demapper,
                  timeout_per_bit, device)
    mc_fano.launches += 1
    return out


mc_fano.launches = 0
