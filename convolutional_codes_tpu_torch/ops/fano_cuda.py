"""Fano decoding of supplied frames on the card: the CUDA kernel of
``csrc/fano_mc.cu`` (``fano_decode_kernel``).

It replaces the TPU kernel ``_fano_kernel`` (fano_pallas.py:52) behind
``fano_decode_pallas`` (:313) and returns what that returns: ``[B,
block_length]`` int32 bits and, with ``with_diag``, the diagnostics of
fano_pallas.py:344-356 — ``metric`` (float32, the node metric where the
walk stopped), ``timeout_left`` and ``depth`` (int32) and ``timed_out``
(``timeout_left == 0``, which includes a frame that finished on its last
budgeted SEARCH step) — plus ``iters`` (int64 walk iterations, as the plain
machine reports them).  One thread walks one frame with the Fano walk that
the Monte-Carlo kernel (``ops/fano_mc.py``) also runs, so every output
equals the plain machine's (:func:`ops.fano.fano_machine`) exactly.  As in
``ops/stack_cuda.py``, the TPU entry's tile and watchdog arguments have no
counterpart: one launch runs every walk to its end, a timed-out frame
``timeout_per_bit * T`` SEARCH steps.

The wrapper takes CUDA tensors only and raise ``ValueError`` otherwise.
Launches are counted in ``fano_decode_cuda.launches``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from convolutional_codes_tpu_torch.models.codebook import Code
from convolutional_codes_tpu_torch.ops.fano import FANO_TIMEOUT
from convolutional_codes_tpu_torch.ops.fano_mc import _timeout
from convolutional_codes_tpu_torch.ops.stack_cuda import code_args, supplied_frames
from convolutional_codes_tpu_torch.utils.build import check_status, load_library


@functools.lru_cache(maxsize=None)
def _lib():
    lib = load_library("fano_mc")
    P, I, U, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float
    lib.cc_fano_scratch_words.argtypes = [I, I]
    lib.cc_fano_scratch_words.restype = ctypes.c_longlong
    lib.cc_fano_decode.argtypes = [P, P, P, P, P, P, P, I, I, I, I, I, I, P, U, F, I, I, I, P]
    lib.cc_fano_decode.restype = I
    return lib


def fano_decode_cuda(code: Code, symbols: torch.Tensor, soft: bool,
                     timeout_per_bit: int = FANO_TIMEOUT, with_diag: bool = False):
    """Fano decode of supplied frames on the card, as ``fano_decode_pallas``:
    decode ``[B, T, 2^m]`` distances (soft) or ``[B, T]`` received symbols
    (hard) on their CUDA device with a budget of ``timeout_per_bit * T``
    SEARCH steps per frame.  Returns ``[B, block_length]`` int32 bits, and
    with ``with_diag`` also the diagnostics {metric, timeout_left, depth,
    timed_out, iters} (the keys of :func:`ops.fano.fano_machine`)."""
    syms = supplied_frames(code, symbols, soft)
    timeout = _timeout(code, timeout_per_bit)
    lib = _lib()
    B, dev = symbols.shape[0], symbols.device
    K, L, T, symlen, polys, qmask = code_args(code)
    bits = torch.empty((L, B), dtype=torch.int32, device=dev)
    metric = torch.empty(B, dtype=torch.float32, device=dev)
    left_depth = torch.empty((2, B), dtype=torch.int32, device=dev)
    iters = torch.empty(B, dtype=torch.int64, device=dev)
    scratch = torch.empty(lib.cc_fano_scratch_words(T, B), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        status = lib.cc_fano_decode(
            bits.data_ptr(), metric.data_ptr(), left_depth[0].data_ptr(),
            left_depth[1].data_ptr(), iters.data_ptr(), scratch.data_ptr(), syms.data_ptr(),
            B, int(soft), K, L, T, symlen, polys.ctypes.data, qmask,
            float(code.fano_metric_weight), int(code.fano_bit_metrics[0]),
            int(code.fano_bit_metrics[1]), timeout, torch.cuda.current_stream().cuda_stream)
    check_status(status, "fano_decode")
    fano_decode_cuda.launches += 1
    if not with_diag:
        return bits.T
    left, depth = left_depth
    return bits.T, {"metric": metric, "timeout_left": left, "depth": depth,
                    "timed_out": left == 0, "iters": iters}


fano_decode_cuda.launches = 0
