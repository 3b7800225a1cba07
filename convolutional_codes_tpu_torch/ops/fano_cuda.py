"""Fano decoding of supplied frames on the card: the CUDA kernel of
``csrc/fano_mc.cu`` (``fano_decode_kernel``).

It replaces the TPU kernel ``_fano_kernel`` (fano_pallas.py:52) behind
``fano_decode_pallas`` (:313) and returns what that returns: ``[B,
block_length]`` int32 bits and, with ``with_diag``, the diagnostics of
fano_pallas.py:344-356 — ``metric`` (float32, the node metric where the
walk stopped), ``timeout_left`` and ``depth`` (int32) and ``timed_out``
(``timeout_left == 0``, which includes a frame that finished on its last
budgeted SEARCH step) — plus ``iters`` (int64 walk iterations, as the plain
machine reports them).  A persistent grid takes the frames from a queue
and walks each with the Fano walk that the Monte-Carlo kernel
(``ops/fano_mc.py``) also runs, under the same launch plan
(:func:`ops.fano_mc.fano_plan`), so every output equals the plain
machine's (:func:`ops.fano.fano_machine`) exactly.  The kernel reads the
frames in the layout they come in, ``[B, T, 2^m]`` or ``[B, T]``.  As in
``ops/stack_cuda.py``, the TPU entry's tile and watchdog arguments have no
counterpart: one launch runs every walk to its end, a timed-out frame
``timeout_per_bit * T`` SEARCH steps.

The wrapper takes CUDA tensors only and raises ``ValueError`` otherwise.
Launches are counted in ``fano_decode_cuda.launches``.
"""

from __future__ import annotations

import torch

from convolutional_codes_tpu_torch.models.codebook import Code
from convolutional_codes_tpu_torch.ops.fano import FANO_TIMEOUT
from convolutional_codes_tpu_torch.ops.fano_mc import (
    _lib, _timeout, fano_plan, grid_blocks, node_scratch)
from convolutional_codes_tpu_torch.ops.sequential_common import is_wide
from convolutional_codes_tpu_torch.ops.stack_cuda import check_frames, code_args
from convolutional_codes_tpu_torch.utils.build import check_status


def fano_decode_cuda(code: Code, symbols: torch.Tensor, soft: bool,
                     timeout_per_bit: int = FANO_TIMEOUT, with_diag: bool = False):
    """Fano decode of supplied frames on the card, as ``fano_decode_pallas``:
    decode ``[B, T, 2^m]`` distances (soft) or ``[B, T]`` received symbols
    (hard) on their CUDA device with a budget of ``timeout_per_bit * T``
    SEARCH steps per frame.  Returns ``[B, block_length]`` int32 bits, and
    with ``with_diag`` also the diagnostics {metric, timeout_left, depth,
    timed_out, iters} (the keys of :func:`ops.fano.fano_machine`)."""
    check_frames(code, symbols, soft)
    syms = (symbols.to(torch.float32) if soft else symbols.to(torch.int32)).contiguous()
    timeout = _timeout(code, timeout_per_bit)
    B, dev = symbols.shape[0], symbols.device
    K, L, T, symlen, polys, qmask = code_args(code)
    plan = fano_plan(T)
    blocks = grid_blocks(False, plan, B, dev, is_wide(code))
    nodes = node_scratch(plan, T, blocks * plan.threads, dev)
    bits = torch.empty((B, L), dtype=torch.int32, device=dev)
    metric = torch.empty(B, dtype=torch.float32, device=dev)
    left_depth = torch.empty((2, B), dtype=torch.int32, device=dev)
    iters = torch.empty(B, dtype=torch.int64, device=dev)
    queue = torch.zeros(1, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        status = _lib(is_wide(code)).cc_fano_decode(
            bits.data_ptr(), metric.data_ptr(), left_depth[0].data_ptr(),
            left_depth[1].data_ptr(), iters.data_ptr(), queue.data_ptr(), nodes.data_ptr(),
            syms.data_ptr(), B, int(soft), K, L, T, symlen, polys.ctypes.data, qmask,
            float(code.fano_metric_weight), int(code.fano_bit_metrics[0]),
            int(code.fano_bit_metrics[1]), timeout, int(plan.nodes_shared), plan.threads,
            blocks, plan.smem_bytes, torch.cuda.current_stream().cuda_stream)
    check_status(status, "fano_decode")
    fano_decode_cuda.launches += 1
    if not with_diag:
        return bits
    left, depth = left_depth
    return bits, {"metric": metric, "timeout_left": left, "depth": depth,
                  "timed_out": left == 0, "iters": iters}


fano_decode_cuda.launches = 0
