"""Stack decoding of supplied frames on the card: the CUDA kernel of
``csrc/stack_mc.cu`` (``stack_decode_kernel``).

It replaces the TPU kernel ``_stack_kernel`` (stack_pallas.py:86) behind
``stack_decode_pallas`` (:338) and returns what that returns: ``[B,
block_length]`` int32 bits and, with ``with_metric``, the winning path
metric per frame (float32 soft, int32 hard, stack_pallas.py:334).  A
persistent grid takes the frames from a queue and walks each with the
64-path stack search that the Monte-Carlo kernel (``ops/stack_mc.py``) also
runs, under the same launch plan (:func:`ops.stack_mc.stack_plan`), so
bits, metric and iterations equal the plain machine's
(:func:`ops.stack.stack_machine`) exactly.  The kernel reads the frames in
the layout they come in, ``[B, T, 2^m]`` or ``[B, T]``.  The TPU entry's
tile and watchdog arguments (``block_lanes``, ``iters_per_call``,
``iters_first``, ``max_calls``, ``interpret``) have no counterpart: one
launch runs every walk to its end.

The wrappers take CUDA tensors only and raise ``ValueError`` otherwise;
the plain machine is the CPU's decoder (``sim/chain.py`` picks by device).
Launches are counted in ``stack_machine_cuda.launches``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from convolutional_codes_tpu_torch.models.codebook import Code
from convolutional_codes_tpu_torch.models.tables import code_tables
from convolutional_codes_tpu_torch.ops.sequential_common import MAX_SYMLEN, is_wide
from convolutional_codes_tpu_torch.ops.stack_mc import (
    _lib, code_plan, grid_blocks, plan_args, walk_scratch)
from convolutional_codes_tpu_torch.utils.build import check_status


def check_frames(code: Code, symbols: torch.Tensor, soft: bool) -> None:
    """Raise ``ValueError`` unless ``symbols`` are supplied frames the
    sequential kernels take: ``soft`` ``[B >= 1, T, 2^m]`` distances or
    hard ``[B >= 1, T]`` symbols of a code with symlen_out <= 8 (every
    width the JAX package's constellations and decoders take), on a CUDA
    device."""
    if code.symlen_out > MAX_SYMLEN:
        raise ValueError(f"the kernels take symlen_out <= {MAX_SYMLEN}; "
                         f"{code.name} has {code.symlen_out}")
    T, M = code.num_block_symbols, code.points_per_symbol
    want = (T, M) if soft else (T,)
    if symbols.dim() != 1 + len(want) or tuple(symbols.shape[1:]) != want \
            or symbols.shape[0] < 1:
        raise ValueError(f"{code.name} {'soft' if soft else 'hard'} frames must be [B >= 1, "
                         f"{', '.join(map(str, want))}], got {tuple(symbols.shape)}")
    if symbols.device.type != "cuda":
        raise ValueError(f"the kernels take CUDA tensors, got {symbols.device}")


def code_args(code: Code):
    """(K, L, T, symlen, polys [symlen] uint32 host array, quirk mask): the
    code's arguments of a C decode entry."""
    tables = code_tables(code)
    polys = np.asarray(tables.polynomials, dtype=np.uint32)
    return (code.constraint_length, code.block_length, code.num_block_symbols,
            code.symlen_out, polys, tables.quirk_mask)


def stack_machine_cuda(code: Code, symbols: torch.Tensor, soft: bool
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kernel's twin of :func:`ops.stack.stack_machine`: decode ``[B, T,
    2^m]`` distances (soft) or ``[B, T]`` received symbols (hard) on their
    CUDA device.  Returns (bits [B, block_length] int32, winning path metric
    [B] float32, walk iterations [B] int64)."""
    check_frames(code, symbols, soft)
    syms = (symbols.to(torch.float32) if soft else symbols.to(torch.int32)).contiguous()
    B, dev = symbols.shape[0], symbols.device
    K, L, T, symlen, polys, qmask = code_args(code)
    plan = code_plan(code)
    blocks = grid_blocks(False, plan, B, dev, is_wide(code))
    scratch = walk_scratch(plan, code, blocks * plan.threads, dev)
    bits = torch.empty((B, L), dtype=torch.int32, device=dev)
    metric = torch.empty(B, dtype=torch.float32, device=dev)
    iters = torch.empty(B, dtype=torch.int64, device=dev)
    queue = torch.zeros(1, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        status = _lib(is_wide(code)).cc_stack_decode(
            bits.data_ptr(), metric.data_ptr(), iters.data_ptr(), queue.data_ptr(),
            scratch.data_ptr(), syms.data_ptr(), B, int(soft), K, L, T, symlen,
            polys.ctypes.data, qmask, float(code.metric_weight), int(code.bit_metrics[0]),
            int(code.bit_metrics[1]), *plan_args(plan), blocks, plan.smem_bytes,
            torch.cuda.current_stream().cuda_stream)
    check_status(status, "stack_decode")
    stack_machine_cuda.launches += 1
    return bits, metric, iters


stack_machine_cuda.launches = 0


def stack_decode_cuda(code: Code, symbols: torch.Tensor, soft: bool,
                      with_metric: bool = False):
    """Stack decode of supplied frames on the card, as
    ``stack_decode_pallas``: ``[B, block_length]`` int32 bits, and with
    ``with_metric`` the winning metric [B] (float32 soft, int32 hard)."""
    bits, metric, _ = stack_machine_cuda(code, symbols, soft)
    if not with_metric:
        return bits
    return bits, (metric if soft else metric.to(torch.int32))
