"""Coordinate-hash Monte-Carlo frame generation for the sequential MC paths
(``ops/stack_mc.py``, ``ops/fano_mc.py``).

One pure function of (seed, global frame id, symbol position) gives a
frame's info bits and channel output — the JAX package's
``ops/mc_datagen.py`` (``make_datagen`` :25, ``frames_host`` :88): info
bits from hash salt 0 (tail rows zero), the shift-register encoder with
the compat quirk, then either Box-Muller AWGN from salts 1 and 2 and the
soft (or snap-then-soft) demapper, or per-coded-bit BSC flips from salts
``1 + k``.  The CUDA kernels generate the same frames in-thread
(``csrc/sequential.cuh``); :func:`frames_cuda` writes those for chosen
frame ids, so the checks can decode exactly what a kernel decoded.

BSC frames are integer-exact everywhere.  AWGN frames go through
log/sqrt/sin/cos, whose last ulp differs between math libraries.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import numpy as np
import torch

from convolutional_codes_tpu_torch.models.codebook import Code
from convolutional_codes_tpu_torch.models.tables import code_tables
from convolutional_codes_tpu_torch.ops.encoder import encode_stream
from convolutional_codes_tpu_torch.ops.fused_chain import awgn_distances, bsc_flip_mask
from convolutional_codes_tpu_torch.ops.fused_longframe import coord_bits, coord_uniform
from convolutional_codes_tpu_torch.utils.build import check_status, load_library

CHANNELS = ("awgn", "bsc")
DEMAPPERS = ("soft", "hard")


def check_args(code: Code, channel: str, demapper: str) -> None:
    """The sequential MC paths take AWGN (soft or hard demapper) or BSC,
    for any symlen_out with a registered constellation: the JAX package's
    ``make_datagen`` builds its stage helpers on every channel, so it too
    raises ``ValueError`` for a width without one, BSC included."""
    if channel not in CHANNELS:
        raise ValueError(f"channel must be one of {CHANNELS}, got {channel!r}")
    if demapper not in DEMAPPERS:
        raise ValueError(f"demapper must be one of {DEMAPPERS}, got {demapper!r}")
    if code_tables(code).points_np is None:
        raise ValueError(f"no constellation for {code.symlen_out} bits/symbol")


def make_datagen(code: Code, T: int, L: int, channel: str, demapper: str):
    """Returns ``gen(gid, seed, param) -> (bits, syms)`` for a 1-D tensor of
    global frame ids: ``bits`` [N, T] int32 (rows >= L zero) and ``syms``
    [N, T, M] float32 demapper distances (AWGN) or [N, T] int32 received
    symbols (BSC), on ``gid``'s device."""
    symlen = code.symlen_out

    def gen(gid: torch.Tensor, seed: int, param) -> Tuple[torch.Tensor, torch.Tensor]:
        tables = code_tables(code, gid.device)
        g = gid.to(torch.int64)[:, None]
        row = torch.arange(T, dtype=torch.int64, device=gid.device)[None, :]
        bits = torch.where(row < L, coord_bits(g, row, seed, 0) & 1, 0)
        esym = encode_stream(code, bits[:, :L]).to(torch.int64)      # [N, T]
        if channel == "awgn":
            u0 = coord_uniform(g, row, seed, 1)
            u1 = coord_uniform(g, row, seed, 2)
            dists = awgn_distances(tables, esym, u0, u1, param, demapper)  # [M, N, T]
            syms = dists.permute(1, 2, 0).contiguous()
        else:
            fmask = bsc_flip_mask(esym, symlen, lambda k: coord_uniform(g, row, seed, 1 + k),
                                  param)
            syms = (esym ^ fmask).to(torch.int32)
        return bits.to(torch.int32), syms

    return gen


def frames_host(code: Code, gids, seed: int, param, channel: str,
                demapper: str = "soft", device="cpu"):
    """The exact frames (bits [N, T], syms) a sequential MC kernel generates
    for global frame ids ``gids``, as plain PyTorch on ``device``; the seed
    is taken ``& 0x7FFFFFFF`` as the kernels take it."""
    check_args(code, channel, demapper)
    gen = make_datagen(code, code.num_block_symbols, code.block_length, channel,
                       demapper)
    gids = torch.as_tensor(gids, dtype=torch.int64, device=device)
    return gen(gids, int(seed) & 0x7FFFFFFF, param)


@functools.lru_cache(maxsize=None)
def _lib():
    lib = load_library("mc_datagen")
    P, I, U, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float
    lib.cc_seq_frames.argtypes = [P, P, P, I, U, F, I, I, I, I, I, I, P, P, U, F, P]
    lib.cc_seq_frames.restype = I
    return lib


def seq_params(code: Code, channel: str, device):
    """Host arrays and scalars every sequential C entry takes: points
    [M, 2] float32 (zeros for BSC), polys [symlen] uint32, quirk mask,
    1/ndist."""
    tables = code_tables(code, device)
    M = code.points_per_symbol
    points = (tables.points_np if channel == "awgn"
              else np.zeros((M, 2), np.float32))
    polys = np.asarray(tables.polynomials, dtype=np.uint32)
    return points, polys, tables.quirk_mask, float(tables.inv_nd or 0.0)


def frames_cuda(code: Code, gids: torch.Tensor, seed: int, param, channel: str,
                demapper: str = "soft"):
    """The frames the CUDA kernels generate for ``gids`` (an int64 CUDA
    tensor), written by the kernels' own device datagen (``cc_seq_frames``);
    same layouts as :func:`frames_host`.  Used by the checks only."""
    check_args(code, channel, demapper)
    if gids.device.type != "cuda":
        raise ValueError(f"frames_cuda takes a CUDA tensor, got {gids.device}")
    T, M = code.num_block_symbols, code.points_per_symbol
    g = gids.to(torch.int32).contiguous()
    N = g.numel()
    bits = torch.empty((N, T), dtype=torch.int32, device=g.device)
    soft = channel == "awgn"
    syms = torch.empty((N, T, M) if soft else (N, T),
                       dtype=torch.float32 if soft else torch.int32, device=g.device)
    points, polys, qmask, inv_nd = seq_params(code, channel, g.device)
    with torch.cuda.device(g.device):
        status = _lib().cc_seq_frames(
            bits.data_ptr(), syms.data_ptr(), g.data_ptr(), N, int(seed) & 0x7FFFFFFF,
            float(param), int(soft), int(demapper == "hard"), code.constraint_length,
            code.block_length, T, code.symlen_out, points.ctypes.data,
            polys.ctypes.data, qmask, inv_nd, torch.cuda.current_stream().cuda_stream)
    check_status(status, "frames_cuda")
    return bits, syms
