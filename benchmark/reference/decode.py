"""Plain reference of the decode of supplied frames: the received batches a
run decodes, made from its seed, and their full-frame Viterbi decode.

Batch ``index`` of a run seeded ``seed`` holds the workload's ``frames``
terminated frames.  Frame ``b`` takes its ``info_bits`` info bits from the
counter hash keyed by (the batch's seed, frame ``b``, position, salt 0),
is encoded with the K - 1 zero tail (T = ``info_bits`` + K - 1 symbols),
mapped to the configuration's points and sent through AWGN at the
workload's Eb/N0 (Box-Muller from salts 1 and 2 at each symbol); the
receiver holds the demapper's distances ``[frames, T, M]``
(``common.seq_frames``, the walks' frame maker, with the frame's length).

The decode is ``reference/viterbi.acs_traceback`` over the distances laid
out ``[T, M, B]``: state 0 starts at 0 and the others at ``BIG_METRIC``,
strict-less compares, the traceback from the first least end metric, all
T bits (the tail's included) returned.  Plain torch in the dtype of the
distances; float32 as the configuration states it, or a lower one for the
control.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Tuple

import torch

from benchmark.reference.common import CodeSpec, channel_param, seq_frames
from benchmark.reference.viterbi import acs_traceback


def batch_seed(seed: int, index: int) -> int:
    """The seed of batch ``index`` of the pool of a run seeded ``seed``."""
    digest = hashlib.sha256(f"{int(seed)}:batch:{int(index)}".encode()).digest()
    return int.from_bytes(digest[:4], "little") & 0x7FFFFFFF


def frame_code(code: CodeSpec, wl: dict) -> CodeSpec:
    """The code with the workload's frame: ``info_bits`` info bits a block."""
    return dataclasses.replace(code, block_length=int(wl["info_bits"]))


def frame_symbols(code: CodeSpec, wl: dict) -> int:
    """T: symbols of a frame, the tail's included."""
    return frame_code(code, wl).num_block_symbols


def received_batch(code: CodeSpec, cfg: dict, wl: dict, seed: int, index: int, device,
                   dtype=torch.float32) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sent info bits [frames, info_bits] uint8, received distances
    [frames, T, M] in ``dtype``) of batch ``index``; the channel and the
    demapper in ``dtype``."""
    if cfg["channel"] != "awgn":
        raise ValueError("received frames are soft QPSK distances on AWGN")
    frames = torch.arange(int(wl["frames"]), dtype=torch.int64, device=device)
    bits, dists = seq_frames(frame_code(code, wl), cfg, frames, batch_seed(seed, index),
                             channel_param(cfg, float(wl["point"])), dtype)
    return bits.to(torch.uint8), dists


def decode(code: CodeSpec, dists: torch.Tensor, hard: bool = False) -> torch.Tensor:
    """Decoded bits [B, T] int64 of the distances ``dists`` [B, T, M],
    in their dtype (``hard``: the BSC's saturating metrics)."""
    return acs_traceback(code, dists.permute(1, 2, 0).contiguous(), hard).T


def frames_off(got: torch.Tensor, want: torch.Tensor) -> int:
    """Frames of ``want`` [B, T] that ``got`` does not hold bit for bit: a
    frame that differs in any bit, or is missing from ``got``."""
    if got.dim() != 2 or got.shape[1] != want.shape[1]:
        return int(want.shape[0])
    rows = min(got.shape[0], want.shape[0])
    same = (got[:rows].to(torch.int64) == want[:rows].to(got.device)).all(dim=1)
    return int(want.shape[0] - same.sum())
