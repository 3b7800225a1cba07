"""End-to-end simulation chains as step functions (the modular chain).

Each chain mirrors one reference pipeline:
  * awgn:    random bits → encoder → mapper → +noise → demapper → decoder
             (``AWGN-channel/main.c:80-144``)
  * bsc:     random bits → encoder → bit flips → hard decoder
             (``binary-symmetric-channel/main.c:57-98``)
  * uncoded: random symbols → mapper → +noise → nearest point
             (``uncoded/main.c:77-122``)

A step takes (generator, channel_param) and returns the error counters of
one batch of frames as device scalars.  The randomness comes from the
caller's ``torch.Generator``, which must live on ``device``.  Only the
Viterbi decoder is ported; the stack and Fano decoders raise.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from convolutional_codes_tpu.models.codebook import Code
from convolutional_codes_tpu_torch.ops.channels import awgn, bsc
from convolutional_codes_tpu_torch.ops.demapper import hard_decide, hard_demap, soft_demap
from convolutional_codes_tpu_torch.ops.encoder import encode
from convolutional_codes_tpu_torch.ops.mapper import map_symbols, map_symbols_m
from convolutional_codes_tpu_torch.ops.viterbi import viterbi_decode_hard, viterbi_decode_soft
from convolutional_codes_tpu_torch.utils.bitops import popcount32

CHANNELS = ("awgn", "bsc")
DEMAPPERS = ("soft", "hard")
DECODERS = ("viterbi", "stack", "fano")

#: Reference Fano decode budget in cycles per bit (fano-decoder.c:14).
FANO_TIMEOUT = 10000

StepFn = Callable[[torch.Generator, float], Tuple[torch.Tensor, torch.Tensor, int]]


def check_decoder(decoder: str) -> None:
    """Raise for the decoders that are not ported yet."""
    if decoder == "stack":
        raise NotImplementedError("the stack decoder is not ported yet "
                                  "(ROADMAP Q1 item 9)")
    if decoder == "fano":
        raise NotImplementedError("the Fano decoder is not ported yet "
                                  "(ROADMAP Q1 item 10)")


def make_point_step(code: Code, channel: str, decoder: str,
                    demapper: str = "soft", frames: int = 1024,
                    device="cuda") -> StepFn:
    """Build ``step(generator, param) -> (bit_errors, frame_errors, bits)``
    for one sweep point; ``param`` is the AWGN per-component sigma or the
    BSC crossover probability."""
    if channel not in CHANNELS:
        raise ValueError(f"channel must be one of {CHANNELS}, got {channel!r}")
    if decoder not in DECODERS:
        raise ValueError(f"decoder must be one of {DECODERS}, got {decoder!r}")
    if demapper not in DEMAPPERS:
        raise ValueError(f"demapper must be one of {DEMAPPERS}, got {demapper!r}")
    check_decoder(decoder)
    L, m = code.block_length, code.symlen_out
    device = torch.device(device)

    def step(generator: torch.Generator, param):
        bits = torch.randint(0, 2, (frames, L), generator=generator,
                             dtype=torch.int32, device=device)
        syms = encode(code, bits)
        if channel == "awgn":
            rx = awgn(generator, map_symbols(code, syms), param)
            demap = soft_demap if demapper == "soft" else hard_demap
            dec = viterbi_decode_soft(code, demap(m, rx))
        else:
            dec, _metric = viterbi_decode_hard(code, bsc(generator, syms, param, m))
        errs = dec != bits
        return (errs.sum(dtype=torch.int64), errs.any(dim=-1).sum(dtype=torch.int64),
                frames * L)

    return step


def make_uncoded_step(num_bits: int, frames: int = 1 << 16, device="cuda") -> StepFn:
    """Uncoded baseline: random symbols → map → AWGN → nearest-point
    decision → popcount bit errors (``uncoded/main.c:104-119``).  ``param``
    is the per-component sigma (Es/N0 conversion included)."""
    device = torch.device(device)

    def step(generator: torch.Generator, param):
        syms = torch.randint(0, 1 << num_bits, (frames,), generator=generator,
                             dtype=torch.int32, device=device)
        rx = awgn(generator, map_symbols_m(num_bits, syms), param)
        dec = hard_decide(num_bits, rx)
        return (popcount32(dec ^ syms).sum(), (dec != syms).sum(dtype=torch.int64),
                frames * num_bits)

    return step
