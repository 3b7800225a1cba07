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
caller's ``torch.Generator``, which must live on ``device``.  Every
decoder runs its CUDA kernels on a card and its plain version on the CPU:
Viterbi through ``ops/viterbi.py``, the stack and Fano decoders on the
demapper's float distances (AWGN) or the received int symbols (BSC)
through ``ops/stack_cuda.py`` and ``ops/fano_cuda.py`` (TPU kernels 9-10)
or the plain machines of ``ops/stack.py`` and ``ops/fano.py``.  The sweep's
stack/Fano Monte-Carlo leg does not use this chain (``ops/stack_mc.py``,
``ops/fano_mc.py``).
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from convolutional_codes_tpu_torch.models.codebook import Code
from convolutional_codes_tpu_torch.ops.channels import awgn, bsc
from convolutional_codes_tpu_torch.ops.demapper import hard_decide, hard_demap, soft_demap
from convolutional_codes_tpu_torch.ops.encoder import encode
from convolutional_codes_tpu_torch.ops.fano import FANO_TIMEOUT, fano_decode_hard, fano_decode_soft
from convolutional_codes_tpu_torch.ops.fano_cuda import fano_decode_cuda
from convolutional_codes_tpu_torch.ops.mapper import map_symbols, map_symbols_m
from convolutional_codes_tpu_torch.ops.stack import stack_decode_hard, stack_decode_soft
from convolutional_codes_tpu_torch.ops.stack_cuda import stack_decode_cuda
from convolutional_codes_tpu_torch.ops.viterbi import viterbi_decode_hard, viterbi_decode_soft
from convolutional_codes_tpu_torch.utils.bitops import popcount32

CHANNELS = ("awgn", "bsc")
DEMAPPERS = ("soft", "hard")
DECODERS = ("viterbi", "stack", "fano")

StepFn = Callable[[torch.Generator, float], Tuple[torch.Tensor, torch.Tensor, int]]


def _sequential_decoder(code: Code, decoder: str, soft: bool, timeout_per_bit: int,
                        device: torch.device):
    """``decode(x) -> bits`` of the stack or Fano decoder: the kernel on a
    CUDA device, the plain machine elsewhere."""
    cuda = device.type == "cuda"
    if decoder == "stack":
        if cuda:
            return lambda x: stack_decode_cuda(code, x, soft)
        return lambda x: (stack_decode_soft if soft else stack_decode_hard)(code, x)
    if cuda:
        return lambda x: fano_decode_cuda(code, x, soft, timeout_per_bit)
    fano = fano_decode_soft if soft else fano_decode_hard
    return lambda x: fano(code, x, timeout_per_bit)


def make_point_step(code: Code, channel: str, decoder: str,
                    demapper: str = "soft", frames: int = 1024,
                    timeout_per_bit: int = FANO_TIMEOUT, device="cuda") -> StepFn:
    """Build ``step(generator, param) -> (bit_errors, frame_errors, bits)``
    for one sweep point; ``param`` is the AWGN per-component sigma or the
    BSC crossover probability; ``timeout_per_bit`` is the Fano budget."""
    if channel not in CHANNELS:
        raise ValueError(f"channel must be one of {CHANNELS}, got {channel!r}")
    if decoder not in DECODERS:
        raise ValueError(f"decoder must be one of {DECODERS}, got {decoder!r}")
    if demapper not in DEMAPPERS:
        raise ValueError(f"demapper must be one of {DEMAPPERS}, got {demapper!r}")
    L = code.block_length
    device = torch.device(device)
    if decoder == "viterbi":
        decode_soft = lambda x: viterbi_decode_soft(code, x)
        decode_hard = lambda x: viterbi_decode_hard(code, x)[0]
    else:
        decode_soft = _sequential_decoder(code, decoder, True, timeout_per_bit, device)
        decode_hard = _sequential_decoder(code, decoder, False, timeout_per_bit, device)

    def step(generator: torch.Generator, param):
        bits, rx = chain_frames(code, channel, frames, generator, param, demapper)
        dec = (decode_soft if channel == "awgn" else decode_hard)(rx)
        errs = dec != bits
        return (errs.sum(dtype=torch.int64), errs.any(dim=-1).sum(dtype=torch.int64),
                frames * L)

    return step


def chain_frames(code: Code, channel: str, frames: int, generator: torch.Generator,
                 param, demapper: str = "soft") -> Tuple[torch.Tensor, torch.Tensor]:
    """The frames of one step of :func:`make_point_step`, drawn from the
    generator on its device: (info bits [frames, block_length] int32, the
    decoder's input: demapped AWGN distances [frames, T, 2^m] float32 or
    received BSC symbols [frames, T])."""
    bits = torch.randint(0, 2, (frames, code.block_length), generator=generator,
                         dtype=torch.int32, device=generator.device)
    syms = encode(code, bits)
    if channel == "awgn":
        rx = awgn(generator, map_symbols(code, syms), param)
        return bits, (soft_demap if demapper == "soft" else hard_demap)(code.symlen_out, rx)
    return bits, bsc(generator, syms, param, code.symlen_out)


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
