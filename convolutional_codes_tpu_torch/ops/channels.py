"""Channel models over ``torch.Generator`` streams.

The reference adds ``scaling * gengauss()`` per I/Q component
(``AWGN-channel/main.c:99-102``) and flips each coded bit with the
crossover probability (``binary-symmetric-channel/main.c:61-68``).  Here
the noise comes from a caller-owned ``torch.Generator`` on the tensor's
device: a distribution-level contract, not a bitstream one.
"""

from __future__ import annotations

import math

import torch


def awgn_sigma(ebn0_db, info_bits_per_symbol: float = 1.0) -> torch.Tensor:
    """Per-component noise std dev for a unit-power constellation, float32:
    ``1/sqrt(2) * 10^(-EbN0dB/20) / sqrt(info_bits_per_symbol)``.

    The coded chains carry 1 info bit per channel symbol, so Eb = Es
    (``AWGN-channel/main.c:153-161``); the uncoded chain carries
    symlen_out bits per symbol (``uncoded/main.c:150-153``).  The power is
    taken in float64 and rounded once to float32, which gives the same
    float32 as the reference package on every 0.05 dB step of [-20, 40].
    """
    exponent = -torch.as_tensor(ebn0_db, dtype=torch.float32) / 20.0
    scale = torch.pow(10.0, exponent.to(torch.float64)).to(torch.float32)
    return (torch.tensor(1.0 / math.sqrt(2.0), dtype=torch.float32) * scale
            / torch.tensor(math.sqrt(info_bits_per_symbol), dtype=torch.float32))


def awgn(generator: torch.Generator, iq: torch.Tensor, sigma) -> torch.Tensor:
    """Add N(0, sigma^2) per I/Q component; ``sigma`` broadcasts against
    ``iq``."""
    noise = torch.randn(iq.shape, generator=generator, dtype=iq.dtype,
                        device=iq.device)
    return iq + torch.as_tensor(sigma, dtype=iq.dtype, device=iq.device) * noise


def bsc(generator: torch.Generator, symbols: torch.Tensor, crossover,
        num_bits: int) -> torch.Tensor:
    """Flip each of the ``num_bits`` coded bits of each symbol independently
    with probability ``crossover``."""
    u = torch.rand(symbols.shape + (num_bits,), generator=generator,
                   dtype=torch.float32, device=symbols.device)
    flips = (u < torch.as_tensor(crossover, dtype=torch.float32,
                                 device=symbols.device)).to(symbols.dtype)
    weights = 1 << torch.arange(num_bits, dtype=symbols.dtype,
                                device=symbols.device)
    return symbols ^ (flips * weights).sum(-1).to(symbols.dtype)
