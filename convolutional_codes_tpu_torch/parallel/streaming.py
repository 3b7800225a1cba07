"""Long-frame Viterbi on one device: the exact decode of supplied frames of
any length, and the long-frame Monte-Carlo accumulation.

The reference's decoders are data-driven: they consume supplied distance
vectors through ``decoder_input`` (``AWGN-channel/include/decoder.h:17-26``)
in blocks of at most ~200 bits.  :func:`long_frame_decode_stream` decodes
frames of any length exactly — the same bits as the monolithic decode,
:func:`monolithic_reference_decode` — through the streaming kernels of
:mod:`ops.longframe_cuda` on a CUDA tensor, or their plain versions on a
CPU tensor.  :func:`streaming_mc_accumulate` is the Monte-Carlo side: one
fused long-frame kernel call (``ops/fused_longframe.py``).

The JAX package also shards these over a ``seq`` mesh axis (halo
exchange, time-range sharding); meshes are not ported yet (ROADMAP Q1
item 14).
"""

from __future__ import annotations

from typing import Tuple

import torch

from convolutional_codes_tpu_torch.models.codebook import Code
from convolutional_codes_tpu_torch.ops.fused_longframe import mc_longframe_viterbi
from convolutional_codes_tpu_torch.ops.longframe_cuda import (
    stream_acs_cuda, stream_traceback_cuda)
from convolutional_codes_tpu_torch.ops.viterbi import (
    BIG_METRIC, HARD_METRIC_SAT, acs_forward, initial_metrics, traceback_from)
from convolutional_codes_tpu_torch.utils.bitops import first_argmin


def long_frame_decode_stream(code: Code, dists, hard: bool = False) -> torch.Tensor:
    """Exact decode of ``[B, T, M]`` distance streams (any T): returns
    ``[B, T]`` int32 decoded bits, the K-1 tail bits included.  ``hard``
    selects the BSC's 0xFF00-saturating metrics.

    Start metrics pin state 0 (the encoder's start state); the traceback
    starts from the first state of least final metric — the reference's
    global-min rule (``viterbi-decoder.c:71-90``, which does not force end
    state 0 despite tail termination).
    """
    d_tmb = torch.as_tensor(dists).to(torch.float32).permute(1, 2, 0).contiguous()
    S, B = code.num_states, d_tmb.shape[2]
    init = torch.full((S, B), float(HARD_METRIC_SAT) if hard else BIG_METRIC,
                      dtype=torch.float32, device=d_tmb.device)
    init[0] = 0.0
    fm, dec = stream_acs_cuda(code, d_tmb, init, hard)
    bits, _ = stream_traceback_cuda(code, dec, first_argmin(fm, dim=0).to(torch.int32))
    return bits.T.contiguous()


def monolithic_reference_decode(code: Code, dists) -> torch.Tensor:
    """Single-pass plain soft decode of ``[B, T, M]`` streams from the
    state-0-pinned start (ground truth for the streaming paths)."""
    dists = torch.as_tensor(dists).to(torch.float32)
    init = initial_metrics(code, dists.shape[0], False, dists.device)
    final_metrics, decisions = acs_forward(code, dists, False, init)
    return traceback_from(code, decisions, first_argmin(final_metrics, dim=-1))


def streaming_mc_accumulate(code: Code, lanes: int, windows: int, seed, param,
                            channel: str = "awgn", demapper: str = "soft",
                            window: int = 1920, warmup: int = 128, mesh=None,
                            device="cuda") -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Long-frame Monte-Carlo: ``lanes`` coded streams, ``windows`` windows
    each, in one :func:`mc_longframe_viterbi` call from window 0, seeded
    with ``seed & 0x7FFFFFFF``.  Returns (bit_errors [lanes], window_errors
    [lanes], simulated info bits ``lanes * windows * window``)."""
    if mesh is not None:
        raise NotImplementedError("meshes are not ported yet (ROADMAP Q1 item 14)")
    be, we = mc_longframe_viterbi(code, lanes, windows, int(seed) & 0x7FFFFFFF, param,
                                  channel, demapper, window, warmup, 0, device)
    return be, we, lanes * windows * window
