"""Plain stack (ZJ) sequential decoder: a lockstep masked machine over a
batch of frames.

Reference semantics (soft: ``AWGN-channel/stack-decoder.c``, hard:
``binary-symmetric-channel/stack-decoder.c``), as the JAX package's
``ops/stack.py`` and its Monte-Carlo kernel (stack_mc.py:124-231) hold them:
  * a fixed capacity of 64 paths (STACK_DEPTH); below capacity new paths
    append, at capacity the first least-metric path is replaced;
  * per step, the most probable path (first max over live slots) is
    extended by both inputs: the duplicate takes input 1 and is written
    first, the original takes input 0;
  * a path stops being extendable once it has consumed every symbol
    received so far; when the best path has consumed the whole block it is
    emitted;
  * soft branch metric ``1 + metric_weight * dist[esym]`` (product
    rounded), hard ``hamming * wrong + (symlen - hamming) * correct``.

Each micro-step of the machine is one reference step per frame, with the
JAX kernel's chaining: a frame whose best path caught up accepts the next
symbol and extends that same path in the same micro-step (the reference
re-pops the unchanged best path), so the per-frame walk is the reference's.
Metrics are float32 for both channels: hard metrics are small integers,
exact in float32, as in the JAX kernel.

The alias corner — at capacity with every live metric equal, so best and
worst are the same slot — keeps one clean input-0 extension, as the JAX
Monte-Carlo kernel does (stack_pallas.py:190-201), not the C reference's
double extension.  The JAX package's XLA decoder keeps the duplicate's bit
row there instead (the same info bits).  Real frames meet it where a
compat code's quirk zeroes both branches' symbols, so every path keeps the
same metric (``tests/test_torch_fuzz.py``: the bits equal the JAX XLA
decoder's, and the C oracle and the scalar spec part ways there).

Decoded bits are kept unpacked, one uint8 per (frame, slot, symbol).  This
is the plain version of the CUDA kernel in ``csrc/stack_mc.cu`` and the
CPU path of ``ops/stack_mc.py``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from convolutional_codes_tpu_torch.models.codebook import Code
from convolutional_codes_tpu_torch.ops.sequential_common import (
    hard_transition_metrics, make_branch_fn, run_lockstep, soft_transition_metrics)

STACK_DEPTH = 64

_BIG = 3e38


def _first_where(pred: torch.Tensor, slot: torch.Tensor) -> torch.Tensor:
    """Smallest slot index where ``pred`` [B, D] holds, per frame."""
    return torch.where(pred, slot, STACK_DEPTH).amin(dim=1)


def stack_machine(code: Code, symbols: torch.Tensor, soft: bool
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Decode ``[B, T, 2^m]`` float32 distances (soft) or ``[B, T]`` int
    received symbols (hard).  Returns (bits [B, block_length] int32,
    winning path metric [B] float32, micro-steps per frame [B] int64)."""
    B, T, D = symbols.shape[0], code.num_block_symbols, STACK_DEPTH
    dev = symbols.device
    branch = make_branch_fn(code)
    ar = torch.arange(B, device=dev)
    slot = torch.arange(D, device=dev)[None, :]
    one = torch.ones(B, dtype=torch.uint8, device=dev)   # a device value, so a CUDA graph can capture the store
    if not soft:
        symbols = symbols.to(torch.int64)

    nii = torch.zeros((B, D), dtype=torch.int64, device=dev)    # next symbol index
    state = torch.zeros((B, D), dtype=torch.int64, device=dev)
    metric = torch.zeros((B, D), dtype=torch.float32, device=dev)
    bits = torch.zeros((B, D, T), dtype=torch.uint8, device=dev)
    nstack = torch.ones(B, dtype=torch.int64, device=dev)
    widx = torch.ones(B, dtype=torch.int64, device=dev)         # symbols received
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    iters = torch.zeros(B, dtype=torch.int64, device=dev)

    def best_of(metric, live):
        mbest = torch.where(live, metric, -_BIG).amax(dim=1, keepdim=True)
        return _first_where(live & (metric == mbest), slot)

    def micro_step():
        iters.add_((~done).to(torch.int64))
        live = slot < nstack[:, None]
        cur = best_of(metric, live)
        cur_nii = nii[ar, cur]
        caught = cur_nii == widx
        finished = caught & (widx == T)
        advance = caught & (widx < T) & ~done
        widx.copy_(torch.where(advance, widx + 1, widx))
        done.bitwise_or_(finished)
        ext = (~caught | advance) & ~done

        s, m = state[ar, cur], metric[ar, cur]
        t = cur_nii.clamp(0, T - 1)
        ns0, e0 = branch(s, 0)
        ns1, e1 = branch(s, 1)
        if soft:
            tm0, tm1 = soft_transition_metrics(code.metric_weight, symbols[ar, t], e0, e1)
        else:
            tm0, tm1 = hard_transition_metrics(code.bit_metrics, code.symlen_out,
                                               symbols[ar, t], e0, e1)

        at_cap = nstack >= D
        mworst = torch.where(live, metric, _BIG).amin(dim=1, keepdim=True)
        worst = _first_where(live & (metric == mworst), slot)
        new = torch.where(at_cap, worst, nstack)
        newonly = ext & (new != cur)

        # the duplicate (input 1) first, from the original's fields
        row1 = bits[ar, cur]
        row1[ar, t] = one
        bits[ar, new] = torch.where(newonly[:, None], row1, bits[ar, new])
        nii[ar, new] = torch.where(newonly, cur_nii + 1, nii[ar, new])
        state[ar, new] = torch.where(newonly, ns1, state[ar, new])
        metric[ar, new] = torch.where(newonly, m + tm1, metric[ar, new])
        # the original takes input 0 (its bit t stays 0)
        nii[ar, cur] = torch.where(ext, cur_nii + 1, nii[ar, cur])
        state[ar, cur] = torch.where(ext, ns0, state[ar, cur])
        metric[ar, cur] = torch.where(ext, m + tm0, metric[ar, cur])
        nstack.copy_(torch.where(ext & ~at_cap, nstack + 1, nstack))

    run_lockstep(micro_step, done)
    cur = best_of(metric, slot < nstack[:, None])
    return (bits[ar, cur, :code.block_length].to(torch.int32), metric[ar, cur], iters)


def stack_decode_soft(code: Code, distances: torch.Tensor) -> torch.Tensor:
    """``[B, T, 2^m]`` demapper distances → ``[B, block_len]`` decoded bits."""
    return stack_machine(code, distances.to(torch.float32), soft=True)[0]


def stack_decode_hard(code: Code, received: torch.Tensor) -> torch.Tensor:
    """``[B, T]`` received symbols → ``[B, block_len]`` decoded bits."""
    return stack_machine(code, received, soft=False)[0]


def stack_decode_hard_with_metric(code: Code, received: torch.Tensor):
    """Hard stack decode also returning the winning path metric as int32
    (the value the reference's BSC callback carries,
    binary-symmetric-channel/include/decoder.h:9)."""
    bits, metric, _ = stack_machine(code, received, soft=False)
    return bits, metric.to(torch.int32)
