"""Shared machinery of the plain sequential decoders (stack, Fano).

Big-constraint codes (WSPR K=32 → 2^31 states) rule out dense trellis
tables, so the sequential decoders evaluate expected symbols from the
encoder state with closed-form register math, compat-parity quirk
included — the JAX package's ``ops/sequential_common.py``.  Register
convention as in ``models/trellis.py``: ``r = state | input << (K-1)``
(newest bit at K-1), successor state ``r >> 1``.  States are int64 holding
32-bit values (CPU torch has no uint32 shifts).

Products are rounded before they are added, as the C reference does: the
soft metric is ``1 + fl(w * d)``.  Eager PyTorch runs ``w * d`` and
``1 + _`` as two operations and never contracts them into an FMA, so the
reference's ``force_rounded`` guard (against XLA-CPU's contraction) is the
identity here and is left out.

The machines advance every frame of a batch by one micro-step at a time
(:func:`run_lockstep`).  The launch plans of the CUDA walks (stack and
Fano) share the card's limits below and :func:`resident_slots`.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Tuple

import torch

from convolutional_codes_tpu_torch.models.codebook import Code
from convolutional_codes_tpu_torch.models.tables import code_tables
from convolutional_codes_tpu_torch.utils import profiling
from convolutional_codes_tpu_torch.utils.bitops import parity32, popcount32

#: shared memory of one H100 SM and the most one block may take, in bytes;
#: every resident block reserves 1 KB more
SMEM_PER_SM, SMEM_PER_BLOCK, SMEM_RESERVED = 233472, 232448, 1024
#: threads per block of any plan of the walks (``kMaxThreads`` in
#: ``csrc/fano_mc.cu`` and ``csrc/stack_mc.cu``), threads and blocks an SM
#: holds at most
MAX_THREADS, THREADS_PER_SM, BLOCKS_PER_SM = 128, 2048, 32


#: coded bits a symbol the walks take (``CC_SEQ_MAX_SYMLEN`` in
#: ``csrc/sequential.cuh``), and the most their narrow instances take
#: (``CC_SEQ_NARROW_SYMLEN``): every registered code; a wider code (5-8
#: bits, 32-256 points) runs the wide instances, whose Monte-Carlo walks
#: keep a frame's received rows instead of its table of T * M metrics
MAX_SYMLEN, NARROW_SYMLEN = 8, 4


def is_wide(code: Code) -> bool:
    """Whether ``code``'s walks run the wide kernel instances."""
    return code.symlen_out > NARROW_SYMLEN


def slot_metric_floats(code: Code) -> int:
    """float32 words of one Monte-Carlo walk's branch metrics in device
    memory: a table of T * M, or T rows of a received point (wide)."""
    T = code.num_block_symbols
    return T * (2 if is_wide(code) else code.points_per_symbol)


def device_points(code: Code, channel: str, device) -> torch.Tensor:
    """The constellation [M, 2] float32 on ``device``, which the wide
    Monte-Carlo walks read at each step (one placeholder word for a narrow
    code or BSC)."""
    if channel != "awgn" or not is_wide(code):
        return torch.zeros(1, dtype=torch.float32, device=device)
    return code_tables(code, device).points.contiguous()


@contextlib.contextmanager
def walk_clock(device):
    """The clock of the Monte-Carlo walk launch enqueued inside the block,
    while a profiler session records: yields the kernels' ``clock`` words
    (``walk_clock_leave`` in ``csrc/sequential.cuh``: the first lane to
    leave on an empty queue, the last lane's exit) and times the launch
    with a pair of CUDA events around it, handed to ``utils/profiling`` as
    the pending counters ``walk_launch_ns`` (the events' interval) and
    ``walk_tail_ns`` (first empty to last exit).  Yields None otherwise,
    which the kernels take as no clock."""
    if not profiling.tracing():
        yield None
        return
    words = torch.zeros(2, dtype=torch.int64, device=device)
    words[0] = -1                                        # ~0 for atomicMin
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    yield words
    end.record()
    profiling.count_later(words, walk_launch_ns=lambda w: round(start.elapsed_time(end) * 1e6),
                          walk_tail_ns=lambda w: w[1] - w[0])


def resident_slots(threads: int, per_slot: int) -> int:
    """Threads one SM holds with blocks of ``threads`` taking ``per_slot``
    shared bytes each (registers aside)."""
    blocks = min(BLOCKS_PER_SM, THREADS_PER_SM // threads,
                 SMEM_PER_SM // (threads * per_slot + SMEM_RESERVED))
    return blocks * threads


#: micro-steps between all-done checks (a done frame's micro-step is a
#: no-op, so overrunning is free and saves a host sync per step)
CHECK_EVERY = 8


def run_lockstep(micro_step: Callable[[], None], done: torch.Tensor) -> None:
    """Run a lockstep machine until every frame of ``done`` [B] is done,
    checking every CHECK_EVERY micro-steps.  ``micro_step`` updates the
    machine's tensors in place and leaves a done frame unchanged.

    On a CUDA device the first CHECK_EVERY micro-steps run eagerly (the
    warm-up of ``torch.cuda.graphs``' recipe) and the next CHECK_EVERY are
    captured into one CUDA graph, which is replayed until every frame is
    done: the same PyTorch operations on the same tensors, without the
    host's launch cost per operation, which sets the lockstep machines'
    pace on the card."""
    if bool(done.all()):
        return
    if done.device.type != "cuda":
        while True:
            for _ in range(CHECK_EVERY):
                micro_step()
            if bool(done.all()):
                return
    with torch.cuda.device(done.device):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(CHECK_EVERY):
                micro_step()
        torch.cuda.current_stream().wait_stream(side)
        if bool(done.all()):
            return
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(CHECK_EVERY):
                micro_step()
        while True:
            graph.replay()
            if bool(done.all()):
                return


def make_branch_fn(code: Code) -> Callable[[torch.Tensor, int],
                                           Tuple[torch.Tensor, torch.Tensor]]:
    """Returns ``branch(state, input_bit) -> (next_state, esym)`` on int64
    tensors of K-1-bit encoder states; symbols pack polynomial 0 at the MSB
    like the encoder."""
    K = code.constraint_length
    tables = code_tables(code)

    def branch(state: torch.Tensor, input_bit: int):
        r = state | (input_bit << (K - 1))
        sym = torch.zeros_like(r)
        for p in tables.polynomials:
            x = r & p
            b = parity32(x)
            if tables.quirk_mask:
                b = b & (1 - parity32(x & tables.quirk_mask))
            sym = (sym << 1) | b
        return r >> 1, sym

    return branch


def soft_transition_metrics(weight: float, dists_row: torch.Tensor,
                            esym0: torch.Tensor, esym1: torch.Tensor):
    """``1 + weight * dist[esym]`` per branch (stack-decoder.c:274,
    fano-decoder.c:309); ``dists_row`` [B, 2^m] float32."""
    w = torch.tensor(float(weight), dtype=torch.float32)
    d0 = dists_row.gather(1, esym0[:, None])[:, 0]
    d1 = dists_row.gather(1, esym1[:, None])[:, 0]
    return 1.0 + w * d0, 1.0 + w * d1


def hard_transition_metrics(bit_metrics, symlen: int, rx_row: torch.Tensor,
                            esym0: torch.Tensor, esym1: torch.Tensor):
    """``hamming * wrong + (symlen - hamming) * correct`` as float32 (small
    integers, exact) — binary-symmetric-channel/stack-decoder.c:267-272."""
    correct, wrong = int(bit_metrics[0]), int(bit_metrics[1])
    h0 = popcount32(esym0 ^ rx_row)
    h1 = popcount32(esym1 ^ rx_row)
    tm0 = h0 * wrong + (symlen - h0) * correct
    tm1 = h1 * wrong + (symlen - h1) * correct
    return tm0.to(torch.float32), tm1.to(torch.float32)
