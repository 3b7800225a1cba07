"""Stack-decoder Monte-Carlo: the CUDA kernel, its plain version, and the
launch plan both stack kernels of ``csrc/stack_mc.cu`` share.

One launch of ``csrc/stack_mc.cu`` runs ``lanes * frames_per_lane``
frames: frame ``gid = (lane0 + g) * frames_per_lane + k`` belongs to lane
``g``, where ``lane0`` (0 on one device) is the launch's first lane in
the point's global lane space, so that devices sharing a point decode
distinct blocks of one frame-id space (``parallel/seq_grid.py``); a
persistent grid takes the frames from a queue, makes each in the warp from
the coordinate hash (``ops/mc_datagen.py``), decodes it with the 64-path
stack search and adds its errors to its lane's counters.  It replaces the
TPU kernel ``_stack_mc_kernel`` (stack_mc.py:84) behind ``mc_stack`` (:419).

Unlike the JAX package's ``mc_stack``, which returns totals, both versions
here return per-lane int64 counters ``[3, lanes]``: bit errors, frame
errors and the walk's iterations (micro-steps of the chained machine,
``ops/stack.py``).  The counters depend on (seed, gid) only, so the plain
version — every frame generated with ``frames_host`` and decoded at once
by the plain machine — gives the kernel's counters: exactly on BSC, and on
AWGN up to the last-ulp differences of log/sqrt/sin/cos between math
libraries.

:func:`stack_plan` picks, from a code's T and K alone, where a walk keeps
its path bits (shared memory or device memory), whether its next-symbol
index and encoder state share one word, and the threads per block.

``mc_stack`` takes a ``device``: CPU runs :func:`mc_stack_ref`, CUDA
launches the kernel (counted in ``mc_stack.launches``) or raises.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from convolutional_codes_tpu_torch.models.codebook import Code
from convolutional_codes_tpu_torch.ops.mc_datagen import check_args, frames_host, seq_params
from convolutional_codes_tpu_torch.ops.sequential_common import (
    MAX_THREADS, SMEM_PER_BLOCK, device_points, is_wide, resident_slots, slot_metric_floats,
    walk_clock)
from convolutional_codes_tpu_torch.ops.stack import STACK_DEPTH, stack_machine
from convolutional_codes_tpu_torch.utils.build import check_status, load_library

#: bytes of path bits the plain machine may hold at once ([frames, 64, T]
#: uint8), which sets how many frames it decodes per pass
_REF_BITS_BYTES = 1 << 26


def count_errors(out: torch.Tensor, lane: torch.Tensor, dec: torch.Tensor,
                 bits: torch.Tensor, iters: torch.Tensor) -> None:
    """Add decoded frames' bit errors, frame errors and walk iterations to
    the per-lane counters ``out`` [3, lanes] at lanes ``lane``."""
    err = (dec != bits[:, :dec.shape[1]]).sum(dim=1)
    out[0].index_add_(0, lane, err)
    out[1].index_add_(0, lane, (err > 0).to(torch.int64))
    out[2].index_add_(0, lane, iters)


def check_lanes(lanes: int, frames_per_lane: int, lane0: int) -> None:
    """A launch's frame ids ``(lane0 + lanes) * frames_per_lane`` must stay
    below 2^31, as the JAX package's int32 ids do."""
    if lanes <= 0 or frames_per_lane <= 0 or lane0 < 0 or \
            (lane0 + lanes) * frames_per_lane >= 2 ** 31:
        raise ValueError(f"need lanes > 0, frames_per_lane > 0, lane0 >= 0 and frame ids "
                         f"below 2^31, got {lanes}, {frames_per_lane}, {lane0}")


def mc_stack_ref(code: Code, lanes: int, frames_per_lane: int, seed: int, param,
                 channel: str = "awgn", demapper: str = "soft", device="cpu",
                 lane0: int = 0) -> torch.Tensor:
    """Plain version of :func:`mc_stack`: the same frames from
    ``frames_host`` (global ids from ``lane0 * frames_per_lane``), decoded
    by the plain lockstep machine in passes of up to ``_REF_BITS_BYTES`` of
    path bits; per-lane counters [3, lanes]."""
    check_args(code, channel, demapper)
    check_lanes(lanes, frames_per_lane, lane0)
    device = torch.device(device)
    N, gid0 = lanes * frames_per_lane, lane0 * frames_per_lane
    per_pass = max(1, _REF_BITS_BYTES // (STACK_DEPTH * code.num_block_symbols))
    out = torch.zeros((3, lanes), dtype=torch.int64, device=device)
    for f0 in range(0, N, per_pass):
        f = torch.arange(f0, min(N, f0 + per_pass), device=device)
        bits, syms = frames_host(code, gid0 + f, seed, param, channel, demapper, device)
        dec, _, iters = stack_machine(code, syms, channel == "awgn")
        count_errors(out, f // frames_per_lane, dec, bits, iters)
    return out


#: shared words of every walk: 64 path metrics, its 8 groups' max and min,
#: and their slots (16 bytes)
ON_CHIP_WORDS = STACK_DEPTH + 16 + 4


@dataclasses.dataclass(frozen=True)
class StackPlan:
    """Where a stack walk keeps its slots, and the block it runs in."""
    threads: int           #: threads per block, a multiple of 32
    smem_bytes: int        #: dynamic shared memory per block
    bits_shared: bool      #: path bits in shared memory (else device memory)
    pack: bool             #: next-symbol index and encoder state in one word


def node_words(pack: bool) -> int:
    """Node words of one walk: 64 slots of one word (``pack``) or two."""
    return STACK_DEPTH * (1 if pack else 2)


def bit_words(T: int, K: int) -> int:
    """Path-bit words of one walk: 64 slots of L = T - K + 1 info bits."""
    return STACK_DEPTH * -(-(T - K + 1) // 32)


def stack_plan(T: int, K: int) -> StackPlan:
    """The launch plan of a walk over frames of ``T`` symbols of a code of
    constraint length ``K``.

    The next-symbol index (up to T) and the K-1-bit encoder state share a
    word where K - 1 + bits(T) <= 32.  The metrics, the group winners and
    the node words are in shared memory; the path bits go there too exactly
    when 32 walks of them fit one block beside the rest.  The threads per
    block are the multiple of 32 up to ``MAX_THREADS`` whose blocks let an
    SM hold the most walks (ties go to the smaller block)."""
    pack = (K - 1) + T.bit_length() <= 32
    on_chip = ON_CHIP_WORDS + node_words(pack)
    shared = 32 * 4 * (on_chip + bit_words(T, K)) <= SMEM_PER_BLOCK
    per_slot = 4 * (on_chip + (bit_words(T, K) if shared else 0))
    fits = [n for n in range(32, MAX_THREADS + 1, 32) if n * per_slot <= SMEM_PER_BLOCK]
    threads = max(fits, key=lambda n: (resident_slots(n, per_slot), -n))
    return StackPlan(threads, threads * per_slot, shared, pack)


def code_plan(code: Code) -> StackPlan:
    """:func:`stack_plan` of ``code``'s frames."""
    return stack_plan(code.num_block_symbols, code.constraint_length)


def walk_scratch(plan: StackPlan, code: Code, slots: int, device) -> torch.Tensor:
    """Path bits of ``slots`` walks in device memory (one placeholder word
    where the plan keeps them in shared memory)."""
    words = bit_words(code.num_block_symbols, code.constraint_length)
    return torch.empty(1 if plan.bits_shared else slots * words, dtype=torch.int32,
                       device=device)


@functools.lru_cache(maxsize=None)
def _lib(wide: bool = False):
    """The library of narrow codes, or its wide build (symlen 5-8,
    ``sequential_common.is_wide``)."""
    lib = load_library("stack_mc_wide" if wide else "stack_mc")
    P, I, U, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float
    lib.cc_stack_occupancy.argtypes = [I, I, I, I, I, P]
    lib.cc_stack_occupancy.restype = I
    lib.cc_mc_stack.argtypes = [P, P, P, P, P, I, I, I, U, F, I, I, I, I, I, I, P, P, U, F, F,
                                I, I, I, I, I, I, I, P, P]
    lib.cc_mc_stack.restype = I
    lib.cc_stack_decode.argtypes = [P, P, P, P, P, P, I, I, I, I, I, I, P, U, F, I, I, I, I,
                                    I, I, I, P]
    lib.cc_stack_decode.restype = I
    return lib


def plan_args(plan: StackPlan):
    """The plan's arguments of a C entry: shared, pack, threads."""
    return int(plan.bits_shared), int(plan.pack), plan.threads


@functools.lru_cache(maxsize=None)
def occupancy(mc: bool, plan: StackPlan, device_index: int, wide: bool = False) -> dict:
    """What the card makes of ``plan`` for the Monte-Carlo kernel (``mc``)
    or the decoder of supplied frames, narrow or ``wide`` instance
    (``sequential_common.is_wide``): resident blocks per SM, SMs,
    registers and local (stack) bytes per thread."""
    info = (ctypes.c_int * 4)()
    with torch.cuda.device(device_index):
        status = _lib(wide).cc_stack_occupancy(int(mc), *plan_args(plan), plan.smem_bytes,
                                               ctypes.addressof(info))
    check_status(status, "stack occupancy")
    if info[0] < 1:
        raise RuntimeError(f"stack plan {plan} leaves no block resident on an SM")
    return {"blocks_per_sm": info[0], "sms": info[1], "registers": info[2],
            "local_bytes": info[3]}


def grid_blocks(mc: bool, plan: StackPlan, frames: int, device: torch.device,
                wide: bool = False) -> int:
    """Blocks of the persistent grid: every resident block, or fewer when
    fewer frames than walks are queued."""
    occ = occupancy(mc, plan, device.index if device.index is not None
                    else torch.cuda.current_device(), wide)
    return min(occ["sms"] * occ["blocks_per_sm"], -(-frames // plan.threads))


def mc_stack(code: Code, lanes: int, frames_per_lane: int, seed: int, param,
             channel: str = "awgn", demapper: str = "soft", device="cuda",
             lane0: int = 0) -> torch.Tensor:
    """Run ``lanes * frames_per_lane`` stack-decoded Monte-Carlo frames.

    ``channel``: "awgn" (param = sigma; ``demapper`` "soft" or "hard"
    snap-then-distance) or "bsc" (param = crossover probability).  The seed
    is taken ``& 0x7FFFFFFF``.  ``lane0`` is the first lane's index in the
    point's global lane space (frames from ``lane0 * frames_per_lane`` on).
    Returns per-lane int64 counters [3, lanes]: bit errors, frame errors,
    walk iterations.
    """
    device = torch.device(device)
    if device.type == "cpu":
        return mc_stack_ref(code, lanes, frames_per_lane, seed, param, channel,
                            demapper, device, lane0)
    if device.type != "cuda":
        raise ValueError(f"mc_stack runs on CPU or CUDA, got {device}")
    check_args(code, channel, demapper)
    check_lanes(lanes, frames_per_lane, lane0)
    T = code.num_block_symbols
    soft = channel == "awgn"
    plan = code_plan(code)
    blocks = grid_blocks(True, plan, lanes * frames_per_lane, device, is_wide(code))
    slots = blocks * plan.threads
    scratch = walk_scratch(plan, code, slots, device)
    tables = torch.empty(slots * slot_metric_floats(code), dtype=torch.float32, device=device)
    dev_points = device_points(code, channel, device)
    out = torch.zeros((3, lanes), dtype=torch.int64, device=device)
    queue = torch.zeros(1, dtype=torch.int32, device=device)
    points, polys, qmask, inv_nd = seq_params(code, channel, device)
    with torch.cuda.device(device), walk_clock(device) as clock:
        status = _lib(is_wide(code)).cc_mc_stack(
            out.data_ptr(), queue.data_ptr(), scratch.data_ptr(), tables.data_ptr(),
            dev_points.data_ptr(), lanes, frames_per_lane, int(lane0),
            int(seed) & 0x7FFFFFFF, float(param), int(soft), int(demapper == "hard"),
            code.constraint_length, code.block_length, T, code.symlen_out, points.ctypes.data, polys.ctypes.data, qmask, inv_nd,
            float(code.metric_weight), int(code.bit_metrics[0]),
            int(code.bit_metrics[1]), *plan_args(plan), blocks, plan.smem_bytes,
            None if clock is None else clock.data_ptr(), torch.cuda.current_stream().cuda_stream)
    check_status(status, "stack_mc")
    mc_stack.launches += 1
    return out


mc_stack.launches = 0
