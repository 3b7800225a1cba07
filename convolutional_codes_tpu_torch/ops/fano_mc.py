"""Fano-decoder Monte-Carlo: the CUDA kernel, its plain version, and the
launch plan both Fano kernels of ``csrc/fano_mc.cu`` share.

One launch of ``csrc/fano_mc.cu`` runs ``lanes * frames_per_lane``
frames: frame ``gid = (lane0 + g) * frames_per_lane + k`` belongs to lane
``g`` (``lane0`` as in ``ops/stack_mc.py``); a
persistent grid takes the frames from a queue, generates each in the
thread from the coordinate hash (``ops/mc_datagen.py``), decodes it with
the Fano walk and adds its errors to its lane's counters.  It replaces the
TPU kernel ``_fano_mc_kernel`` (fano_mc.py:65) behind ``mc_fano`` (:443).

As ``ops/stack_mc.py``: both versions return per-lane int64 counters
``[3, lanes]`` (bit errors, frame errors, walk iterations — micro-steps of
the chained machine, ``ops/fano.py``) instead of the JAX package's totals,
and the plain version gives the kernel's counters, exactly on BSC and on
AWGN up to the last-ulp differences of log/sqrt/sin/cos.

:func:`fano_plan` picks, from a frame's length alone, where a walk keeps
its 16-byte node records (shared memory or device memory) and the threads
per block.

``mc_fano`` takes a ``device``: CPU runs :func:`mc_fano_ref`, CUDA launches
the kernel (counted in ``mc_fano.launches``) or raises.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from convolutional_codes_tpu_torch.models.codebook import Code
from convolutional_codes_tpu_torch.ops.fano import FANO_TIMEOUT, fano_machine
from convolutional_codes_tpu_torch.ops.mc_datagen import check_args, frames_host, seq_params
from convolutional_codes_tpu_torch.ops.sequential_common import (  # noqa: F401 (the plan's limits)
    MAX_THREADS, SMEM_PER_BLOCK, SMEM_PER_SM, SMEM_RESERVED, device_points, is_wide,
    resident_slots, slot_metric_floats, walk_clock)
from convolutional_codes_tpu_torch.ops.stack_mc import check_lanes, count_errors
from convolutional_codes_tpu_torch.utils.build import check_status, load_library

#: frames the plain machine decodes per pass
_REF_FRAMES = 1 << 14


def _timeout(code: Code, timeout_per_bit: int) -> int:
    timeout = int(timeout_per_bit) * code.num_block_symbols
    if not 0 <= timeout < 2 ** 31:
        raise ValueError(f"timeout_per_bit {timeout_per_bit} out of range")
    return timeout


def mc_fano_ref(code: Code, lanes: int, frames_per_lane: int, seed: int, param,
                channel: str = "awgn", demapper: str = "soft",
                timeout_per_bit: int = FANO_TIMEOUT, device="cpu", lane0: int = 0
                ) -> torch.Tensor:
    """Plain version of :func:`mc_fano`: the same frames from
    ``frames_host`` (global ids from ``lane0 * frames_per_lane``), decoded
    by the plain lockstep machine in passes of ``_REF_FRAMES`` frames;
    per-lane counters [3, lanes]."""
    check_args(code, channel, demapper)
    check_lanes(lanes, frames_per_lane, lane0)
    _timeout(code, timeout_per_bit)
    device = torch.device(device)
    N, gid0 = lanes * frames_per_lane, lane0 * frames_per_lane
    out = torch.zeros((3, lanes), dtype=torch.int64, device=device)
    for f0 in range(0, N, _REF_FRAMES):
        f = torch.arange(f0, min(N, f0 + _REF_FRAMES), device=device)
        bits, syms = frames_host(code, gid0 + f, seed, param, channel, demapper, device)
        dec, diag = fano_machine(code, syms, channel == "awgn", timeout_per_bit)
        count_errors(out, f // frames_per_lane, dec, bits, diag["iters"])
    return out


#: threads per block when nothing is in shared memory
GLOBAL_THREADS = 128
#: bytes of one node record: {state | selected << 31, nmetric, m0, m1}
RECORD_BYTES = 16


@dataclasses.dataclass(frozen=True)
class FanoPlan:
    """Where a Fano walk keeps its node records, and the block it runs in."""
    threads: int           #: threads per block, a multiple of 32
    smem_bytes: int        #: dynamic shared memory per block
    nodes_shared: bool     #: node records in shared memory (else device memory)


def fano_plan(T: int) -> FanoPlan:
    """The launch plan of a walk over frames of ``T`` nodes.

    Node records (16 bytes a node) go to shared memory exactly when 32
    slots of them fit one block (T <= 454).  The threads per block are the
    multiple of 32 up to ``MAX_THREADS`` whose blocks let an SM hold the
    most slots (ties go to the smaller block).  Longer frames keep their
    records in device memory, in blocks of ``GLOBAL_THREADS``."""
    per_slot = RECORD_BYTES * T
    if 32 * per_slot > SMEM_PER_BLOCK:
        return FanoPlan(GLOBAL_THREADS, 0, False)
    fits = [n for n in range(32, MAX_THREADS + 1, 32) if n * per_slot <= SMEM_PER_BLOCK]
    threads = max(fits, key=lambda n: (resident_slots(n, per_slot), -n))
    return FanoPlan(threads, threads * per_slot, True)


@functools.lru_cache(maxsize=None)
def _lib(wide: bool = False):
    """The library of narrow codes, or its wide build (symlen 5-8,
    ``sequential_common.is_wide``)."""
    lib = load_library("fano_mc_wide" if wide else "fano_mc")
    P, I, U, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float
    lib.cc_fano_occupancy.argtypes = [I, I, I, I, P]
    lib.cc_fano_occupancy.restype = I
    lib.cc_mc_fano.argtypes = [P, P, P, P, P, I, I, I, U, F, I, I, I, I, I, I, P, P, U, F, F,
                               I, I, I, I, I, I, I, P, P]
    lib.cc_mc_fano.restype = I
    lib.cc_fano_decode.argtypes = [P, P, P, P, P, P, P, P, I, I, I, I, I, I, P, U, F, I, I, I,
                                   I, I, I, I, P]
    lib.cc_fano_decode.restype = I
    return lib


@functools.lru_cache(maxsize=None)
def occupancy(mc: bool, plan: FanoPlan, device_index: int, wide: bool = False) -> dict:
    """What the card makes of ``plan`` for the Monte-Carlo kernel (``mc``)
    or the decoder of supplied frames, narrow or ``wide`` instance
    (``sequential_common.is_wide``): resident blocks per SM, SMs,
    registers and local (stack) bytes per thread."""
    info = (ctypes.c_int * 4)()
    with torch.cuda.device(device_index):
        status = _lib(wide).cc_fano_occupancy(int(mc), int(plan.nodes_shared), plan.threads,
                                              plan.smem_bytes, ctypes.addressof(info))
    check_status(status, "fano occupancy")
    if info[0] < 1:
        raise RuntimeError(f"fano plan {plan} leaves no block resident on an SM")
    return {"blocks_per_sm": info[0], "sms": info[1], "registers": info[2],
            "local_bytes": info[3]}


def grid_blocks(mc: bool, plan: FanoPlan, frames: int, device: torch.device,
                wide: bool = False) -> int:
    """Blocks of the persistent grid: every resident block, or fewer when
    fewer frames than slots are queued."""
    occ = occupancy(mc, plan, device.index if device.index is not None
                    else torch.cuda.current_device(), wide)
    return min(occ["sms"] * occ["blocks_per_sm"], -(-frames // plan.threads))


def node_scratch(plan: FanoPlan, T: int, slots: int, device) -> torch.Tensor:
    """Node records of ``slots`` walks in device memory (one placeholder
    word where the plan keeps them in shared memory)."""
    return torch.empty(1 if plan.nodes_shared else slots * 4 * T, dtype=torch.int32,
                       device=device)


def _launch(code: Code, lanes: int, fpl: int, seed: int, param, channel: str,
            demapper: str, timeout_per_bit: int, device, lane0: int = 0,
            plan: FanoPlan = None) -> torch.Tensor:
    """The kernel's launch under ``fano_plan(T)``, or under ``plan`` where a
    measurement compares plans."""
    T = code.num_block_symbols
    soft, timeout = channel == "awgn", _timeout(code, timeout_per_bit)
    plan = plan or fano_plan(T)
    blocks = grid_blocks(True, plan, lanes * fpl, device, is_wide(code))
    slots = blocks * plan.threads
    nodes = node_scratch(plan, T, slots, device)
    tables = torch.empty(slots * slot_metric_floats(code), dtype=torch.float32, device=device)
    dev_points = device_points(code, channel, device)
    out = torch.zeros((3, lanes), dtype=torch.int64, device=device)
    queue = torch.zeros(1, dtype=torch.int32, device=device)
    points, polys, qmask, inv_nd = seq_params(code, channel, device)
    with torch.cuda.device(device), walk_clock(device) as clock:
        status = _lib(is_wide(code)).cc_mc_fano(
            out.data_ptr(), queue.data_ptr(), nodes.data_ptr(), tables.data_ptr(),
            dev_points.data_ptr(), lanes, fpl,
            int(lane0), int(seed) & 0x7FFFFFFF, float(param), int(soft), int(demapper == "hard"),
            code.constraint_length, code.block_length, T, code.symlen_out,
            points.ctypes.data, polys.ctypes.data, qmask, inv_nd,
            float(code.fano_metric_weight), int(code.fano_bit_metrics[0]),
            int(code.fano_bit_metrics[1]), timeout, int(plan.nodes_shared),
            plan.threads, blocks, plan.smem_bytes, None if clock is None else clock.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    check_status(status, "fano_mc")
    mc_fano.launches += 1
    return out


def mc_fano(code: Code, lanes: int, frames_per_lane: int, seed: int, param,
            channel: str = "awgn", demapper: str = "soft",
            timeout_per_bit: int = FANO_TIMEOUT, device="cuda", lane0: int = 0
            ) -> torch.Tensor:
    """Run ``lanes * frames_per_lane`` Fano-decoded Monte-Carlo frames.

    ``channel``: "awgn" (param = sigma; ``demapper`` "soft" or "hard"
    snap-then-distance) or "bsc" (param = crossover probability);
    ``timeout_per_bit`` sets the budget of ``timeout_per_bit * T`` SEARCH
    steps per frame.  The seed is taken ``& 0x7FFFFFFF``.  ``lane0`` is the
    first lane's index in the point's global lane space.  Returns per-lane
    int64 counters [3, lanes]: bit errors, frame errors, walk iterations.
    """
    device = torch.device(device)
    if device.type == "cpu":
        return mc_fano_ref(code, lanes, frames_per_lane, seed, param, channel,
                           demapper, timeout_per_bit, device, lane0)
    if device.type != "cuda":
        raise ValueError(f"mc_fano runs on CPU or CUDA, got {device}")
    check_args(code, channel, demapper)
    check_lanes(lanes, frames_per_lane, lane0)
    return _launch(code, lanes, frames_per_lane, seed, param, channel, demapper,
                   timeout_per_bit, device, lane0)


mc_fano.launches = 0
