"""The sequential Monte-Carlo kernels (``ops/stack_mc.py``, ``ops/fano_mc.py``;
TPU kernels 7 and 8) across a mesh.

The reference's sequential decoders are single-threaded host loops
(``AWGN-channel/{fano,stack}-decoder.c``).  Here each sweep point's global
lane set is split into contiguous blocks, one per slot, and each slot runs
one kernel launch with its block's ``lane0``, so every slot decodes a
distinct block of the SAME global frame-id space: a sharded run gives the
counters of the serial same-seed ``mc_stack``/``mc_fano`` run exactly
(the JAX package's ``parallel/seq_grid.py``).  R points (same lanes and
frames a lane) run side by side on ``slots / R`` slots each, sweep-major
and frames-minor.  The per-lane counters stay on each slot's device until
one host reduction per point in int64.  While a profiler session records
(``utils/profiling.py``), each launch is the span ``mc_launch``, the
reduction and its read to the host ``mc_readback``, and the walks'
iterations (the counters' third row) add to the counter ``walk_iters``.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from convolutional_codes_tpu_torch.models.codebook import Code
from convolutional_codes_tpu_torch.ops.fano import FANO_TIMEOUT
from convolutional_codes_tpu_torch.ops.fano_mc import mc_fano
from convolutional_codes_tpu_torch.ops.stack_mc import mc_stack
from convolutional_codes_tpu_torch.parallel.mesh import Mesh
from convolutional_codes_tpu_torch.utils import profiling


def seq_mc_grid(decoder: str, code: Code, lanes: int, frames_per_lane: int,
                seeds: Sequence[int], params: Sequence[float], mesh: Mesh,
                channel: str = "awgn", demapper: str = "soft",
                timeout_per_bit: int = FANO_TIMEOUT
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Run ``R = len(seeds)`` stack or Fano sweep points across ``mesh``.

    ``lanes`` is the GLOBAL lane count per point; the mesh's slots (in axis
    order) split into R contiguous groups of ``slots / R``, slot ``j`` of
    point ``r``'s group decoding lanes ``[j * Bl, (j + 1) * Bl)``, ``Bl =
    lanes / (slots / R)``, of that point.  Counters equal R serial
    ``mc_stack/mc_fano(code, lanes, frames_per_lane, seeds[r], params[r])``
    runs.  Returns (bit_errors[R], frame_errors[R], bits[R]) int64 arrays.
    """
    if decoder == "fano":
        mc, kw = mc_fano, dict(timeout_per_bit=timeout_per_bit)
    elif decoder == "stack":
        mc, kw = mc_stack, {}
    else:
        raise ValueError(f"not a sequential decoder: {decoder!r}")
    R, ndev = len(seeds), mesh.size
    if len(params) != R:
        raise ValueError("seeds/params length mismatch")
    if ndev % R:
        raise ValueError(f"{R} points do not divide {ndev} devices")
    dpp = ndev // R
    if lanes % dpp:
        raise ValueError(f"lanes {lanes} not divisible by {dpp} devices/point")
    Bl = lanes // dpp
    outs = []
    for k, (dev, rank) in enumerate(mesh.slots()):
        if rank != mesh.rank:
            continue
        r = k // dpp
        with profiling.annotate("mc_launch"):
            out = mc(code, Bl, frames_per_lane, seeds[r], params[r], channel=channel,
                     demapper=demapper, device=dev, lane0=(k % dpp) * Bl, **kw)
        with profiling.annotate("mc_readback"):   # launches only: distinct cards overlap
            outs.append((r, out.sum(dim=1)))
    with profiling.annotate("mc_readback"):
        counts = torch.zeros((3, R), dtype=torch.int64)
        for r, c in outs:   # the host reduction
            counts[:, r] += c.cpu()
        if profiling.tracing():
            profiling.count("walk_iters", counts[2].sum())
        counts = mesh.sum_over_processes(counts)
    bits = np.full(R, lanes * frames_per_lane * code.block_length, np.int64)
    return counts[0].numpy(), counts[1].numpy(), bits
