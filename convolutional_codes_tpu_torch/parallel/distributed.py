"""Multi-process initialisation, the mesh layer's cost, and the dry run.

The reference is a single process with no distributed story.  This module
is the process-level entry point of the port's mesh layer:

  * :func:`initialize_from_env` — ``torch.distributed.init_process_group``
    from torchrun's variables (``MASTER_ADDR``, ``MASTER_PORT``,
    ``WORLD_SIZE``, ``RANK``); after it, :func:`make_mesh` lays every
    process's devices out as one mesh, each process running its own slots
    and the counters summed with ``all_reduce``.
  * :func:`measure_scaling` — runs the same per-slot workload on 1..N-slot
    ``frames`` meshes and reports decoded bits/s, the efficiency against
    the first point's per-slot rate and every repeat's wall.  On slots that repeat one
    card it measures what the mesh layer costs on the host, not scaling.
  * :func:`dryrun_multichip` — every mesh leg once at tiny shapes.
"""

from __future__ import annotations

import inspect
import os
import time
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from convolutional_codes_tpu_torch.parallel.mesh import default_devices, local_card, make_mesh

#: torchrun's variables, all of which a multi-process run sets
ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")


def initialize_from_env(verbose: bool = True) -> bool:
    """Join the process group that the environment describes.

    Returns True when ``init_process_group`` ran (NCCL where a card is
    visible, else gloo).  With NCCL the process first makes its own card
    (:func:`local_card`) the current one: every collective runs on the
    current card, and ranks that all stayed on card 0 would share it.  With none of :data:`ENV` set it does nothing and
    returns False, so a program may always call it first; with some set and
    others not it raises, since a silent single-process run would leave
    the other processes waiting at their first collective.
    """
    env = {name: os.environ.get(name) for name in ENV}
    if not any(env.values()):
        return False
    missing = [k for k, v in env.items() if not v]
    if missing:
        raise ValueError(
            f"partial multi-process environment: {missing} unset while "
            f"{[k for k, v in env.items() if v]} set — a silent single-process "
            f"run here would leave the other processes waiting at their first "
            f"collective")
    import torch.distributed as dist

    rank, kw = int(env["RANK"]), {}
    if torch.cuda.is_available():
        card = local_card(rank)
        torch.cuda.set_device(card)
        if "device_id" in inspect.signature(dist.init_process_group).parameters:
            kw["device_id"] = torch.device("cuda", card)
    dist.init_process_group(
        backend="nccl" if torch.cuda.is_available() else "gloo",
        init_method=f"tcp://{env['MASTER_ADDR']}:{env['MASTER_PORT']}",
        world_size=int(env["WORLD_SIZE"]), rank=rank, **kw)
    if verbose:
        print(f"torch.distributed: process {dist.get_rank()}/{dist.get_world_size()}, "
              f"backend {dist.get_backend()}", flush=True)
    return True


@dataclass
class ScalingPoint:
    devices: int
    bits: int
    wall_s: float
    bits_per_s: float
    efficiency: float       # vs the first point's per-slot bits/s
    walls: Tuple[float, ...] = ()   # every repeat's wall, ascending: the spread


def measure_scaling(code=None, frames_per_device: int = 512, nsteps: int = 4,
                    snr_db: float = 8.0, device_counts: Optional[List[int]] = None,
                    repeats: int = 3, devices=None) -> List[ScalingPoint]:
    """Weak scaling of the sharded modular Viterbi chain
    (``frames_accumulate`` over ``make_point_step``): each slot simulates
    ``frames_per_device * nsteps`` frames per run, on ``frames`` meshes of
    the first ``d`` of ``devices`` (default: every visible card) for each
    ``d`` in ``device_counts``.  The wall of each point is the best of
    ``repeats`` runs after one warm-up run; ``walls`` keeps them all."""
    from convolutional_codes_tpu_torch.models.codebook import get_code
    from convolutional_codes_tpu_torch.ops.channels import awgn_sigma
    from convolutional_codes_tpu_torch.parallel.montecarlo import (
        frames_accumulate, per_device)
    from convolutional_codes_tpu_torch.sim.chain import make_point_step

    code = code if code is not None else get_code(0)
    devices = list(default_devices() if devices is None else devices)
    counts = device_counts or [d for d in (1, 2, 4, 8, 16, 32) if d <= len(devices)]
    sigma = float(awgn_sigma(snr_db))
    out: List[ScalingPoint] = []
    for d in counts:
        mesh = make_mesh({"frames": d}, devices=devices[:d])
        step = per_device(lambda dev: make_point_step(code, "awgn", "viterbi", "soft",
                                                      frames_per_device, device=dev), mesh)
        frames_accumulate(step, nsteps, d, sigma, mesh)     # warm-up
        walls, bits = [], 0
        for r in range(repeats):
            t0 = time.perf_counter()
            _, _, bits = frames_accumulate(step, nsteps, d * 1000 + r + 1, sigma, mesh)
            walls.append(time.perf_counter() - t0)   # the counters are host ints
        best = min(walls)
        rate = bits / best
        eff = rate / (out[0].bits_per_s / out[0].devices * d) if out else 1.0
        out.append(ScalingPoint(d, bits, best, rate, eff, tuple(sorted(walls))))
    return out


def dryrun_multichip(n_devices: int, devices=None) -> None:
    """Every mesh leg once at tiny shapes over ``n_devices`` slots of
    ``devices`` (default: every visible card): the sweep×frames grid (the
    step accumulation, ``run_sweep``'s grid mode and the fused kernel's
    grid), the frames-sharded fused kernel, both sequential kernels over
    lane0 blocks, and the ``seq``-sharded long-frame legs."""
    from convolutional_codes_tpu_torch.models.codebook import get_code
    from convolutional_codes_tpu_torch.ops.channels import awgn_sigma
    from convolutional_codes_tpu_torch.parallel.montecarlo import (
        frames_accumulate, fused_grid_accumulate, fused_mc_accumulate, per_device,
        sweep_grid_accumulate)
    from convolutional_codes_tpu_torch.parallel.seq_grid import seq_mc_grid
    from convolutional_codes_tpu_torch.parallel.streaming import dryrun_streaming
    from convolutional_codes_tpu_torch.sim.chain import make_point_step
    from convolutional_codes_tpu_torch.sim.sweep import SweepSpec, run_sweep

    devs = list(default_devices() if devices is None else devices)[:n_devices]
    if len(devs) != n_devices:
        raise ValueError(f"need {n_devices} devices, have {len(devs)}")

    def check(cond, what):
        if not cond:
            raise RuntimeError(f"dryrun_multichip({n_devices}): {what}")

    code = get_code(0)
    L = code.block_length
    build = lambda dev: make_point_step(code, "awgn", "viterbi", "soft", frames=8, device=dev)
    fmesh = make_mesh({"frames": n_devices}, devices=devs)
    if n_devices % 2 == 0 and n_devices > 1:
        mesh = make_mesh({"sweep": 2, "frames": n_devices // 2}, devices=devs)
        params = [float(awgn_sigma(s)) for s in (4.0, 8.0)]
        be, fe, nb = sweep_grid_accumulate(per_device(build, mesh), 1, 0, params, mesh)
        check(be.shape == (2,) and int(nb.sum()) == n_devices * 8 * L, "sweep grid")
        spec = SweepSpec(code=0, channel="awgn", decoder="viterbi", points=(4.0, 8.0),
                         frames_per_step=8, bits_per_point=8 * L * (n_devices // 2), seed=1)
        recs = run_sweep(spec, mesh=mesh, verbose=False)
        check(len(recs) == 2 and all(r.bits > 0 for r in recs), "run_sweep grid")
        seeds = np.arange(n_devices, dtype=np.int64).reshape(2, -1)
        gb, _, gn = fused_grid_accumulate(code, 1, seeds, params, 128, mesh, channel="awgn")
        check(gb.shape == (2,) and int(gn.sum()) == n_devices * 128 * L, "fused grid")
    else:
        mesh = fmesh
        _, _, nb = frames_accumulate(per_device(build, mesh), 1, 0,
                                     float(awgn_sigma(8.0)), mesh)
        check(nb == n_devices * 8 * L, "sharded accumulate")

    be, _, nb = fused_mc_accumulate(code, 1, 7, float(awgn_sigma(8.0)), 128, fmesh,
                                    channel="awgn")
    check(nb == n_devices * 128 * L and 0 <= be <= nb, "fused frames mesh")

    if n_devices % 2 == 0 and n_devices > 1:   # both sequential kernels, two points
        sigma = float(awgn_sigma(6.0))
        for decoder in ("fano", "stack"):
            (cold,) = seq_mc_grid(decoder, code, n_devices * 4, [(1, [3, 4])], [sigma, sigma],
                                  mesh, channel="awgn", timeout_per_bit=20)
            check(int(cold.bits.sum()) == 2 * n_devices * 4 * L, f"{decoder} grid")

    dryrun_streaming(n_devices, devs)
    print(f"dryrun_multichip({n_devices}): ok on mesh {mesh.shape}")


def main() -> None:
    initialize_from_env()
    pts = measure_scaling()
    print(f"{'devices':>8} {'bits':>12} {'wall_s':>9} {'bits/s':>12} {'efficiency':>10}")
    for p in pts:
        print(f"{p.devices:>8} {p.bits:>12} {p.wall_s:>9.4f} "
              f"{p.bits_per_s:>12.4g} {p.efficiency:>10.3f}")


if __name__ == "__main__":
    main()
