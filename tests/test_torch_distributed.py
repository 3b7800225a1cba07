"""PyTorch port, the process-level entry points (``parallel/distributed.py``):
the environment rules of ``initialize_from_env``, a two-process ``gloo``
run on the CPU whose counters equal one process's on the same four slots,
the dry run of every mesh leg and the scaling harness.

Tolerances: exact (integer counters of the same seeds and frame ids).
"""

import numpy as np
import pytest
import torch

from convolutional_codes_tpu_torch.parallel import distributed
from tests import two_process

#: run by each process: 2 CPU slots of its own, 4 in all
WORKER = two_process.JOIN + r"""
import json, sys
import torch
torch.set_num_threads(1)
from convolutional_codes_tpu_torch.models.codebook import get_code
from convolutional_codes_tpu_torch.ops.channels import awgn_sigma
from convolutional_codes_tpu_torch.parallel.mesh import make_mesh
from convolutional_codes_tpu_torch.parallel.montecarlo import (
    frames_accumulate, fused_mc_accumulate, per_device)
from convolutional_codes_tpu_torch.parallel.seq_grid import seq_mc_grid
from convolutional_codes_tpu_torch.sim.chain import make_point_step

n = int(sys.argv[1])
cpu = torch.device("cpu")
code = get_code(0)
frames = make_mesh({"frames": 4}, devices=[cpu] * n)
grid = make_mesh({"sweep": 2, "frames": 2}, devices=[cpu] * n)
build = lambda dev: make_point_step(code, "bsc", "viterbi", frames=64, device=dev)
out = {
    "joined": joined, "world": frames.world, "rank": frames.rank,
    "sharded": frames_accumulate(per_device(build, frames), 2, 11, 0.05, frames),
    "fused": fused_mc_accumulate(code, 1, 12, 0.05, 128, frames, channel="bsc",
                                 device="cpu"),
}
for dec in ("stack", "fano"):
    out[dec] = [[x.tolist() for x in sl[:3]]
                for sl in seq_mc_grid(dec, code, 64, [(1, [13, 14]), (1, [15, 16])],
                                      [0.03, 0.05], grid, channel="bsc", timeout_per_bit=20)]
print(json.dumps(out))
""" + two_process.LEAVE



def test_initialize_noop_without_env(monkeypatch):
    for k in distributed.ENV:
        monkeypatch.delenv(k, raising=False)
    assert distributed.initialize_from_env() is False


def test_initialize_partial_env_raises(monkeypatch):
    """A partly set environment fails loudly: a silent single-process run
    would leave the other processes waiting at their first collective."""
    for k in distributed.ENV:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("RANK", "0")
    with pytest.raises(ValueError, match="WORLD_SIZE"):
        distributed.initialize_from_env()


@pytest.mark.parametrize("local_rank, card", [("3", 3), (None, 1)])
def test_initialize_sets_the_card_before_nccl(monkeypatch, local_rank, card):
    """With cards visible, each process makes its own card current before
    NCCL starts (``LOCAL_RANK``, else the rank modulo the cards), so its
    collectives do not all run on card 0."""
    import torch.distributed as dist

    env = dict(MASTER_ADDR="localhost", MASTER_PORT="29500", WORLD_SIZE="8", RANK="5")
    for k in distributed.ENV:
        monkeypatch.setenv(k, env[k])
    if local_rank is None:
        monkeypatch.delenv("LOCAL_RANK", raising=False)
    else:
        monkeypatch.setenv("LOCAL_RANK", local_rank)
    calls = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: calls.append(("set_device", d)))

    def init(backend, init_method, world_size, rank, device_id=None):
        calls.append(("init", backend, init_method, world_size, rank, device_id))

    monkeypatch.setattr(dist, "init_process_group", init)
    assert distributed.initialize_from_env(verbose=False) is True
    assert calls == [("set_device", card),
                     ("init", "nccl", "tcp://localhost:29500", 8, 5, torch.device("cuda", card))]


def test_two_processes_equal_one():
    """2 processes x 2 slots give the counters of 1 process x 4 slots:
    ``frames_accumulate``, ``fused_mc_accumulate`` and ``seq_mc_grid``
    (stack and Fano), each process running its own slots and the counters
    summed with ``all_reduce``."""
    pair = two_process.Pair(WORKER, 2)    # the two and the one-process run side by side
    ref = two_process.alone(WORKER, 4)
    outs = pair.results()
    assert ref["joined"] is False and ref["world"] == 1
    for rank, got in enumerate(outs):
        assert got["joined"] is True and (got["world"], got["rank"]) == (2, rank)
        for key in ("sharded", "fused", "stack", "fano"):
            assert got[key] == ref[key], (key, rank)
    assert ref["sharded"][0] > 0 and min(ref["stack"][0][0] + ref["stack"][1][0]) > 0


def test_dryrun_multichip():
    torch_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        distributed.dryrun_multichip(4, [torch.device("cpu")] * 4)
        distributed.dryrun_multichip(3, [torch.device("cpu")] * 3)
    finally:
        torch.set_num_threads(torch_threads)


def test_scaling_harness_runs():
    pts = distributed.measure_scaling(frames_per_device=32, nsteps=1, device_counts=[1, 2],
                                      repeats=1, devices=[torch.device("cpu")] * 2)
    assert pts[0].devices == 1 and pts[0].efficiency == 1.0
    for p in pts:
        assert p.bits == p.devices * 32 * 40      # code 0's block length
        assert np.isfinite(p.bits_per_s) and p.bits_per_s > 0
    with pytest.raises(ValueError, match="need 4 devices"):
        distributed.dryrun_multichip(4, [torch.device("cpu")] * 2)
