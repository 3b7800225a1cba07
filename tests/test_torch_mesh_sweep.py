"""PyTorch port, the sweep and CLI on a mesh of repeated CPU slots: twins of
tests/test_sweep.py:63-87,179-240 (the frames axis's scale, the two-axis
grid, grid sweeps equal to frames-only sweeps, mixed-tier leftovers) for
the fused, modular and sequential legs, and ``--cpu --mesh``.

Tolerances: grid against serial exactly (every leg derives the serial
leg's seeds); BER within the clustered binomial |z| < 4 of
tests/test_sweep.py.
"""

import numpy as np
import pytest
import torch

from convolutional_codes_tpu_torch.models.codebook import get_code
from convolutional_codes_tpu_torch.parallel.mesh import make_mesh
from convolutional_codes_tpu_torch.sim import cli
from convolutional_codes_tpu_torch.sim.sweep import SweepSpec, run_sweep
from convolutional_codes_tpu_torch.utils.records import read_jsonl

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """One intra-op thread: float32 transcendentals on tensors of more than
    2048 elements (ROADMAP Q3)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _mesh(shape):
    return make_mesh(shape, devices=[CPU] * int(np.prod(list(shape.values()))))


def _counters(recs):
    return [(r.point, r.bits, r.bit_errors, r.frame_errors) for r in recs]


def test_frames_mesh_scales_the_bits():
    """Each slot of the frames axis adds a chunk's bits; BER stays
    consistent with code 0's BSC curve at p = 0.05."""
    spec = SweepSpec(code=0, channel="bsc", decoder="viterbi", points=[0.05],
                     frames_per_step=256, bits_per_point=8 * 1024 * 40 * 2, seed=7)
    (r,) = run_sweep(spec, mesh=_mesh({"frames": 8}), verbose=False)
    assert r.bits == 8 * 1024 * 40 * 2 and r.warm_bits == 8 * 1024 * 40
    cluster = max(1.0, r.bit_errors / r.frame_errors)
    p = 0.1208
    assert abs(r.bit_errors - r.bits * p) <= 4 * np.sqrt(cluster * r.bits * p * (1 - p)) + 1


@pytest.mark.parametrize("spec_kw", [
    dict(code=0, channel="awgn", points=(4.0, 6.0, 8.0, 10.0), frames_per_step=64,
         bits_per_point=4 * 1024 * 40),                                    # fused
    dict(code=get_code("k3-75").replace(name="k3-75-long", block_length=300),
         channel="bsc", points=(0.02, 0.05), frames_per_step=32,
         bits_per_point=4 * 32 * 300 * 2),                                 # modular
    dict(code=0, channel="uncoded", points=(2.0, 4.0), frames_per_step=512,
         bits_per_point=4 * 512 * 2 * 3)])                                 # uncoded
def test_run_sweep_grid_matches_serial(spec_kw):
    """A sweep×frames grid gives the frames-only sweep's counters."""
    spec = SweepSpec(seed=3, **spec_kw)
    grid = run_sweep(spec, mesh=_mesh({"sweep": 2, "frames": 4}), verbose=False)
    serial = run_sweep(spec, mesh=_mesh({"frames": 4}), verbose=False)
    assert _counters(grid) == _counters(serial)
    assert sum(r.bit_errors for r in grid) > 0


def test_run_sweep_grid_leftovers_mixed_tiers():
    """Odd groups: a grid batch takes two points of one step count, the
    third runs on the frames axis alone; records come in point order."""
    spec = SweepSpec(code=0, channel="bsc", decoder="viterbi", points=(0.0125, 0.05, 0.1),
                     frames_per_step=64, seed=5, base_bits=1024 * 40 * 4 * 10)
    grid = run_sweep(spec, mesh=_mesh({"sweep": 2, "frames": 4}), verbose=False)
    serial = run_sweep(spec, mesh=_mesh({"frames": 4}), verbose=False)
    assert [r.point for r in grid] == [0.0125, 0.05, 0.1]
    assert _counters(grid) == _counters(serial)


@pytest.mark.parametrize("decoder,shape,points,kw", [
    ("stack", {"sweep": 2, "frames": 2}, (0.02, 0.04), {}),
    ("fano", {"frames": 2}, (0.03,), {"timeout_per_bit": 20}),
    ("stack", {"frames": 3}, (0.02,), {})])
def test_sequential_mesh_equals_serial(decoder, shape, points, kw):
    """Stack/Fano points over every slot (lane0 blocks of each point's
    frame ids) give the mesh-less sweep's counters; where no grouping of
    the slots divides the lanes (3 slots, 1024 lanes) the point runs on
    the first slot alone."""
    spec = SweepSpec(code=0, channel="bsc", decoder=decoder, points=points,
                     bits_per_point=1024 * 40, seed=21, **kw)
    on_mesh = run_sweep(spec, mesh=_mesh(shape), verbose=False)
    serial = run_sweep(spec, verbose=False, device="cpu")
    assert _counters(on_mesh) == _counters(serial)
    assert all(r.bit_errors > 0 and r.decoder == decoder for r in on_mesh)


def test_cli_cpu_mesh(tmp_path):
    out = tmp_path / "bsc.jsonl"
    rc = cli.main(["bsc", "--code", "0", "--cpu", "--mesh", "sweep=2,frames=2",
                   "--points", "0.05", "0.1", "--frames", "1024",
                   "--bits-per-point", str(2 * 1024 * 40), "--jsonl", str(out)])
    assert rc == 0
    rows = read_jsonl(str(out))
    spec = SweepSpec(code=0, channel="bsc", points=(0.05, 0.1), frames_per_step=1024,
                     bits_per_point=2 * 1024 * 40)
    serial = run_sweep(spec, mesh=_mesh({"frames": 2}), verbose=False)
    assert [(r["point"], r["bits"], r["bit_errors"], r["frame_errors"]) for r in rows] == \
        _counters(serial)
