"""PyTorch port, the chunked legs of ``run_sweep`` (``sim/sweep._chunked``):
a point of several chunks enqueues every chunk's launches back to back,
keeps their counters on the device and reads them once, after the last
launch.  The record equals the sum of the same launches called one by one
with the chunk seeds (bits and ``warm_bits`` included), the warm rate is
``warm_bits / warm_wall_s``, and on one slot or on a ``frames`` mesh every
leg's point makes its launches, then one read (``mc_reads`` = 1) and, on a
mesh, one sum over processes.

A point here is 4 chunks of 2 steps: the tests shrink the chunk by patching
``sweep.CHUNK_BITS``, as ``test_torch_stream_sweep.py`` does, since at its
real size a chunk of the fused leg's least 1,024 lanes holds 26,214 steps,
which the CPU's plain versions cannot run four times over in a test.

Tolerances: counters exactly (the same launches with the same seeds).
"""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from convolutional_codes_tpu_torch.models.codebook import get_code
from convolutional_codes_tpu_torch.parallel import montecarlo, streaming
from convolutional_codes_tpu_torch.parallel.mesh import Mesh, make_mesh
from convolutional_codes_tpu_torch.sim import sweep
from convolutional_codes_tpu_torch.sim.sweep import SweepSpec, _chunk_seed, run_sweep
from convolutional_codes_tpu_torch.utils import profiling

CPU = torch.device("cpu")
CHUNKS, STEPS, SEED = 4, 2, 3_000_000_019
LONG = get_code("k3-75").replace(name="k3-75-long", block_length=300)   # T > 256: modular

#: leg: (the spec's settings, info bits a step on one slot, where its launches go)
LEGS = {
    "fused": (dict(code=0, points=[0.05], frames_per_step=1024), 1024 * 40,
              (montecarlo, "mc_chain_viterbi")),
    "stream": (dict(code="nasa-k7", points=[0.03], frames_per_step=64, stream_window=32,
                    stream_warmup=16), 64 * 32, (streaming, "mc_longframe_viterbi")),
    "modular": (dict(code=LONG, points=[0.03], frames_per_step=4), 4 * 300,
                (sweep, "make_point_step")),
    "uncoded": (dict(code=0, channel="uncoded", points=[4.0], frames_per_step=256), 256 * 2,
                (sweep, "make_uncoded_step")),
}


@pytest.fixture(autouse=True)
def _no_counters():
    profiling.reset_counters()
    yield
    profiling.reset_counters()


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """One intra-op thread: beside other test workers, more turn the plain
    versions' small tensor ops a hundredfold slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _point(leg: str, monkeypatch, slots: int = 1) -> SweepSpec:
    """A one-point spec of ``leg`` whose point runs CHUNKS chunks of STEPS
    steps on each of ``slots`` slots of a ``frames`` mesh (a stream chunk's
    windows are split over them instead)."""
    kw, step_bits, _ = LEGS[leg]
    monkeypatch.setattr(sweep, "CHUNK_BITS", STEPS * step_bits)
    bits = CHUNKS * STEPS * step_bits * (1 if leg == "stream" else slots)
    return SweepSpec(**dict(dict(channel="bsc"), **kw), seed=SEED, bits_per_point=bits)


def _chunk_counts(leg: str, ci: int):
    """The per-lane counters of chunk ``ci``, called alone."""
    seed = _chunk_seed(SEED, 0, ci)
    if leg == "fused":
        return montecarlo.mc_chain_viterbi(get_code(0), 1024, STEPS, seed, 0.05, "bsc",
                                           device="cpu")
    return streaming.mc_longframe_viterbi(get_code("nasa-k7"), 64, STEPS, seed, 0.03, "bsc",
                                          window=32, warmup=16, device="cpu")


@pytest.mark.parametrize("leg", ["fused", "stream"])
def test_the_record_is_the_sum_of_its_chunks(leg, monkeypatch):
    (rec,) = run_sweep(_point(leg, monkeypatch), verbose=False, device="cpu")
    be = fe = 0
    for ci in range(CHUNKS):
        b, f = _chunk_counts(leg, ci)
        be, fe = be + int(b.sum()), fe + int(f.sum())
    bits, chunk_bits = CHUNKS * STEPS * LEGS[leg][1], STEPS * LEGS[leg][1]
    assert (rec.bit_errors, rec.frame_errors, rec.bits, rec.warm_bits) == \
        (be, fe, bits, bits - chunk_bits)
    assert be > 0
    assert 0 < rec.warm_wall_s and rec.bits_per_s == rec.warm_bits / rec.warm_wall_s


def _log_launches(leg: str, events: list, monkeypatch) -> None:
    """Log each kernel launch, or each step of a step chain, in ``events``."""
    module, name = LEGS[leg][2]
    inner = getattr(module, name)
    if name.startswith("mc_"):
        def launch(*a, **k):
            events.append("launch")
            return inner(*a, **k)
    else:
        def launch(*a, **k):
            step = inner(*a, **k)
            return lambda *sa: events.append("launch") or step(*sa)
    monkeypatch.setattr(module, name, launch)


@pytest.mark.parametrize("slots", [1, 2])
@pytest.mark.parametrize("leg", sorted(LEGS))
def test_a_point_reads_its_counters_once(leg, slots, monkeypatch):
    """Traced, a point of CHUNKS chunks on ``slots`` slots makes CHUNKS x
    ``slots`` launches (a step chain: CHUNKS x STEPS x ``slots`` steps),
    then one blocking read (``mc_reads`` = 1: the slots share the CPU),
    then, on a mesh, one sum over processes."""
    spec, events = _point(leg, monkeypatch, slots), []
    _log_launches(leg, events, monkeypatch)
    count, total = montecarlo.count, Mesh.sum_over_processes
    monkeypatch.setattr(montecarlo, "count", lambda n, v: events.append(n) or count(n, v))
    monkeypatch.setattr(Mesh, "sum_over_processes",
                        lambda mesh, c: events.append("sum") or total(mesh, c))
    mesh = make_mesh({"frames": slots}, devices=[CPU] * slots) if slots > 1 else None
    with profile(activities=[ProfilerActivity.CPU]):
        (rec,) = run_sweep(spec, mesh=mesh, verbose=False, device="cpu")
    launches = CHUNKS * slots * (STEPS if leg in ("modular", "uncoded") else 1)
    assert events == ["launch"] * launches + ["mc_reads"] + ["sum"] * (slots > 1)
    assert profiling.counters()["mc_reads"] == 1
    assert rec.bits == spec.bits_per_point
