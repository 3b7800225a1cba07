"""PyTorch port, profiling (``utils/profiling.py``) and the sweep's
per-point traces: ``SweepSpec.trace_dir`` and the CLI's ``--trace`` write
one ``torch.profiler`` Chrome trace a point under ``DIR/point_<p>``, each
naming its ``sweep_point_<p>`` annotation; points run side by side (the
sweep x frames grid) each get the shared trace.  On the CPU the traces
hold host activity only; the card's kernels are checked in chip_smoke.py.
The port's own spans and counters: ``test_torch_tracing.py``.
"""

import json

import pytest
import torch

from convolutional_codes_tpu_torch.parallel.mesh import make_mesh
from convolutional_codes_tpu_torch.sim import cli
from convolutional_codes_tpu_torch.sim.sweep import SweepSpec, run_sweep
from convolutional_codes_tpu_torch.utils import profiling

CPU = torch.device("cpu")


def _trace_names(point_dir) -> set:
    """The event names of the one trace file under ``point_dir``."""
    (path,) = point_dir.glob("*.pt.trace.json")
    with open(path) as f:
        return {ev.get("name") for ev in json.load(f)["traceEvents"]}


def test_trace_and_annotate(tmp_path):
    with profiling.trace(None), profiling.annotate("nothing traced"):
        torch.ones(4).sum()
    assert not list(tmp_path.iterdir())
    with profiling.trace(str(tmp_path / "t")), profiling.annotate("region_x"):
        torch.ones(64).cumsum(0)
    assert "region_x" in _trace_names(tmp_path / "t")


@pytest.mark.parametrize("decoder", ["viterbi", "stack"])
def test_sweep_writes_one_trace_a_point(tmp_path, decoder):
    spec = SweepSpec(code=0, channel="bsc", decoder=decoder, points=[0.002, 0.005],
                     frames_per_step=64, bits_per_point=2e3, seed=3, trace_dir=str(tmp_path))
    run_sweep(spec, verbose=False, device="cpu")
    assert sorted(p.name for p in tmp_path.iterdir()) == ["point_0.002", "point_0.005"]
    for p in ("0.002", "0.005"):
        assert f"sweep_point_{p}" in _trace_names(tmp_path / f"point_{p}")


def test_grid_points_share_their_trace(tmp_path):
    """Two points side by side over a sweep axis: one trace, under both
    points' directories, naming both."""
    mesh = make_mesh({"sweep": 2, "frames": 1}, devices=[CPU] * 2)
    spec = SweepSpec(code=0, channel="bsc", points=[0.02, 0.05], frames_per_step=64,
                     bits_per_point=4e3, seed=3, trace_dir=str(tmp_path))
    run_sweep(spec, mesh=mesh, verbose=False, device="cpu")
    for p in ("0.02", "0.05"):
        assert {"sweep_point_0.02", "sweep_point_0.05"} <= _trace_names(tmp_path / f"point_{p}")


def test_cli_trace(tmp_path):
    out = tmp_path / "traces"
    assert cli.main(["awgn", "--cpu", "--code", "0", "--points", "4", "6", "--frames", "64",
                     "--bits-per-point", "1e4", "--trace", str(out)]) == 0
    for p in ("4", "6"):
        assert f"sweep_point_{p}" in _trace_names(out / f"point_{p}")
