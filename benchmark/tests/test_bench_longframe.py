"""The long-frame cell ``k7-longframe-6db`` at CPU size: a sound run reads
every check at 0; a broken kernel under the tap, and the reference in
bfloat16 in the program's place, read above 0; the roofline of kernel 6
stays at or below 100% and is silent without the program's counters."""

from __future__ import annotations

import json
import random

import pytest
import torch

from benchmark import run as bench_run
from benchmark.loops import stream_points
from benchmark.reference import longframe as ref
from benchmark.reference.common import CodeSpec
from benchmark.tests.helpers import ROOT, checkout, load
from benchmark.tests.test_bench_faults import altered, half_left_out, unchanged
from benchmark.yardstick import longframe_ops, peaks

import convolutional_codes_tpu_torch.parallel.streaming as streaming

CELL = "k7-longframe-6db"
#: the cell cut to CPU size: 64 streams, windows of 64 + 2 x 32 symbols, 8
#: windows a point (a cold launch of 1, then 7), every lane of both
#: launches compared; 2 dB, so that the sampled lanes hold errors
TINY = {"frames_per_step": 64, "window": 64, "warmup": 32, "bits_per_point": 64 * 64 * 8,
        "point": 2.0, "sample": {"points": 1, "launches": 2, "lanes": 0}}


def tiny_checkout(tmp_path):
    root = checkout(tmp_path)
    path = root / "benchmark" / "workloads" / f"{CELL}.json"
    wl = json.loads(path.read_text())
    wl.update(TINY)
    path.write_text(json.dumps(wl))
    return root


def test_a_sound_run_reads_every_check_at_zero(tmp_path):
    root = tiny_checkout(tmp_path)
    out = bench_run.run(CELL, 2 ** 31 + 77, 0.1, False, root=root, device="cpu")
    assert out["correct"], out["checks"]
    assert set(out["checks"]) == set(stream_points.CHECKS)
    assert all(c["value"] == 0 for c in out["checks"].values())
    assert out["metrics"]["info_bits_per_s"]["value"] > 0


@pytest.mark.parametrize("fault", [unchanged, half_left_out, altered])
def test_a_broken_kernel_is_not_correct(fault, tmp_path, monkeypatch):
    inner = streaming.mc_longframe_viterbi
    monkeypatch.setattr(streaming, "mc_longframe_viterbi",
                        lambda *a, **k: fault(inner(*a, **k)))
    root = tiny_checkout(tmp_path)
    out = bench_run.run(CELL, 2 ** 32 + 9, 0.1, False, root=root, device="cpu")
    assert not out["correct"], out["checks"]
    assert out["checks"]["lanes_off"]["value"] > 0


def test_the_control_fails_the_check(tmp_path):
    """The reference in bfloat16 in the program's place, on three seeds."""
    cfg, wl = load(tiny_checkout(tmp_path), CELL)
    for seed in (1, 2, 3):
        got = stream_points.control_readings(cfg, wl, seed, torch.device("cpu"),
                                             torch.bfloat16)
        assert got["lanes_off"] > wl["limits"]["lanes_off"], got


def test_the_plan_is_the_cells():
    """The cell's point: 4 launches of 8 windows of 65,536 lanes, 15/16 of
    2^30 bits each, each with a seed of its own."""
    cfg, wl = load(ROOT, CELL)
    plan = ref.launches(CodeSpec.from_config(cfg), wl, 5)
    assert [(la.lanes, la.steps) for la in plan] == [(65536, 8)] * 4
    assert ref.launch_bits(wl, plan) == int(wl["bits_per_point"]) == 4 * (1 << 30) * 15 // 16
    assert len({la.seed for la in plan}) == 4


def context(points, kernels):
    cfg, wl = load(ROOT, CELL)
    return bench_run.TraceContext(cfg, wl, CodeSpec.from_config(cfg), [{}] * points,
                                  [(0.0, 1e3)] * points, kernels, [])


def test_the_roofline_never_passes_100_and_is_silent_without_counters():
    """Busy for exactly the least time of the counted work, the share is
    100%; any longer, less.  Without the counters (the parent's program),
    or without kernels, nothing."""
    cfg, wl = load(ROOT, CELL)
    code = CodeSpec.from_config(cfg)
    mod = bench_run.load_module(ROOT / "benchmark" / "metrics" / "longframe_mc_roofline_pct.py",
                                "test_metric_longframe")
    W, Wn = int(wl["warmup"]), int(wl["window"])
    rng = random.Random(3)
    for points in (1, 2, 7):
        plan = ref.launches(code, wl, 0) * points
        counters = {"stream_windows": sum(la.lanes * la.steps for la in plan),
                    "stream_positions": sum(longframe_ops.launch_positions(
                        la.lanes, la.steps, Wn, W) for la in plan)}
        ops = longframe_ops.stream_ops(code, cfg["channel"], counters["stream_positions"],
                                       counters["stream_windows"], Wn, W)
        least = peaks.least_seconds(ops, sum(8 * la.lanes for la in plan))
        for stretch in (1.0, 1.0 + rng.random(), 10.0):
            got = mod.read(context(points, [("k", 0.0, least * stretch)]), counters)
            assert 0 < got <= 100 * (1 + 1e-9)
            assert got == pytest.approx(100.0 / stretch)
        for missing in ({}, {"stream_windows": 0, "stream_positions": 0}):
            assert mod.read(context(points, [("k", 0.0, least)]), missing) is None
        assert mod.read(context(points, []), counters) is None


def test_the_readers_the_cell_reports_are_in_the_manifest():
    """Kernel 6's roofline, the new reader, is the cell's alone; the
    device's idle share and the host's three readers of the sweep layer
    list the cell beside the cells they had."""
    m = bench_run.validate_manifest(ROOT)
    entries = {x["name"]: x for x in m["per_layer"]}
    mod = bench_run.load_module(ROOT / "benchmark" / "metrics" / "longframe_mc_roofline_pct.py",
                                "test_metric_longframe_roofline")
    x = entries["longframe_mc_roofline_pct"]
    assert (mod.LAYER, mod.MOVES, mod.SOURCE) == (x["layer"], x["moves"], x["source"])
    assert x["workloads"] == [CELL]
    for name in ("device_idle_pct", "sweep_host_ms", "launch_idle_ms", "sync_idle_ms"):
        assert entries[name]["workloads"][-1] == CELL, name
        assert len(entries[name]["workloads"]) == 5, name
