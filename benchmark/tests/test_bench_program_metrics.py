"""The readers of the program's spans and counters on synthetic traces:
the idle time inside a span is exact, each reader is silent where its
events or counters are absent or the cell runs another decoder, and the
iteration rooflines stay at or below 100% for any iterations the walks
could have taken."""

from __future__ import annotations

import random

import pytest

from benchmark import run as bench_run
from benchmark.reference.common import CodeSpec, seq_launches
from benchmark.tests.helpers import ROOT, load
from benchmark.yardstick import opcounts, peaks

METRICS = ROOT / "benchmark" / "metrics"
NAMES = ("launch_idle_ms", "sync_idle_ms", "fano_mc_iter_roofline_pct",
         "stack_mc_iter_roofline_pct", "fano_mc_tail_pct", "stack_mc_tail_pct")


def reader(name: str):
    return bench_run.load_module(METRICS / f"{name}.py", f"test_metric_{name}")


def context(cell: str, spans, kernels, host_ops, points=1):
    cfg, wl = load(ROOT, cell)
    return bench_run.TraceContext(cfg, wl, CodeSpec.from_config(cfg), [{}] * points, spans,
                                  kernels, host_ops)


#: two points over [0, 4] s; idle [1.0, 1.5], [3.0, 3.2] and [3.9, 4.0]
SPANS = [(0.0, 2.0), (2.0, 4.0)]
KERNELS = [("k", 0.0, 1.0), ("k", 1.5, 3.0), ("reduce", 3.2, 3.9)]


def test_the_idle_inside_a_span_is_exact():
    host = [("mc_launch", 0.9, 1.6), ("mc_launch", 3.05, 3.1), ("aten::sum", 1.0, 1.5),
            ("mc_readback", 2.9, 3.3), ("mc_readback", 3.0, 3.15),   # nested: once
            ("mc_readback", 3.95, 4.5)]                              # past the window
    ctx = context("code0-viterbi-8db", SPANS, KERNELS, host, points=2)
    assert reader("launch_idle_ms").read(ctx) == pytest.approx(1e3 * (0.5 + 0.05) / 2)
    assert reader("sync_idle_ms").read(ctx) == pytest.approx(1e3 * (0.2 + 0.05) / 2)
    # the two never exceed the points' idle time (sweep_host_ms)
    host_ms = reader("sweep_host_ms").read(ctx)
    assert host_ms == pytest.approx(1e3 * 0.8 / 2)
    assert reader("launch_idle_ms").read(ctx) + reader("sync_idle_ms").read(ctx) <= host_ms


@pytest.mark.parametrize("cell", ["code0-viterbi-8db", "wspr-stack-p05"])
def test_the_span_readers_are_silent_without_their_events(cell):
    for name in ("launch_idle_ms", "sync_idle_ms"):
        assert reader(name).read(context(cell, SPANS, KERNELS, [("aten::sum", 1, 2)])) is None
        assert reader(name).read(context(cell, SPANS, [], [("mc_launch", 0.9, 1.6),
                                                           ("mc_readback", 1, 2)])) is None
        assert reader(name).read(context(cell, [], KERNELS, [])) is None


@pytest.mark.parametrize("name,cells", [
    ("fano_mc_tail_pct", ("wspr-fano-p05", "code0-fano-4db")),
    ("stack_mc_tail_pct", ("wspr-stack-p05",)),
    ("fano_mc_iter_roofline_pct", ("wspr-fano-p05", "code0-fano-4db")),
    ("stack_mc_iter_roofline_pct", ("wspr-stack-p05",))])
def test_the_counter_readers_read_only_their_decoders_counters(name, cells):
    counters = {"walk_iters": 10 ** 9, "walk_launch_ns": 4000, "walk_tail_ns": 1000}
    mod = reader(name)
    for cell in ("code0-viterbi-8db", "wspr-fano-p05", "wspr-stack-p05", "code0-fano-4db"):
        got = mod.read(context(cell, SPANS, KERNELS, []), counters)
        assert (got is not None) == (cell in cells), cell
        if got is not None and "tail" in name:
            assert got == pytest.approx(25.0)
        for missing in ({}, {"walk_launch_ns": 0, "walk_tail_ns": 0}):   # the parent's program
            assert mod.read(context(cell, SPANS, KERNELS, []), missing) is None


def busy_for(ops: float, nbytes: float):
    """Kernels that run exactly the least time of ``ops`` and ``nbytes``."""
    t = peaks.least_seconds(ops, nbytes)
    return [(0.0, t)], [("walk", 0.0, t)]


@pytest.mark.parametrize("cell", ["wspr-fano-p05", "code0-fano-4db"])
def test_the_fano_iteration_roofline_never_passes_100(cell):
    """Walks of any iteration counts (random, up to the budget), each
    iteration of any kind at the fewest operations its kind takes
    (``FANO_OPS``' forward step, a backtrack that moves, one that relaxes,
    the budget's last test): busy for exactly that long, the share is at
    most 100%, and 100% only where every iteration was the cheapest."""
    cfg, wl = load(ROOT, cell)
    code, channel = CodeSpec.from_config(cfg), cfg["channel"]
    mod = reader("fano_mc_iter_roofline_pct")
    relax = sum(mod.ITER_OPS.values())
    kinds = [opcounts.fano_step_ops(code, channel), relax + 6, relax]
    frames = sum(la.lanes * la.steps for la in seq_launches(code, int(wl["bits_per_point"]), 0))
    nbytes = sum(3 * 8 * la.lanes for la in seq_launches(code, int(wl["bits_per_point"]), 0))
    budget = int(wl["timeout_per_bit"]) * code.num_block_symbols
    rng = random.Random(7)
    for trial in range(40):
        cheapest = trial % 4 == 0
        pattern = [(rng.choice([1, code.num_block_symbols, rng.randint(1, 5 * budget)]),
                    relax if cheapest else rng.choice(kinds)) for _ in range(8)]
        reps = frames // len(pattern)
        assert reps * len(pattern) == frames
        iters = reps * sum(n for n, _ in pattern)
        ops = reps * sum(opcounts.frame_datagen_ops(code, channel) + mod.LAST_OPS + (n - 1) * k
                         for n, k in pattern)
        spans, kernels = busy_for(ops, nbytes)
        got = mod.read(context(cell, spans, kernels, []), {"walk_iters": iters})
        assert 0 < got <= 100 * (1 + 1e-9)
        if cheapest:
            assert got == pytest.approx(100.0)


def test_the_stack_iteration_roofline_never_passes_100():
    """Walks of any iteration counts, each counted exactly (``stack_ops``
    a walk): the reader's one entry summing them all is the least that sum
    can be, so busy for exactly the walks' count the share is at most
    100%, and 100% where every walk took as many iterations."""
    cell = "wspr-stack-p05"
    cfg, wl = load(ROOT, cell)
    code, channel = CodeSpec.from_config(cfg), cfg["channel"]
    mod = reader("stack_mc_iter_roofline_pct")
    launches = seq_launches(code, int(wl["bits_per_point"]), 0)
    frames = sum(la.lanes * la.steps for la in launches)
    nbytes = sum(3 * 8 * la.lanes for la in launches)
    rng = random.Random(11)
    for trial in range(40):
        kinds = [rng.choice([1, 63, 64, 81, 500, 10 ** 6]) for _ in range(8)]
        if trial % 4 == 0:
            kinds = kinds[:1]
        per_frame = [kinds[f % len(kinds)] for f in range(len(kinds))]
        reps = frames // len(per_frame)
        assert reps * len(per_frame) == frames
        exact = opcounts.stack_ops(code, channel, per_frame, 1) * reps
        spans, kernels = busy_for(exact, nbytes)
        got = mod.read(context(cell, spans, kernels, []), {"walk_iters": sum(per_frame) * reps})
        assert 0 < got <= 100 * (1 + 1e-9)
        if len(kinds) == 1:
            assert got == pytest.approx(100.0)


def test_every_reader_is_in_the_manifest():
    m = bench_run.validate_manifest(ROOT)
    entries = {x["name"]: x for x in m["per_layer"]}
    for name in NAMES:
        mod = reader(name)
        x = entries[name]
        assert (mod.LAYER, mod.MOVES, mod.SOURCE) == (x["layer"], x["moves"], x["source"])
