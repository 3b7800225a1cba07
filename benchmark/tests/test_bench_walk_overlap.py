"""The reader of the sequential leg's overlap, ``walk_overlap_pct``, on
given counters: ``None`` without its counters (a program that keeps none)
or with a cold time of 0, and 100 x overlap / cold time otherwise; its
manifest entry names the reader's layer and the sequential cells."""

from __future__ import annotations

import pytest

from benchmark import run as bench_run
from benchmark.tests.test_bench_program_metrics import SPANS, KERNELS, context, reader

SEQUENTIAL = ("wspr-fano-p05", "wspr-stack-p05", "code0-fano-4db")


@pytest.mark.parametrize("cell", SEQUENTIAL)
def test_the_overlap_share_of_given_counters(cell):
    ctx = context(cell, SPANS, KERNELS, [])
    mod = reader("walk_overlap_pct")
    for counters, want in (({"walk_cold_ns": 4000, "walk_overlap_ns": 3000}, 75.0),
                           ({"walk_cold_ns": 4000, "walk_overlap_ns": 0}, 0.0),
                           ({"walk_cold_ns": 250, "walk_overlap_ns": 250}, 100.0)):
        assert mod.read(ctx, counters) == pytest.approx(want)
    for missing in ({}, {"walk_iters": 10 ** 9, "walk_launch_ns": 4000, "walk_tail_ns": 1000},
                    {"walk_cold_ns": 0, "walk_overlap_ns": 0}, {"walk_cold_ns": 4000}):
        assert mod.read(ctx, missing) is None


def test_the_overlap_share_is_listed_for_the_sequential_cells():
    m = bench_run.validate_manifest(bench_run.ROOT)
    (entry,) = [x for x in m["per_layer"] if x["name"] == "walk_overlap_pct"]
    assert entry["layer"] == "sweep and accumulation (host)"
    assert entry["source"] == "program_counter" and entry["moves"] == "info_bits_per_s"
    assert tuple(entry["workloads"]) == SEQUENTIAL
