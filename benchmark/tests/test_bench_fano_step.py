"""The reader of the Fano walk's iteration time, ``fano_mc_step_ns``, on
given counters: ``None`` without its counters (a program that keeps none),
on the cells of another decoder, or with no iterations; the cold launches'
time over their longest walks' iterations otherwise.  Its manifest entry
names the Fano walk's layer and the two Fano cells."""

from __future__ import annotations

import pytest

from benchmark import run as bench_run
from benchmark.tests.test_bench_program_metrics import SPANS, KERNELS, context, reader

FANO = ("wspr-fano-p05", "code0-fano-4db")


@pytest.mark.parametrize("cell", FANO)
def test_the_step_time_of_given_counters(cell):
    ctx = context(cell, SPANS, KERNELS, [])
    mod = reader("fano_mc_step_ns")
    for counters, want in (({"walk_cold_ns": 4_000_000, "walk_cold_max_iters": 20_000}, 200.0),
                           ({"walk_cold_ns": 225_000_000, "walk_cold_max_iters": 600_000}, 375.0),
                           ({"walk_cold_ns": 3, "walk_cold_max_iters": 4, "walk_iters": 9}, 0.75)):
        assert mod.read(ctx, counters) == pytest.approx(want)
    for missing in ({}, {"walk_iters": 10 ** 9, "walk_launch_ns": 4000, "walk_tail_ns": 1000},
                    {"walk_cold_ns": 4000, "walk_overlap_ns": 3000},   # the parent's program
                    {"walk_cold_ns": 4000, "walk_cold_max_iters": 0},
                    {"walk_cold_ns": 0, "walk_cold_max_iters": 10}):
        assert mod.read(ctx, missing) is None


@pytest.mark.parametrize("cell", ["code0-viterbi-8db", "wspr-stack-p05", "k7-longframe-6db"])
def test_the_step_time_is_silent_on_other_decoders(cell):
    counters = {"walk_cold_ns": 4_000_000, "walk_cold_max_iters": 20_000}
    assert reader("fano_mc_step_ns").read(context(cell, SPANS, KERNELS, []), counters) is None


def test_the_step_time_is_listed_for_the_fano_cells():
    m = bench_run.validate_manifest(bench_run.ROOT)
    (entry,) = [x for x in m["per_layer"] if x["name"] == "fano_mc_step_ns"]
    assert entry["layer"] == "Fano MC walk (kernel 8)" and entry["better"] == "lower"
    assert entry["source"] == "program_counter" and entry["moves"] == "info_bits_per_s"
    assert entry["unit"] == "ns" and tuple(entry["workloads"]) == FANO
    assert m["per_layer"][-1] is entry
