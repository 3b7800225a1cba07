"""The check fails what it must: a run whose timed path is broken underneath
(the harness's look for a card skipped, the rest of the run as it is), and
the control, the reference in bfloat16 in the program's place.

The faults a Monte-Carlo cell can have: a launch that leaves its counters
unchanged (all zero); half of the lanes left out and the rest's counts
standing in for them; a counter altered where the kernel writes it; and a
point's totals altered on their way to the record.  The walks' check
compares a sample of lanes, so an alteration is caught where the sample
meets it: the tests alter every other lane.  One card, so no
exchange between chips."""

from __future__ import annotations

import pytest
import torch

from benchmark import control
from benchmark import run as bench_run
from benchmark.tests.helpers import checkout, load

import convolutional_codes_tpu_torch.parallel.montecarlo as montecarlo
import convolutional_codes_tpu_torch.parallel.seq_grid as seq_grid
import convolutional_codes_tpu_torch.sim.sweep as sweep

TAPS = {"code0-viterbi-8db": (montecarlo, "mc_chain_viterbi"),
        "wspr-fano-p05": (seq_grid, "mc_fano"),
        "wspr-stack-p05": (seq_grid, "mc_stack")}


def unchanged(out):
    return tuple(torch.zeros_like(o) for o in out) if isinstance(out, tuple) else out * 0


def half_left_out(out):
    def half(o):
        n = o.shape[-1] // 2
        return torch.cat([o[..., :n], o[..., :n]], dim=-1)[..., :o.shape[-1]]
    return tuple(half(o) for o in out) if isinstance(out, tuple) else half(out)


def altered(out):
    """Bit errors one higher on every other lane: the walks' check compares
    lanes drawn from the seed, so one altered lane is caught only where it
    is drawn."""
    out[0][::2] += 1
    return out


@pytest.mark.parametrize("cell", sorted(TAPS))
def test_a_sound_run_is_correct(cell, tmp_path):
    root = checkout(tmp_path, [cell])
    out = bench_run.run(cell, 2 ** 31 + 99, 0.1, False, root=root, device="cpu")
    assert out["correct"], out["checks"]


@pytest.mark.parametrize("fault", [unchanged, half_left_out, altered])
@pytest.mark.parametrize("cell", sorted(TAPS))
def test_a_broken_kernel_is_not_correct(cell, fault, tmp_path, monkeypatch):
    module, name = TAPS[cell]
    inner = getattr(module, name)
    monkeypatch.setattr(module, name, lambda *a, **k: fault(inner(*a, **k)))
    root = checkout(tmp_path, [cell])
    out = bench_run.run(cell, 2 ** 32 + 7, 0.1, False, root=root, device="cpu")
    assert not out["correct"], out["checks"]
    assert any(c["value"] > c["limit"] for k, c in out["checks"].items()
               if k in ("lanes_off", "iters_off"))


def test_a_point_altered_on_its_way_to_the_record_is_not_correct(tmp_path, monkeypatch):
    inner = sweep.fused_mc_accumulate

    def more_errors(*a, **k):
        be, fe, nb = inner(*a, **k)
        return be + 1, fe, nb

    monkeypatch.setattr(sweep, "fused_mc_accumulate", more_errors)
    root = checkout(tmp_path, ["code0-viterbi-8db"])
    out = bench_run.run("code0-viterbi-8db", 3, 0.1, False, root=root, device="cpu")
    assert not out["correct"] and out["checks"]["sum_gap"]["value"] > 0


def test_fewer_bits_than_asked_are_not_correct(tmp_path, monkeypatch):
    inner = sweep.target_bits
    monkeypatch.setattr(sweep, "target_bits", lambda spec, p: inner(spec, p) // 2)
    root = checkout(tmp_path, ["code0-viterbi-8db"])
    out = bench_run.run("code0-viterbi-8db", 4, 0.1, False, root=root, device="cpu")
    assert not out["correct"] and out["checks"]["bits_gap"]["value"] > 0


@pytest.mark.parametrize("cell", ["code0-viterbi-8db", "wspr-fano-p05", "wspr-stack-p05"])
def test_the_control_fails_the_check(cell, tmp_path):
    """The reference in bfloat16 in the program's place, at a size a test
    holds: it fails one of the cell's numbers on each of three seeds.  The
    Viterbi cell's 8 dB has about one error frame in 3,600; at the CPU's
    2048 lanes x 8 steps its control sees too few of them, so the test
    moves the point to 6 dB (one in 80).  The walks' metrics change in
    bfloat16 only past 256 in size, which a walk reaches only deep into its
    budget: their control runs the cell's crossover with a budget of 400 a
    bit (the stack has none)."""
    root = checkout(tmp_path, [cell])
    cfg, wl = load(root, cell)
    if cell == "code0-viterbi-8db":
        wl.update(bits_per_point=2048 * 40 * 8, point=6.0)
    else:
        wl.update(point=0.05, timeout_per_bit=400)
    for seed in (1, 2, 3):
        got = control.control_readings(cfg, wl, seed, torch.device("cpu"), torch.bfloat16)
        assert any(got[k] > wl["limits"][k] for k in ("lanes_off", "iters_off") if k in got), got
