"""The frozen operation counts: they repeat exactly from the shapes, equal
the port's counted arithmetic they were copied from, and the least work
of a walk never exceeds the work its iterations count."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from benchmark.reference import common, fano, stack
from benchmark.tests.helpers import ROOT
from benchmark.yardstick import opcounts, peaks


def spec(name: str) -> common.CodeSpec:
    return common.CodeSpec.from_config(
        json.loads((ROOT / "benchmark" / "configs" / f"{name}.json").read_text()))


def test_code0_chain_is_191_1_operations_a_symbol():
    code = spec("code0-awgn-soft")
    ops = opcounts.mc_chain_ops_per_symbol(code)
    assert round(ops, 1) == 191.1
    # the bound of one step of 2^20 lanes, as chip_smoke prints it
    step = peaks.least_seconds(ops * code.num_block_symbols * (1 << 20), 0.0)
    assert round(step * 1e3, 4) == 0.2516


@pytest.mark.parametrize("name", ["code0-awgn-soft", "wspr-bsc"])
@pytest.mark.parametrize("channel", ["awgn", "bsc"])
def test_counts_repeat_from_the_shapes(name, channel):
    code = spec(name)
    iters = np.array([300.0, 5000.0, 81.0])
    first = (opcounts.mc_chain_ops_per_symbol(code),
             opcounts.datagen_ops_per_symbol(code, channel),
             opcounts.stack_ops(code, channel, iters, 3),
             opcounts.fano_step_ops(code, channel),
             opcounts.least_walk_ops(code, channel, "fano", 1000),
             opcounts.least_walk_ops(code, channel, "stack", 1000))
    again = (opcounts.mc_chain_ops_per_symbol(spec(name)),
             opcounts.datagen_ops_per_symbol(spec(name), channel),
             opcounts.stack_ops(spec(name), channel, iters.copy(), 3),
             opcounts.fano_step_ops(spec(name), channel),
             opcounts.least_walk_ops(spec(name), channel, "fano", 1000),
             opcounts.least_walk_ops(spec(name), channel, "stack", 1000))
    assert first == again


@pytest.mark.parametrize("channel", ["awgn", "bsc"])
def test_the_copies_equal_chip_smokes_counts(channel):
    chip_smoke = pytest.importorskip("chip_smoke")
    from convolutional_codes_tpu_torch.models.codebook import get_code

    for key, name in ((0, "code0-awgn-soft"), (4, "wspr-bsc")):
        port, code = get_code(key), spec(name)
        assert opcounts.LANE_OPS == chip_smoke.LANE_OPS
        assert opcounts.mc_chain_ops_per_symbol(code) == chip_smoke.mc_chain_ops_per_symbol(port)
        assert (opcounts.datagen_ops_per_symbol(code, channel)
                == chip_smoke.datagen_ops_per_symbol(port, channel))
        iters = torch.tensor([400, 9000, 64 * 81], dtype=torch.int64)
        assert opcounts.stack_pick_ops(iters.numpy(), 64) == chip_smoke.stack_pick_ops(iters, 64)
        assert (opcounts.stack_ops(code, channel, iters.numpy(), 64)
                == chip_smoke.stack_ops(port, channel, iters, 64, mc=True))


@pytest.mark.parametrize("decoder", ["fano", "stack"])
def test_least_work_never_exceeds_the_counted_iterations(decoder):
    """The least-work count (a step a symbol) against the count with the
    walks' own iterations, on the same frames of both configurations."""
    ref = {"fano": fano, "stack": stack}[decoder]
    for name, point in (("wspr-bsc", 0.05), ("code0-awgn-soft", 4.0)):
        cfg = json.loads((ROOT / "benchmark" / "configs" / f"{name}.json").read_text())
        code = common.CodeSpec.from_config(cfg)
        la = common.Launch(seed=2024, lanes=16, steps=2)
        got = ref.lane_counters(code, cfg, point, la, torch.arange(16), 20, "cpu", workers=1)
        frames = la.lanes * la.steps
        assert int(got[2].sum()) >= code.num_block_symbols * frames   # a step a symbol at least
        least = opcounts.least_walk_ops(code, cfg["channel"], decoder, frames)
        if decoder == "stack":
            counted = opcounts.stack_ops(code, cfg["channel"], got[2].numpy(), la.steps)
        else:
            counted = frames * opcounts.frame_datagen_ops(code, cfg["channel"]) + float(
                got[2].sum()) * opcounts.fano_step_ops(code, cfg["channel"])
        assert least <= counted
