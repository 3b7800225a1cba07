"""The plain reference gives the port's plain versions' per-lane counters at
a small size on the CPU: exactly on the BSC, and on AWGN within the
cell's limit of lanes off (on one host's math library: none)."""

from __future__ import annotations

import json

import pytest
import torch

from benchmark.reference import common, fano, stack, viterbi
from benchmark.tests.helpers import ROOT

from convolutional_codes_tpu_torch.models.codebook import get_code
from convolutional_codes_tpu_torch.ops.channels import awgn_sigma
from convolutional_codes_tpu_torch.ops.fano_mc import mc_fano_ref
from convolutional_codes_tpu_torch.ops.fused_chain import mc_chain_viterbi_ref
from convolutional_codes_tpu_torch.ops.stack_mc import mc_stack_ref
from convolutional_codes_tpu_torch.sim import sweep


def config(name):
    return json.loads((ROOT / "benchmark" / "configs" / f"{name}.json").read_text())


def limit(cell):
    return json.loads((ROOT / "benchmark" / "workloads" / f"{cell}.json").read_text())["limits"]


@pytest.mark.parametrize("db", [0.0, 4.0, 8.0, 3.65, 12.5])
def test_sigma_equals_the_ports(db):
    assert common.awgn_sigma(db) == float(awgn_sigma(db))


@pytest.mark.parametrize("key,name", [(0, "code0-awgn-soft"), (4, "wspr-bsc")])
def test_the_code_equals_the_ports(key, name):
    code, port = common.CodeSpec.from_config(config(name)), get_code(key)
    for field in ("symlen_out", "constraint_length", "block_length", "polynomials", "parity",
                  "bit_metrics", "fano_bit_metrics", "metric_weight", "fano_metric_weight"):
        assert getattr(code, field) == getattr(port, field), field


@pytest.mark.parametrize("channel,point", [("awgn", 4.0), ("awgn", 8.0), ("bsc", 0.03)])
def test_viterbi_lanes_equal_the_plain_chain(channel, point):
    cfg = dict(config("code0-awgn-soft"), channel=channel)
    code = common.CodeSpec.from_config(cfg)
    la = common.Launch(seed=0x7ABCDEF1, lanes=2048, steps=2)
    got = viterbi.lane_counters(code, cfg, point, la, torch.arange(2048), 0, "cpu")
    be, fe = mc_chain_viterbi_ref(get_code(0), 2048, 2, la.seed, common.channel_param(cfg, point),
                                  channel, 1024, "soft")
    off = int(((got[0] != be) | (got[1] != fe)).sum())
    assert off <= limit("code0-viterbi-8db")["lanes_off"]
    assert int(got[0].sum()) > 0


@pytest.mark.parametrize("cell,key,point,budget", [
    ("wspr-fano-p05", 4, 0.05, 20), ("code0-fano-4db", 0, 4.0, 30)])
def test_fano_lanes_equal_the_plain_machine(cell, key, point, budget):
    cfg = config("wspr-bsc" if key == 4 else "code0-awgn-soft")
    code = common.CodeSpec.from_config(cfg)
    la = common.Launch(seed=987654321, lanes=12, steps=2)
    got = fano.lane_counters(code, cfg, point, la, torch.arange(12), budget, "cpu", workers=2)
    want = mc_fano_ref(get_code(key), 12, 2, la.seed, common.channel_param(cfg, point),
                       cfg["channel"], cfg["demapper"], budget)
    lim = limit(cell)
    assert int(((got[:2] != want[:2]).any(dim=0)).sum()) <= lim["lanes_off"]
    assert int((got[2] != want[2]).sum()) <= lim["iters_off"]


def test_stack_lanes_equal_the_plain_machine():
    cfg = config("wspr-bsc")
    code = common.CodeSpec.from_config(cfg)
    la = common.Launch(seed=31337, lanes=20, steps=2)
    got = stack.lane_counters(code, cfg, 0.02, la, torch.tensor([0, 3, 7, 19]), 0, "cpu")
    want = mc_stack_ref(get_code(4), 20, 2, la.seed, 0.02, "bsc", "hard")[:, [0, 3, 7, 19]]
    assert torch.equal(got, want)


def test_the_launch_plans_equal_the_sweeps():
    """The reference's frame addressing against ``run_sweep``'s own."""
    code0, wspr = (common.CodeSpec.from_config(config(n)) for n in ("code0-awgn-soft", "wspr-bsc"))
    for seed in (0, 12345, 2 ** 31 - 1):
        assert common.chunk_seed(seed, 3) == sweep._chunk_seed(seed, 0, 3)
    for bits in (80_000_000, 16_384_000, 800_000, 50_000):
        lanes, fpl = sweep.seq_plan(bits, 50)
        plan = common.seq_launches(wspr, bits, 7)
        assert plan[0].lanes == lanes and sum(la.steps for la in plan) == fpl
        assert plan[0].seed == common.chunk_seed(7, 0)
        if fpl > 1:
            assert plan[1].seed == common.chunk_seed(7, 0) ^ sweep.WARM_SEED_XOR
    plan = common.fused_launches(code0, 1 << 20, 8_388_608_000, 5)
    assert [la.steps for la in plan] == [25] * 8 and plan[0].lanes == 1 << 20
    assert common.launch_bits(code0, plan) == 8_388_608_000
