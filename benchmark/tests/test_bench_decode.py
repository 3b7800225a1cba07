"""The decode cell ``k7-decode-b128`` at CPU size: a sound run reads every
check at 0; a broken decode under the entry (its output zeroed, one bit of
one frame flipped, one frame left out) and the reference in bfloat16 in
the program's place read above 0; the yardstick's counts are the hand
counts; the cell's readers stay at or below 100% or positive, and are
silent without the program's counters and spans."""

from __future__ import annotations

import json

import pytest
import torch

from benchmark import run as bench_run
from benchmark.loops import decode_frames
from benchmark.reference.common import CodeSpec
from benchmark.tests.helpers import ROOT, checkout, load
from benchmark.yardstick import decode_ops, peaks

import convolutional_codes_tpu_torch.parallel.streaming as streaming

CELL = "k7-decode-b128"
#: the cell cut to CPU size: 4 frames of 250 info bits (T = 256), a pool of
#: 8, two batches kept
TINY = {"frames": 4, "info_bits": 250, "sample": {"batches": 2}}
METRICS = ("decode_acs_roofline_pct", "decode_traceback_roofline_pct", "decode_step_ns",
           "decode_idle_ms")


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
    assert set(out["checks"]) == set(decode_frames.CHECKS)
    assert all(c["value"] == 0 for c in out["checks"].values())
    assert out["metrics"]["info_bits_per_s"]["value"] > 0
    assert out["attempted"] >= 1


def zeroed(out):
    return torch.zeros_like(out)


def one_bit_flipped(out):
    out = out.clone()
    out[2, 5] ^= 1
    return out


def one_frame_left_out(out):
    return out[1:].contiguous()


@pytest.mark.parametrize("fault,check", [(zeroed, "frames_off"),
                                         (one_bit_flipped, "frames_off"),
                                         (one_frame_left_out, "shape_gap")])
def test_a_broken_decode_is_not_correct(fault, check, tmp_path, monkeypatch):
    inner = streaming.long_frame_decode_stream
    monkeypatch.setattr(streaming, "long_frame_decode_stream",
                        lambda *a, **k: fault(inner(*a, **k)))
    root = tiny_checkout(tmp_path)
    out = bench_run.run(CELL, 2 ** 32 + 9, 0.1, False, root=root, device="cpu")
    assert not out["correct"], out["checks"]
    assert out["checks"][check]["value"] > 0
    assert out["checks"]["frames_off"]["value"] > 0


def test_the_control_fails_the_check(tmp_path):
    """The reference in bfloat16 in the program's place, on three seeds, at
    frames of 4,096 symbols: below a few thousand steps bfloat16's path
    metrics still order the survivors as float32's do (at 256 symbols all
    three seeds agree), past that their spacing outgrows the distances."""
    cfg, wl = load(tiny_checkout(tmp_path), CELL)
    wl.update(frames=2, info_bits=4090)
    for seed in (1, 2, 3):
        got = decode_frames.control_readings(cfg, wl, seed, torch.device("cpu"),
                                             torch.bfloat16)
        assert got["frames_off"] > wl["limits"]["frames_off"], got


def test_the_cell_is_the_sources_shape():
    """128 frames of 65,530 info bits and the 6-bit tail: 2^16 symbols."""
    cfg, wl = load(ROOT, CELL)
    loop = decode_frames.Loop(cfg, wl, torch.device("cpu"), 1)
    assert (loop.B, loop.L, loop.T) == (128, 65530, 65536)
    assert wl["pool"] == 8 and wl["point"] == 4.0


def test_the_yardstick_is_the_hand_count():
    """K=7: S = 64 states, M = 4 points, 2 decision words a symbol; B = 3
    frames of T = 10 symbols."""
    cfg, _ = load(ROOT, CELL)
    code = CodeSpec.from_config(cfg)
    symbols, frames = 3 * 10, 3
    assert decode_ops.nwords(code) == 2
    assert decode_ops.acs_ops(code, symbols) == 8 * 64 * 30
    assert decode_ops.acs_bytes(code, symbols, frames) == (4 + 2) * 4 * 30 + 2 * 64 * 4 * 3
    assert decode_ops.traceback_bytes(code, symbols, frames) == (2 + 1) * 4 * 30 + 8 * 3
    # the cell's batch: the bounds chip_smoke prints for B = 128, T = 65,536
    s = 128 * 65536
    assert round(decode_ops.acs_least_seconds(code, s, 128) * 1e3, 4) == 0.1284
    assert round(decode_ops.traceback_least_seconds(code, s, 128) * 1e3, 4) == 0.0300
    assert decode_ops.acs_least_seconds(code, s, 128) == peaks.least_seconds(
        8 * 64 * s, (4 + 2) * 4 * s + 2 * 64 * 4 * 128)


def reader(name):
    return bench_run.load_module(ROOT / "benchmark" / "metrics" / f"{name}.py",
                                 f"test_metric_{name}")


def context(batches, kernels, host_ops=()):
    cfg, wl = load(ROOT, CELL)
    spans = [(10.0 * i, 10.0 * i + 10.0) for i in range(batches)]
    return bench_run.TraceContext(cfg, wl, CodeSpec.from_config(cfg), [{}] * batches,
                                  spans, kernels, list(host_ops))


def counters(batches, B=128, T=65536):
    return {"decode_frames": B * batches, "decode_symbols": B * T * batches,
            "decode_chain_steps": T * batches}


@pytest.mark.parametrize("batches", [1, 3])
def test_the_rooflines_never_pass_100_and_are_silent_without_counters(batches):
    """Kernel 4 busy for exactly the least time of the counted work reads
    100%, longer less; kernel 5 alike; another kernel's time is not theirs.
    Without the counters (the parent's program), or without the kernel,
    nothing."""
    cfg, _ = load(ROOT, CELL)
    code = CodeSpec.from_config(cfg)
    c = counters(batches)
    least = {"decode_acs_roofline_pct": decode_ops.acs_least_seconds(
                 code, c["decode_symbols"], c["decode_frames"]),
             "decode_traceback_roofline_pct": decode_ops.traceback_least_seconds(
                 code, c["decode_symbols"], c["decode_frames"])}
    names = {"decode_acs_roofline_pct": ["void stream_acs_kernel<64, 4, false>(float const*)"],
             "decode_traceback_roofline_pct": ["void tb_map_kernel<2>(int const*)",
                                               "tb_fold_kernel(unsigned char const*)",
                                               "void stream_traceback_kernel<2>(int const*)"]}
    for name, t in least.items():
        mod = reader(name)
        for stretch in (1.0, 1.7, 10.0):
            # the work's time split over the kernels, one after another,
            # beside a kernel of another name
            parts = names[name]
            d = t * stretch / len(parts)
            ks = [(k, 1.0 + i * d, 1.0 + (i + 1) * d) for i, k in enumerate(parts)]
            ks.append(("elementwise_kernel", 0.0, 5.0))
            got = mod.read(context(batches, ks), c)
            assert 0 < got <= 100 * (1 + 1e-9)
            assert got == pytest.approx(100.0 / stretch)
        for missing in ({}, dict(c, decode_symbols=0)):
            assert mod.read(context(batches, [(names[name][0], 1.0, 2.0)]), missing) is None
        assert mod.read(context(batches, [("elementwise_kernel", 1.0, 2.0)]), c) is None


def test_the_step_time_is_kernel_4s_time_over_the_chain():
    mod = reader("decode_step_ns")
    ks = [("void stream_acs_kernel<64, 4, false>(float const*)", 1.0, 1.003),
          ("void stream_acs_kernel<64, 4, false>(float const*)", 11.0, 11.003),
          ("void stream_traceback_kernel<2>(int const*)", 1.003, 1.0033)]
    got = mod.read(context(2, ks), counters(2))
    assert got == pytest.approx(0.006e9 / (2 * 65536))
    assert got > 0
    assert mod.read(context(2, ks), {}) is None
    assert mod.read(context(2, ks[2:]), counters(2)) is None


def test_the_idle_time_is_inside_the_decode_spans():
    """Two batches: 2 ms of idle inside ``decode_layout``, 1 ms inside
    ``decode_acs`` and 1 ms inside ``decode_traceback`` in all, 2 ms a
    batch; idle under another span does not count; without the spans, or
    without kernels, nothing."""
    mod = reader("decode_idle_ms")
    kernels = [("k", 0.0, 1.0), ("k", 1.003, 10.0), ("k", 10.0, 19.998), ("k", 19.999, 20.0)]
    host = [("decode_layout", 0.5, 1.002), ("decode_acs", 1.002, 1.5),
            ("decode_traceback", 19.9975, 19.9995), ("decode_layout", 10.0, 10.5),
            ("sweep_record", 1.0, 1.003)]
    got = mod.read(context(2, kernels, host))
    assert got == pytest.approx((0.002 + 0.001 + 0.001) / 2 * 1e3)
    assert got > 0
    assert mod.read(context(2, kernels, [("mc_launch", 0.5, 1.5)])) is None
    assert mod.read(context(2, [], host)) is None


def test_the_cells_readers_are_in_the_manifest():
    """The four readers are the cell's alone, with the layer, the metric
    they move and the source their entries give; the device's idle share
    lists the cell after the cells it had."""
    m = bench_run.validate_manifest(ROOT)
    entries = {x["name"]: x for x in m["per_layer"]}
    for name in METRICS:
        mod, x = reader(name), entries[name]
        assert (mod.LAYER, mod.MOVES, mod.SOURCE) == (x["layer"], x["moves"], x["source"])
        assert x["workloads"] == [CELL]
    assert entries["device_idle_pct"]["workloads"][-1] == CELL
    assert [w["name"] for w in m["workloads"]][-1] == CELL
