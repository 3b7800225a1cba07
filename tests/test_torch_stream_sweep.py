"""PyTorch port, the stream leg of ``run_sweep``: long streaming frames of
``nasa-k7`` (BASELINE config 2) through the long-frame chain (kernel 6's
plain version on the CPU), held against the benchmark's plain reference
(``benchmark/reference/longframe.py``, which imports nothing of the port)
lane for lane, chunk by chunk, on one slot and on a two-slot ``frames``
mesh; the checkpoint fingerprint of every terminated-block spec against the
JAX package's; the CLI's flags.

Tolerances: counters exactly, on the BSC and on the CPU's AWGN (the same
hash streams and float32 expressions on the same math library).
"""

import dataclasses
import json
import os
import sys

import pytest
import torch

from convolutional_codes_tpu.models.codebook import get_code as jax_code
from convolutional_codes_tpu.sim import sweep as jsweep
from convolutional_codes_tpu_torch.models.codebook import get_code
from convolutional_codes_tpu_torch.ops.channels import awgn_sigma
from convolutional_codes_tpu_torch.ops.fused_longframe import mc_longframe_viterbi
from convolutional_codes_tpu_torch.parallel import streaming
from convolutional_codes_tpu_torch.parallel.mesh import make_mesh
from convolutional_codes_tpu_torch.sim import cli, sweep
from convolutional_codes_tpu_torch.sim.sweep import SweepSpec, _spec_fingerprint, run_sweep

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from benchmark.reference import longframe as lf_ref  # noqa: E402
from benchmark.reference.common import CodeSpec, chunk_seed  # noqa: E402

CPU = torch.device("cpu")
LANES, WINDOW, WARMUP, WINDOWS, SEED = 64, 64, 32, 6, 14
#: (channel, point): 3 dB and p = 0.03, where this seed's windows hold errors
POINTS = [("awgn", 3.0), ("bsc", 0.03)]


def _config(channel: str) -> dict:
    with open(os.path.join(REPO, "benchmark", "configs", "nasa-k7.json")) as f:
        cfg = json.load(f)
    return dict(cfg, channel=channel)


def _spec(channel: str, point: float, **kw) -> SweepSpec:
    return SweepSpec(code="nasa-k7", channel=channel, points=[point],
                     frames_per_step=LANES, bits_per_point=LANES * WINDOW * WINDOWS,
                     seed=SEED, stream_window=WINDOW, stream_warmup=WARMUP, **kw)


@pytest.fixture
def two_window_chunks(monkeypatch):
    """Chunks of 2 windows, so that a point of 6 windows runs 3 launches."""
    bits = 2 * LANES * WINDOW
    monkeypatch.setattr(sweep, "CHUNK_BITS", bits)
    monkeypatch.setattr(lf_ref, "CHUNK_BITS", bits)


@pytest.mark.parametrize("channel,point", POINTS)
def test_the_record_equals_the_reference_lanes(channel, point, two_window_chunks, monkeypatch):
    """The leg's record is the sum of the reference's per-lane counters of
    its plan, and each launch's per-lane counters are the reference's."""
    launched = []
    inner = streaming.mc_longframe_viterbi

    def tap(*args, **kwargs):
        out = inner(*args, **kwargs)
        launched.append((args[2], args[3], torch.stack(out).to(torch.int64)))
        return out

    monkeypatch.setattr(streaming, "mc_longframe_viterbi", tap)
    (rec,) = run_sweep(_spec(channel, point), verbose=False, device="cpu")
    cfg, code = _config(channel), CodeSpec.from_config(_config(channel))
    wl = {"frames_per_step": LANES, "window": WINDOW, "bits_per_point": rec.bits}
    plan = lf_ref.launches(code, wl, SEED)
    assert [(la.seed, la.steps) for la in plan] == [(chunk_seed(SEED, ci), 2) for ci in range(3)]
    assert [(n, s) for n, s, _ in launched] == [(la.steps, la.seed) for la in plan]
    total = torch.zeros(2, dtype=torch.int64)
    for la, (_, _, got) in zip(plan, launched):
        want = lf_ref.lane_counters(code, cfg, point, la, torch.arange(LANES), WINDOW, WARMUP,
                                    CPU)
        assert torch.equal(got, want)
        total += want.sum(1)
    assert (rec.bit_errors, rec.frame_errors) == tuple(total.tolist())
    assert rec.bit_errors > 0
    assert rec.bits == LANES * WINDOW * WINDOWS == lf_ref.launch_bits(wl, plan)
    assert rec.frames == LANES * WINDOWS and rec.fer == rec.frame_errors / rec.frames
    assert rec.code == "nasa-k7" and rec.decoder == "viterbi"


@pytest.mark.parametrize("channel,point", POINTS)
def test_a_chunk_equals_its_windows_one_at_a_time(channel, point):
    code = get_code("nasa-k7")
    param = float(awgn_sigma(point)) if channel == "awgn" else point
    kw = dict(channel=channel, window=WINDOW, warmup=WARMUP, device="cpu")
    be, we = mc_longframe_viterbi(code, LANES, 3, 77, param, **kw)
    parts = [mc_longframe_viterbi(code, LANES, 1, 77, param, win0=k, **kw) for k in range(3)]
    assert torch.equal(be, sum(p[0] for p in parts))
    assert torch.equal(we, sum(p[1] for p in parts))


@pytest.mark.parametrize("channel,point", POINTS)
def test_a_frames_mesh_equals_one_slot(channel, point, two_window_chunks):
    mesh = make_mesh({"frames": 2}, devices=[CPU] * 2)
    (one,) = run_sweep(_spec(channel, point), verbose=False, device="cpu")
    (two,) = run_sweep(_spec(channel, point), mesh=mesh, verbose=False)
    assert (two.bits, two.bit_errors, two.frame_errors, two.frames) == \
        (one.bits, one.bit_errors, one.frame_errors, one.frames)


@pytest.mark.parametrize("bits,slots", [(3 * LANES * WINDOW, 2), (100, 2), (100, 3),
                                        (5 * LANES * WINDOW, 3)])
def test_any_point_on_a_frames_mesh_equals_one_slot(bits, slots):
    """Chunks as the leg plans them, with nothing patched: a point that
    fits one chunk runs a cold chunk of one window, then the rest; a point
    below one window's bits runs one window; neither divides over the
    slots, so a slot takes one window more than another, or none."""
    spec = dataclasses.replace(_spec("bsc", 0.03), bits_per_point=bits)
    mesh = make_mesh({"frames": slots}, devices=[CPU] * slots)
    (one,) = run_sweep(spec, verbose=False, device="cpu")
    (many,) = run_sweep(spec, mesh=mesh, verbose=False)
    assert (many.bits, many.bit_errors, many.frame_errors, many.frames) == \
        (one.bits, one.bit_errors, one.frame_errors, one.frames)
    assert one.frames == LANES * max(1, -(-bits // (LANES * WINDOW)))


#: specs as sweeps made them before the stream leg
OLD_SPECS = [
    dict(code=0, channel="bsc", points=[0.05], frames_per_step=1024, bits_per_point=40960,
         seed=17),
    dict(code="k9-r12", channel="awgn", decoder="stack", points=[4.0], base_bits=8e7,
         seed=1234),
    dict(code=4, channel="bsc", decoder="fano", points=[0.05], timeout_per_bit=400),
    dict(code="nasa-k7", channel="awgn", demapper="hard", frames_per_step=65536),
    dict(code=0, channel="uncoded", points=[2.0]),
]


@pytest.mark.parametrize("kw", OLD_SPECS)
def test_every_existing_fingerprint_is_unchanged(kw):
    fp = _spec_fingerprint(SweepSpec(**kw), get_code(kw["code"]))
    assert fp == jsweep._spec_fingerprint(jsweep.SweepSpec(**kw), jax_code(kw["code"]))
    assert fp == _spec_fingerprint(SweepSpec(stream_window=0, stream_warmup=64, **kw),
                                   get_code(kw["code"]))


def test_a_stream_spec_has_a_fingerprint_of_its_own():
    base = _spec("awgn", 3.0)
    specs = [base, dataclasses.replace(base, stream_warmup=WARMUP + 1),
             dataclasses.replace(base, stream_window=2 * WINDOW),
             dataclasses.replace(base, stream_window=0)]
    assert len({_spec_fingerprint(s, get_code("nasa-k7")) for s in specs}) == 4


def test_the_cli_flags_parse_and_run(capsys):
    args = cli.build_parser().parse_args(["awgn", "--code", "nasa-k7", "--stream-window", "1920"])
    assert (args.stream_window, args.stream_warmup) == (1920, 128)
    args = cli.build_parser().parse_args(["bsc", "--stream-window", "64", "--stream-warmup", "8"])
    assert (args.stream_window, args.stream_warmup) == (64, 8)
    args = cli.build_parser().parse_args(["awgn"])
    assert args.stream_window == 0
    assert cli.main(["bsc", "--code", "nasa-k7", "--stream-window", "32", "--stream-warmup",
                     "16", "--points", "0.03", "--frames", "8", "--bits-per-point", "512",
                     "--cpu"]) == 0
    out = capsys.readouterr().out
    assert "windows of 32 + 2 x 16 symbols" in out and "[bsc/viterbi/soft nasa-k7]" in out


@pytest.mark.parametrize("kw", [dict(decoder="stack"), dict(decoder="fano"),
                                dict(channel="uncoded")])
def test_stream_window_takes_only_viterbi(kw):
    with pytest.raises(ValueError, match="stream_window"):
        SweepSpec(code="nasa-k7", stream_window=64, **kw)
    with pytest.raises(ValueError, match="stream_window"):
        SweepSpec(code="nasa-k7", stream_window=-1)
    if "decoder" in kw:
        with pytest.raises(ValueError, match="stream_window"):
            cli.main(["bsc", "--decoder", kw["decoder"], "--stream-window", "64", "--cpu"])


@pytest.mark.cuda
def test_the_leg_equals_the_reference_lanes_on_a_card(monkeypatch):
    """On the card: kernel 6 through the leg, at the cell's window and
    warm-up, 4,096 streams, two launches at 4 dB, every lane against the
    reference computed on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernel 6 has no CPU mode)")
    dev = torch.device("cuda", 0)
    launched = []
    inner = streaming.mc_longframe_viterbi

    def tap(*args, **kwargs):
        out = inner(*args, **kwargs)
        launched.append(torch.stack(out).to(torch.int64).cpu())
        return out

    monkeypatch.setattr(streaming, "mc_longframe_viterbi", tap)
    lanes, window, warmup = 4096, 1920, 128
    spec = SweepSpec(code="nasa-k7", channel="awgn", points=[4.0], frames_per_step=lanes,
                     bits_per_point=lanes * window * 3, seed=2 ** 31 + 5,
                     stream_window=window, stream_warmup=warmup)
    (rec,) = run_sweep(spec, verbose=False, device="cuda")
    cfg = _config("awgn")
    code = CodeSpec.from_config(cfg)
    plan = lf_ref.launches(code, {"frames_per_step": lanes, "window": window,
                                  "bits_per_point": rec.bits}, spec.seed)
    assert len(launched) == len(plan) == 2
    for la, got in zip(plan, launched):
        want = lf_ref.lane_counters(code, cfg, 4.0, la, torch.arange(lanes), window, warmup,
                                    dev)
        assert torch.equal(got, want)
    assert rec.bit_errors == sum(int(g[0].sum()) for g in launched)
