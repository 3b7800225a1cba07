"""PyTorch port, sweep and CLI: counters against the JAX package's fused
accumulation and its sequential decoders, BER against the published
curves, checkpoint interchangeability and the CLI's device handling.

Tolerances: BSC counters exactly (the same hash streams, chunk seeds and
frame addressing as the JAX kernels); BER within the clustered |z| < 4.5 of
tests/test_ber_statistical.py.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from convolutional_codes_tpu.models.codebook import get_code as jax_code
from convolutional_codes_tpu.ops import fano as jfano
from convolutional_codes_tpu.ops import mc_datagen as jmcdg
from convolutional_codes_tpu.ops import stack as jstack
from convolutional_codes_tpu.parallel.montecarlo import fused_mc_accumulate as jax_fused
from convolutional_codes_tpu.sim import sweep as jsweep
from convolutional_codes_tpu_torch.models.codebook import get_code
from convolutional_codes_tpu_torch.ops.channels import awgn_sigma
from convolutional_codes_tpu_torch.parallel import montecarlo
from convolutional_codes_tpu_torch.sim import cli
from convolutional_codes_tpu_torch.sim.chain import make_point_step
from convolutional_codes_tpu_torch.sim.sweep import (
    SweepSpec, _spec_fingerprint, run_sweep, seq_plan)
from convolutional_codes_tpu_torch.utils.records import octave_rows, read_jsonl

from test_ber_statistical import check

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_bsc_sweep_counters_equal_jax_fused():
    spec = SweepSpec(code=0, channel="bsc", points=[0.02, 0.05],
                     frames_per_step=1024, bits_per_point=3 * 1024 * 40, seed=5)
    recs = run_sweep(spec, verbose=False, device="cpu")
    code = jax_code(0)
    for i, (rec, p) in enumerate(zip(recs, spec.points)):
        # the sweep's partition of 3 steps: a cold chunk of 1, then 2
        be = fe = nb = 0
        for ci, n in enumerate((1, 2)):
            seed = (spec.seed * 1000003 + i * 7919 + ci) & 0x7FFFFFFF
            cbe, cfe, cnb = jax_fused(code, n, seed, p, 1024, channel="bsc",
                                      interpret=True)
            be, fe, nb = be + cbe, fe + cfe, nb + cnb
        assert (rec.bit_errors, rec.frame_errors, rec.bits) == (be, fe, nb)
        assert rec.bits == 3 * 1024 * 40 and rec.warm_bits == 2 * 1024 * 40


@pytest.mark.parametrize("demapper,row", [("soft", "ber_coded_a"), ("hard", "ber_coded_ah")])
def test_awgn_fused_sweep_matches_published(demapper, row):
    spec = SweepSpec(code=0, channel="awgn", demapper=demapper, points=[4.0],
                     frames_per_step=2048, bits_per_point=4e5, seed=99)
    (rec,) = run_sweep(spec, verbose=False, device="cpu")
    assert rec.bits >= 4e5
    check(rec, "awgn", row)


def test_modular_leg_for_codes_the_fused_kernel_turns_away():
    """T > 256 leaves the fused kernel's per-thread arrays, so the sweep
    takes the modular chain; for the non-catastrophic (7,5) code its BER
    on 300-bit blocks agrees with the fused leg's on 40-bit blocks
    (clustered |z| < 4.5)."""
    short = get_code("k3-75")
    long = short.replace(name="k3-75-long", block_length=300)
    assert montecarlo.fused_mc_eligible(short, "bsc", "viterbi", "soft")
    assert not montecarlo.fused_mc_eligible(long, "bsc", "viterbi", "soft")
    recs = [run_sweep(SweepSpec(code=c, channel="bsc", points=[0.03], frames_per_step=fr,
                                bits_per_point=3e5, seed=3), verbose=False, device="cpu")[0]
            for c, fr in ((short, 2048), (long, 256))]
    assert recs[1].bits == 4 * 256 * 300
    var = sum(max(1.0, r.bit_errors / max(r.frame_errors, 1)) * r.ber * (1 - r.ber) / r.bits
              for r in recs)
    assert abs(recs[0].ber - recs[1].ber) < 4.5 * np.sqrt(var)


def test_modular_step_matches_published():
    step = make_point_step(get_code(0), "awgn", "viterbi", frames=2048, device="cpu")
    gen = torch.Generator().manual_seed(8)
    be, fe, nb = montecarlo.sharded_accumulate(step, 5, gen, float(awgn_sigma(4.0)))

    class Rec:
        point, bits, bit_errors, frame_errors, ber = 4.0, nb, be, fe, be / nb
        frames = nb // 40
    check(Rec, "awgn", "ber_coded_a")


def test_uncoded_sweep_closed_form():
    spec = SweepSpec(code=0, channel="uncoded", points=[4.0],
                     frames_per_step=1 << 15, bits_per_point=2e6, seed=5)
    (r,) = run_sweep(spec, verbose=False, device="cpu")
    p = 1.2494e-2                          # published, awgn_channel.m:5
    assert abs(r.bit_errors - r.bits * p) < 4 * np.sqrt(r.bits * p * (1 - p))
    assert r.code == "uncoded-2bit" and r.decoder == "argmin"


def test_unported_legs_raise(tmp_path):
    """No leg raises any more: ``trace_dir`` writes a trace (profiling is
    ported), and the stack/Fano steps of supplied symbols build for the
    card."""
    run_sweep(SweepSpec(points=[4.0], frames_per_step=64, bits_per_point=2e4,
                        trace_dir=str(tmp_path)), verbose=False, device="cpu")
    assert list((tmp_path / "point_4").glob("*.pt.trace.json"))
    for decoder in ("stack", "fano"):     # supplied-symbol decode on the card: kernels 9-10
        assert callable(make_point_step(get_code(0), "awgn", decoder, device="cuda"))


@pytest.mark.parametrize("decoder,points,tpb", [("stack", [0.03, 0.06], 10000),
                                                ("fano", [0.02, 0.04], 40)])
def test_sequential_sweep_counters_equal_jax(decoder, points, tpb):
    """Two BSC points at 1024 lanes and 2 frames per lane: the cold slice
    (point seed) and the warm slice (seed ^ 0x2A5A5A5A) address frames as
    the reference's sequential leg does, so the counters equal the JAX XLA
    decoders on the JAX package's own frames for those seeds and gids."""
    spec = SweepSpec(code=0, channel="bsc", decoder=decoder, points=points,
                     bits_per_point=2 * 1024 * 40, seed=21, timeout_per_bit=tpb)
    recs = run_sweep(spec, verbose=False, device="cpu")
    jc = jax_code(0)
    dec = ((lambda x: jstack.stack_decode_hard(jc, x)) if decoder == "stack"
           else (lambda x: jfano.fano_decode_hard(jc, x, tpb)))
    for i, (rec, p) in enumerate(zip(recs, points)):
        seed = (spec.seed * 1000003 + i * 7919) & 0x7FFFFFFF
        be = fe = 0
        for s in (seed, seed ^ 0x2A5A5A5A):        # 1024 lanes x 1 frame each
            bits, syms = jmcdg.frames_host(jc, np.arange(1024), s, p, "bsc")
            err = (np.asarray(dec(syms)) != bits[:, :40]).sum(axis=1)
            be, fe = be + int(err.sum()), fe + int((err > 0).sum())
        assert (rec.bit_errors, rec.frame_errors, rec.bits) == (be, fe, 2 * 1024 * 40)
        assert rec.warm_bits == 1024 * 40 and rec.decoder == decoder and be > 0


def test_two_slice_point_reports_the_warm_slice():
    """A stack point of 1024 lanes x 3 frames: the warm slice (2 frames a
    lane) runs in the same call as the cold one, and the record still
    reports its bits as ``warm_bits``, its time as ``warm_wall_s`` and
    their ratio as the rate."""
    spec = SweepSpec(code=0, channel="bsc", decoder="stack", points=[0.03],
                     bits_per_point=3 * 1024 * 40, seed=8)
    (rec,) = run_sweep(spec, verbose=False, device="cpu")
    assert rec.bits == 3 * 1024 * 40 and rec.warm_bits == 2 * 1024 * 40
    assert 0 < rec.warm_wall_s and rec.bits_per_s == rec.warm_bits / rec.warm_wall_s


def test_seq_plan_matches_reference():
    assert seq_plan(8e8, 40) == (8192, 2442)
    assert seq_plan(8 * 10 ** 5, 40) == (8192, 3)
    assert seq_plan(81920, 40) == (1024, 2)
    assert seq_plan(100, 40) == (1024, 1)


def test_stack_fingerprint_equals_jax():
    kw = dict(code="k9-r12", channel="awgn", decoder="stack", points=[4.0],
              base_bits=8e7, seed=1234)
    assert _spec_fingerprint(SweepSpec(**kw), get_code("k9-r12")) == \
        jsweep._spec_fingerprint(jsweep.SweepSpec(**kw), jax_code("k9-r12"))


def test_fingerprint_equals_jax_and_jax_checkpoint_resumes(tmp_path):
    kw = dict(code=0, channel="bsc", points=[0.05], frames_per_step=1024,
              bits_per_point=40960, seed=17)
    fp = _spec_fingerprint(SweepSpec(**kw), get_code(0))
    assert fp == jsweep._spec_fingerprint(jsweep.SweepSpec(**kw), jax_code(0))
    stored = dict(code="k3-r12", channel="bsc", decoder="viterbi", demapper="soft",
                  point=0.05, param=0.05, bits=40960, bit_errors=12345,
                  frame_errors=77, frames=1024, ber=12345 / 40960, fer=77 / 1024,
                  wall_s=1.0, bits_per_s=40960.0, warm_bits=0, warm_wall_s=0.0)
    ckpt = tmp_path / "ck.json"
    ckpt.write_text(json.dumps({"0.05": stored, "__spec__": fp}))
    (rec,) = run_sweep(SweepSpec(**kw), checkpoint_path=str(ckpt), verbose=False,
                       device="cpu")
    assert rec.bit_errors == 12345             # resumed, not recomputed
    ckpt.write_text(json.dumps({"__spec__": "0" * 16}))
    with pytest.raises(ValueError, match="different"):
        run_sweep(SweepSpec(**kw), checkpoint_path=str(ckpt), verbose=False, device="cpu")


def test_cli_cpu_writes_reference_schema(tmp_path):
    out, octave = tmp_path / "bsc.jsonl", tmp_path / "bsc.m"
    rc = cli.main(["bsc", "--code", "0", "--cpu", "--points", "0.05", "0.1",
                   "--frames", "1024", "--bits-per-point", "40960",
                   "--jsonl", str(out), "--octave", str(octave)])
    assert rc == 0
    rows = read_jsonl(str(out))
    with open(os.path.join(REPO, "results", "bsc_viterbi_0.jsonl")) as f:
        ref_keys = list(json.loads(f.readline()).keys())
    assert [list(r.keys()) for r in rows] == [ref_keys, ref_keys]
    assert octave.read_text().count("bsc_viterbi_k3_r12") == 3


def test_octave_rows_format():
    class R:
        point, ber, fer = 0.05, 0.125, 0.5
    assert octave_rows([R], "v") == "x_v = [0.05];\nv = [0.125];\nv_fer = [0.5];\n"


def test_cli_without_gpu_exits_nonzero(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-m", "convolutional_codes_tpu_torch.sim.cli", "bsc",
         "--points", "0.05", "--bits-per-point", "40960",
         "--jsonl", str(tmp_path / "x.jsonl")],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "--cpu" in proc.stderr
    assert not (tmp_path / "x.jsonl").exists()


def test_cli_unported_flags_raise(tmp_path):
    """A CPU mesh needs every axis size; ``--trace`` is ported and traces."""
    with pytest.raises(ValueError, match="every axis size"):
        cli.main(["awgn", "--cpu", "--mesh", "frames=-1"])
    assert cli.main(["awgn", "--cpu", "--points", "4", "--frames", "64",
                     "--bits-per-point", "2e4", "--trace", str(tmp_path)]) == 0
    assert list((tmp_path / "point_4").glob("*.pt.trace.json"))
