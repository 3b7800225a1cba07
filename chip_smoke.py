#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``convolutional_codes_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure:
  1. environment: the card's name and power limit, torch, CUDA, nvcc, Triton;
  2. build: compile the CUDA kernels from ``convolutional_codes_tpu_torch/csrc``;
  3. kernels against their plain PyTorch versions on the card: the Viterbi
     ACS and traceback kernels on the Viterbi goldens and on random inputs
     (bit-exact), the fused Monte-Carlo kernel on the BSC golden counters
     and against its plain version (BSC exact, AWGN at most 1% of lanes
     different — log/sqrt/sin/cos differ in the last ulp);
  4. the main path: the CLI's code-0 AWGN and BSC Viterbi sweeps (fused
     kernel) and the modular chain (ACS + traceback kernels), with launch
     counters reset before and read after; every point with a published
     BER must pass the clustered z-check (|z| < 4.5);
  5. throughput at the headline shape (code 0, 8 dB, 2^20 lanes, 16
     in-kernel steps) and each kernel's time beside its plain version's.

The last line is ``{"ok": true, "device": {...}}``; the line before it
lists every kernel with its launches on the main path, its largest
difference from the plain version and both times.  Without CUDA, or
without the package beside it, the script exits non-zero and prints no
result.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDENS = os.path.join(ROOT, "tests", "goldens")
C_CORE_BITS_PER_S = 6.6e6        # reference C core, AWGN soft Viterbi (BASELINE.md)
PUBLISHED_BER_8DB = 1.3756e-4    # results/awgn_channel.m, code 0 at 8 dB
Z_MAX = 4.5


def require(cond, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def phase(name: str):
    """Context manager printing the wall time of a phase."""
    class _Phase:
        def __enter__(self):
            self.t0 = time.time()
            print(f"== {name}", flush=True)

        def __exit__(self, *exc):
            if exc[0] is None:
                print(f"== {name}: {time.time() - self.t0:.1f} s", flush=True)
    return _Phase()


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds of ``fn()`` over ``reps`` calls (CUDA events)."""
    import torch
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# ---------------------------------------------------------------- z-check
def z_score(rec, channel: str, row: str, gold: dict):
    """Clustered z of a record against a published row (the check of
    tests/test_ber_statistical.py); None where the published BER is 0."""
    from convolutional_codes_tpu_torch.sim.sweep import awgn_tier_bits, bsc_tier_bits
    grid = gold[channel]["SNR" if channel == "awgn" else "ber_uncoded"]
    idx = min(range(len(grid)), key=lambda j: abs(grid[j] - rec.point))
    p_pub = gold[channel][row][idx]
    if p_pub <= 0:
        return None
    n_pub = (awgn_tier_bits if channel == "awgn" else bsc_tier_bits)(rec.point)
    if rec.bit_errors == 0:
        frame_bits = rec.bits / max(rec.frames, 1)
        return -math.sqrt(p_pub * rec.bits / max(1.0, frame_bits / 4))
    cluster = max(1.0, rec.bit_errors / max(rec.frame_errors, 1))
    var = cluster * ((rec.ber * (1 - rec.ber)) / rec.bits
                     + (p_pub * (1 - p_pub)) / n_pub)
    return (rec.ber - p_pub) / math.sqrt(var) if var else 0.0


# ---------------------------------------------------------------- phases
def check_viterbi_kernels(torch, dev, stats):
    """Kernels 1-2: goldens through the decoders, and exact agreement with
    the plain versions on random soft and tie-heavy hard inputs."""
    from convolutional_codes_tpu_torch import get_code
    from convolutional_codes_tpu_torch.ops import viterbi_cuda as vc
    from convolutional_codes_tpu_torch.ops.viterbi import (
        BIG_METRIC, HARD_METRIC_SAT, viterbi_decode_hard, viterbi_decode_soft)

    for idx in (0, 1, 2, 3, 5):
        code = get_code(idx)
        for mode in (0, 1):
            g = np.load(os.path.join(GOLDENS, f"viterbi_soft_{idx}_m{mode}.npz"))
            out = viterbi_decode_soft(code, torch.as_tensor(g["dists"], device=dev))
            require(np.array_equal(out.cpu().numpy(), g["decoded"]),
                    f"soft Viterbi golden {idx} m{mode}")
            g = np.load(os.path.join(GOLDENS, f"viterbi_hard_{idx}_m{mode}.npz"))
            bits, metric = viterbi_decode_hard(code, torch.as_tensor(g["received"], device=dev))
            require(np.array_equal(bits.cpu().numpy(), g["decoded"]),
                    f"hard Viterbi golden {idx} m{mode}")
            require(np.array_equal(metric.cpu().numpy(), g["metrics"]),
                    f"hard Viterbi golden metric {idx} m{mode}")
    print("viterbi goldens: 20/20 files bit-exact (bits and hard metrics)")

    rng = np.random.default_rng(2024)
    # k3-r12 at the modular main path's batch (16384 frames), S=64 and S=256
    for name, B in (("k3-r12", 16384), ("nasa-k7", 4096), ("k9-r12", 4096)):
        code = get_code(name)
        T, M, S = code.num_block_symbols, code.points_per_symbol, code.num_states
        for hard in (False, True):
            if hard:   # integer Hamming metrics: ties everywhere
                d = rng.integers(0, code.symlen_out + 1, (T, M, B)).astype(np.float32)
            else:
                d = rng.uniform(0.0, 8.0, (T, M, B)).astype(np.float32)
            dists = torch.as_tensor(d, device=dev)
            init = torch.full((S, B), float(HARD_METRIC_SAT) if hard else BIG_METRIC,
                              device=dev)
            init[0] = 0.0
            fm, dec = vc.acs_forward_cuda(code, dists, init, hard)
            fm_r, dec_r = vc.acs_forward_ref(code, dists, init, hard)
            err = float((fm - fm_r).abs().max())
            require(err == 0.0 and torch.equal(dec, dec_r),
                    f"ACS kernel vs plain {name} hard={hard}: max err {err}, "
                    f"{int((dec != dec_r).sum())} decision words differ")
            bits, best = vc.traceback_cuda(code, dec, fm)
            bits_r, best_r = vc.traceback_ref(code, dec, fm)
            require(torch.equal(bits, bits_r) and torch.equal(best, best_r),
                    f"traceback kernel vs plain {name} hard={hard}")
            stats["acs_forward"] = max(stats["acs_forward"], err)
            stats["traceback"] = max(stats["traceback"],
                                     float((bits - bits_r).abs().max()))
        print(f"viterbi kernels vs plain {name} (S={S}, B={B}): soft and hard "
              "bit-exact (tolerance 0)")


def check_fused_kernel(torch, dev, stats):
    """Kernel 3: BSC goldens exactly, kernel against plain exactly on BSC,
    and at most 1% of lanes different on AWGN."""
    from convolutional_codes_tpu_torch import get_code
    from convolutional_codes_tpu_torch.ops.channels import awgn_sigma
    from convolutional_codes_tpu_torch.ops.fused_chain import (
        mc_chain_viterbi, mc_chain_viterbi_ref)

    gold = np.load(os.path.join(GOLDENS, "fused_interp_counters.npz"))
    s6, s4 = float(awgn_sigma(6.0)), float(awgn_sigma(4.0))
    golden_cases = [(0, "bsc", "soft", 0.0125), (1, "bsc", "soft", 0.05),
                    (0, "awgn", "soft", s6), (0, "awgn", "hard", s6),
                    (5, "awgn", "soft", s4), ("nasa-k7", "awgn", "soft", s4)]
    for ck, ch, dm, p in golden_cases:
        code = get_code(ck)
        e, f = mc_chain_viterbi(code, 128, 2, 11, p, ch, block_lanes=128,
                                demapper=dm, device=dev)
        key = f"{code.name}_{ch}_{dm}"
        diff = int(((e.cpu().numpy() != gold[key + "_e"])
                    | (f.cpu().numpy() != gold[key + "_f"])).sum())
        print(f"fused golden {key}: {diff}/128 lanes differ")
        require(diff == 0 if ch == "bsc" else diff <= 1,
                f"fused golden {key}: {diff} lanes differ")

    def compare(code, batch, nsteps, seed, p, ch, dm):
        kw = dict(channel=ch, block_lanes=1024, demapper=dm, device=dev)
        e, f = mc_chain_viterbi(code, batch, nsteps, seed, p, **kw)
        e_r, f_r = mc_chain_viterbi_ref(code, batch, nsteps, seed, p, **kw)
        lanes = int(((e != e_r) | (f != f_r)).sum())
        err = float(torch.maximum((e - e_r).abs(), (f - f_r).abs()).max())
        stats["mc_chain"] = max(stats["mc_chain"], err)
        print(f"fused kernel vs plain {code.name} {ch}/{dm} batch {batch}: "
              f"{lanes}/{batch} lanes differ, max |counter diff| {err:g}, "
              f"bit errors {int(e.sum())}")
        require(lanes == 0 if ch == "bsc" else lanes <= batch // 100,
                f"fused kernel vs plain {code.name} {ch}/{dm}: {lanes} lanes differ")

    for name in ("k3-r12", "k4-r12", "k9-r12"):
        compare(get_code(name), 8192, 2, 7, 0.05, "bsc", "soft")
    for ck, dm, p in ((0, "soft", s6), (0, "hard", s6), (5, "soft", s4),
                      ("nasa-k7", "soft", s4)):
        compare(get_code(ck), 8192, 2, 7, p, "awgn", dm)
    # at the main path's shape: 2^20 lanes, tile 1024
    compare(get_code(0), 1 << 20, 1, 5, 0.0125, "bsc", "soft")
    compare(get_code(0), 1 << 20, 1, 5, float(awgn_sigma(8.0)), "awgn", "soft")


def run_main_path(torch, dev, gold, tmp):
    """The CLI's two code-0 sweeps and the modular chain; returns the
    z-checked rows."""
    from convolutional_codes_tpu_torch import get_code
    from convolutional_codes_tpu_torch.ops.channels import awgn_sigma
    from convolutional_codes_tpu_torch.parallel.montecarlo import sharded_accumulate
    from convolutional_codes_tpu_torch.sim import cli
    from convolutional_codes_tpu_torch.sim.chain import make_point_step
    from convolutional_codes_tpu_torch.sim.sweep import PointRecord
    from convolutional_codes_tpu_torch.utils.records import read_jsonl

    results = []
    for channel, scale in (("awgn", "0.1"), ("bsc", "0.01")):
        path = os.path.join(tmp, f"{channel}_viterbi_0.jsonl")
        rc = cli.main([channel, "--code", "0", "--decoder", "viterbi",
                       "--frames", "1048576", "--bits-scale", scale, "--jsonl", path])
        require(rc == 0, f"cli {channel} returned {rc}")
        results += [(channel, r) for r in read_jsonl(path, PointRecord)]

    code = get_code(0)
    frames, nsteps = 16384, 4
    for channel, point, param in (("awgn", 4.0, float(awgn_sigma(4.0))),
                                  ("bsc", 0.05, 0.05)):
        step = make_point_step(code, channel, "viterbi", frames=frames, device=dev)
        gen = torch.Generator(device=dev).manual_seed(31)
        t0 = time.time()
        be, fe, nb = sharded_accumulate(step, nsteps, gen, param)
        wall = time.time() - t0
        results.append((channel, PointRecord(
            code=code.name, channel=channel, decoder="viterbi-modular",
            demapper="soft", point=point, param=param, bits=nb, bit_errors=be,
            frame_errors=fe, frames=nb // code.block_length, ber=be / nb,
            fer=fe / (nb // code.block_length), wall_s=wall, bits_per_s=nb / wall)))
    return results


def check_points(results, gold):
    for channel, r in results:
        z = z_score(r, channel, "ber_coded_a", gold)
        ztxt = "n/a (published 0)" if z is None else f"{z:+.2f}"
        print(f"  {channel} {r.decoder} point={r.point:g} bits={r.bits} "
              f"errors={r.bit_errors} BER={r.ber:.4e} z={ztxt} "
              f"warm bits/s={r.bits_per_s:.4e}")
        require(z is None or abs(z) < Z_MAX,
                f"{channel} point {r.point}: BER {r.ber:.4e}, z={ztxt}")


def measure(torch, dev, card):
    """Headline throughput and each kernel's time beside its plain version."""
    from convolutional_codes_tpu_torch import get_code
    from convolutional_codes_tpu_torch.ops import viterbi_cuda as vc
    from convolutional_codes_tpu_torch.ops.channels import awgn_sigma
    from convolutional_codes_tpu_torch.ops.fused_chain import (
        mc_chain_viterbi, mc_chain_viterbi_ref)
    from convolutional_codes_tpu_torch.ops.viterbi import BIG_METRIC

    code = get_code(0)
    L = code.block_length
    sigma = float(awgn_sigma(8.0))
    B, nsteps, calls = 1 << 20, 16, 4
    times = {}

    mc_chain_viterbi(code, B, nsteps, 1, sigma, device=dev)       # warm-up
    torch.cuda.synchronize()
    t0 = time.time()
    errs = [mc_chain_viterbi(code, B, nsteps, 100 + i, sigma, device=dev)[0]
            for i in range(calls)]
    torch.cuda.synchronize()
    dt = time.time() - t0
    bits = B * L * nsteps * calls
    rate = bits / dt
    ber = sum(int(e.sum()) for e in errs) / bits
    times["mc_chain"] = dt * 1e3 / (calls * nsteps)
    print(f"headline [{card}]: fused kernel, code 0 at 8 dB, {B} lanes x {nsteps} "
          f"steps x {calls} calls: {rate:.6e} info bits/s "
          f"({rate / C_CORE_BITS_PER_S:.1f}x the 6.6e6 C core), "
          f"BER {ber:.6e} vs published {PUBLISHED_BER_8DB:.4e}, "
          f"{times['mc_chain']:.3f} ms per step")

    mc_chain_viterbi_ref(code, B, 1, 1, sigma, device=dev)         # warm-up
    torch.cuda.synchronize()
    t0 = time.time()
    mc_chain_viterbi_ref(code, B, 2, 100, sigma, device=dev)
    torch.cuda.synchronize()
    plain = {"mc_chain": (time.time() - t0) * 1e3 / 2}
    print(f"plain fused chain [{card}]: {B} lanes x 2 steps: "
          f"{plain['mc_chain']:.3f} ms per step, "
          f"{B * L / plain['mc_chain'] * 1e3:.6e} info bits/s")

    Bv = 262144
    T, M, S = code.num_block_symbols, code.points_per_symbol, code.num_states
    g = torch.Generator(device=dev).manual_seed(3)
    dists = torch.rand((T, M, Bv), generator=g, device=dev) * 8.0
    init = torch.full((S, Bv), BIG_METRIC, device=dev)
    init[0] = 0.0
    fm, dec = vc.acs_forward_cuda(code, dists, init, False)
    times["acs_forward"] = cuda_ms(lambda: vc.acs_forward_cuda(code, dists, init, False), 20)
    plain["acs_forward"] = cuda_ms(lambda: vc.acs_forward_ref(code, dists, init, False), 3)
    times["traceback"] = cuda_ms(lambda: vc.traceback_cuda(code, dec, fm), 20)
    plain["traceback"] = cuda_ms(lambda: vc.traceback_ref(code, dec, fm), 3)
    for k in ("acs_forward", "traceback"):
        print(f"{k} [{card}]: code 0, B={Bv}: kernel {times[k]:.4f} ms, "
              f"plain {plain[k]:.4f} ms")
    return times, plain


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script needs "
              "an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    t_start = time.time()
    dev = torch.device("cuda", 0)

    with phase("1 environment"):
        card = card_line()
        print(f"card: {card}")
        nvcc_out = subprocess.run(["/usr/local/cuda/bin/nvcc", "--version"],
                                  capture_output=True, text=True, timeout=60).stdout
        print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
              f"torch.version.cuda {torch.version.cuda}, "
              f"nvcc: {nvcc_out.strip().splitlines()[-1] if nvcc_out else 'missing'}")
        try:
            import triton
            print(f"triton {triton.__version__} imports")
        except ImportError as e:
            print(f"triton does not import: {e}")

    from convolutional_codes_tpu_torch.ops import viterbi_cuda as vc
    from convolutional_codes_tpu_torch.ops import fused_chain as fc
    from convolutional_codes_tpu_torch.utils import build

    with phase("2 build"):
        build.build_all()
        for name in build.LIBRARIES:
            print(f"built {name}.cu in {build.build_seconds[name]:.1f} s")

    wrappers = {"acs_forward": vc.acs_forward_cuda, "traceback": vc.traceback_cuda,
                "mc_chain": fc.mc_chain_viterbi}
    stats = {k: 0.0 for k in wrappers}
    with phase("3 kernels against their plain versions"):
        check_viterbi_kernels(torch, dev, stats)
        check_fused_kernel(torch, dev, stats)
        for k, w in wrappers.items():
            require(w.launches > 0, f"kernel {k} was never launched")
        print("launches in the checks: " + ", ".join(
            f"{k}={w.launches}" for k, w in wrappers.items()))

    with open(os.path.join(GOLDENS, "published_curves.json")) as f:
        gold = json.load(f)
    with phase("4 main path"), tempfile.TemporaryDirectory() as tmp:
        for w in wrappers.values():
            w.launches = 0
        results = run_main_path(torch, dev, gold, tmp)
        launches = {k: w.launches for k, w in wrappers.items()}
        print("launches on the main path: " + ", ".join(
            f"{k}={n}" for k, n in launches.items()))
        for k, n in launches.items():
            require(n > 0, f"kernel {k} was not launched on the main path")
        check_points(results, gold)

    with phase("5 throughput"):
        card = card_line()
        times, plain = measure(torch, dev, card)

    require("jax" not in sys.modules, "the port imported JAX")
    print(f"total wall {time.time() - t_start:.1f} s")
    sources = {"acs_forward": ("convolutional_codes_tpu_torch/csrc/viterbi.cu",
                               "convolutional_codes_tpu/ops/viterbi_pallas.py:86"),
               "traceback": ("convolutional_codes_tpu_torch/csrc/viterbi.cu",
                             "convolutional_codes_tpu/ops/viterbi_pallas.py:207"),
               "mc_chain": ("convolutional_codes_tpu_torch/csrc/fused_chain.cu",
                            "convolutional_codes_tpu/ops/fused_chain.py:400")}
    kernels = [{"name": k, "route": "cuda", "source": sources[k][0],
                "replaces": sources[k][1], "launches": launches[k],
                "max_abs_err": stats[k], "ms": times[k], "plain_ms": plain[k]}
               for k in wrappers]
    print(f"card: {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
