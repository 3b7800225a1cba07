"""The port's recordings of the reference's published BER curves, and the
comparator that holds them to the published tables.

``results/*.jsonl`` holds the 55 grids the JAX package recorded on a TPU
at the reference's full sample tiers.  This module records the same grids
through the port's CLI (``sim/cli.py``, in process: one kernel build for
all) into ``results_torch/<name>.jsonl``, in the ``utils/records.py``
schema, and compares each with the published tables
(``tests/goldens/published_curves.json``) by the cluster-corrected z-test
of the JAX package's ``tools/reproduce_curves.py`` (copied here with its
``CONFIGS``, ``Z_THRESHOLD`` and fresh-reference lookup: that tool imports
the JAX package).  Two more checks:

* ``EXACT``: the BSC stack and Fano grids.  Their committed records came
  from the JAX package's coordinate-hash datagen (``ops/mc_datagen.py``)
  with the sweep's per-point seeds from seed 1234, which the port's
  kernels generate bit for bit (integer hash, exact uniforms, integer
  flips), and the same lane plan (``sim/sweep.seq_plan``): each point's
  counters must equal the committed ones exactly.
* Grids with no published row (the 16-QAM extension): a two-sample
  clustered z against the JAX package's recording of the same grid.

Record on the card (all 55 grids took 96.4 s of grid walls on one H100
80GB HBM3 at 700 W, PERF.md; ``--budget`` stops
starting new grids after that many seconds, and names already recorded
in ``results_torch/`` or the output directory are skipped, so a cut run
resumes)::

    python -m convolutional_codes_tpu_torch.sim.reproduce --record \\
        [--out DIR] [--config NAME ...] [--budget SECONDS]

Check the recordings (any machine, no card; ``--out DIR`` checks those
under DIR instead of ``results_torch/``)::

    python -m convolutional_codes_tpu_torch.sim.reproduce [--out DIR]
"""

from __future__ import annotations

import argparse
import functools
import json
import math
import os
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

from convolutional_codes_tpu_torch.sim.sweep import PointRecord, awgn_tier_bits, bsc_tier_bits
from convolutional_codes_tpu_torch.utils import records as rec

REPO = Path(__file__).resolve().parents[2]
#: the JAX package's recordings and the reference's fresh reruns
RESULTS = REPO / "results"
#: the port's recordings
RESULTS_TORCH = REPO / "results_torch"
#: pass/fail acceptance on the clustered z-scores
Z_THRESHOLD = 4.5
#: the recordings' sweep seed (tools/reproduce_curves.py's SweepSpec)
SEED = 1234
#: frames per step of the grids that do not name theirs
FRAMES = 262144


@functools.lru_cache(maxsize=None)
def published() -> dict:
    """The reference's published tables (tests/goldens/published_curves.json)."""
    with open(REPO / "tests" / "goldens" / "published_curves.json") as f:
        return json.load(f)


CONFIGS = {
    # name: (spec kwargs, published row, channel)
    **{f"awgn_viterbi_soft_{i}": (dict(code=i, channel="awgn", decoder="viterbi",
                                       demapper="soft"), row, "awgn")
       for i, row in zip([0, 1, 2, 3, 5],
                         ["ber_coded_a", "ber_coded_b", "ber_coded_c",
                          "ber_coded_d", "ber_coded_e"])},
    **{f"awgn_viterbi_hard_{i}": (dict(code=i, channel="awgn", decoder="viterbi",
                                       demapper="hard"), row, "awgn")
       for i, row in zip([0, 1, 2, 3, 5],
                         ["ber_coded_ah", "ber_coded_bh", "ber_coded_ch",
                          "ber_coded_dh", "ber_coded_eh"])},
    **{f"bsc_viterbi_{i}": (dict(code=i, channel="bsc", decoder="viterbi"),
                            f"ber_coded_{c}", "bsc")
       for c, i in zip("abcde", [0, 1, 2, 3, 5])},
    "uncoded_2": (dict(code=0, channel="uncoded"), "ber_uncoded_2", "awgn"),
    "uncoded_3": (dict(code=5, channel="uncoded"), "ber_uncoded_3", "awgn"),
    # the 16-QAM extension (BASELINE.json config 5): no published row
    "uncoded_4": (dict(code="k15-r14-16qam", channel="uncoded"), None, "awgn"),
    "awgn_fano_16qam": (dict(code="k15-r14-16qam", channel="awgn",
                             decoder="fano", frames_per_step=16384,
                             points=(0.0, 2.0, 4.0, 5.0, 6.0, 7.0, 8.0,
                                     10.0, 12.0, 14.0)),
                        None, "awgn"),
    # the sequential decoders' full published grids, Fano budget 10000
    **{f"awgn_{dec}_{dm}_{i}": (dict(code=i, channel="awgn", decoder=dec,
                                     demapper=dm, frames_per_step=131072),
                                f"ber_coded_{c}{'h' if dm == 'hard' else ''}"
                                f"_{dec}",
                                "awgn")
       for dec in ("stack", "fano")
       for dm in ("soft", "hard")
       for c, i in zip("abcdef", [0, 1, 2, 3, 5, 4])},
    **{f"bsc_{dec}_{i}": (dict(code=i, channel="bsc", decoder=dec,
                               frames_per_step=131072),
                          f"ber_coded_{c}_{dec}", "bsc")
       for dec in ("stack", "fano")
       for c, i in zip("abcdef", [0, 1, 2, 3, 5, 4])},
}

#: grids whose every point must reproduce the committed counters exactly
EXACT = tuple(f"bsc_{dec}_{i}" for dec in ("stack", "fano") for i in range(6))


def tier_bits(channel: str):
    return awgn_tier_bits if channel == "awgn" else bsc_tier_bits


def scale_of(records, channel: str) -> float:
    """Fraction of the reference tier sample sizes simulated, the least over
    the points."""
    tier = tier_bits(channel)
    return min((r.bits / tier(r.point) for r in records), default=0.0)


def aggregate_bits_per_s(records) -> float:
    """Steady-state info bits/s of a grid: warm bits over warm wall, else
    bits over wall."""
    wb = sum(r.warm_bits for r in records)
    ww = sum(r.warm_wall_s for r in records)
    if wb and ww > 0:
        return wb / ww
    return sum(r.bits for r in records) / max(sum(r.wall_s for r in records), 1e-9)


def zscore(p_obs, n_obs, p_pub, n_pub, cluster=1.0):
    if p_obs == 0 and p_pub == 0:
        return 0.0
    var = cluster * ((p_obs * (1 - p_obs)) / max(n_obs, 1)
                     + (p_pub * (1 - p_pub)) / max(n_pub, 1))
    if var == 0:
        return float("inf") if p_obs != p_pub else 0.0
    return (p_obs - p_pub) / math.sqrt(var)


def _table_ulp(channel, row_name):
    """Print precision of the published table: the BSC Viterbi rows carry 6
    decimals, everything else 8."""
    if channel == "bsc" and not row_name.endswith(("_fano",)):
        return 1e-6
    return 1e-8


#: rows whose published tables deviate from the reference chain's own
#: ideal-channel behaviour (stale archive data; the reference BSC
#: sampler's rand()%1e6 artifact): their z is computed against the fresh
#: reruns in results/reference_fresh_*.json (README.md, "Not port faults"
#: in ROADMAP.md)
_FRESH_SOURCES = (
    ("reference_fresh_bsc.json",
     {("bsc", "ber_coded_b"): "code_1",
      ("bsc", "ber_coded_e"): "code_5"}),
    ("reference_fresh_bsc_seq.json",
     {("bsc", "ber_coded_c_stack"): "code_2",
      ("bsc", "ber_coded_d_stack"): "code_3",
      ("bsc", "ber_coded_f_stack"): "code_4",
      ("bsc", "ber_coded_d_fano"): "code_3_fano",
      ("bsc", "ber_coded_e_fano"): "code_5_fano",
      ("bsc", "ber_coded_f_fano"): "code_4_fano"}),
)


@functools.lru_cache(maxsize=None)
def _fresh_data(fname):
    try:
        with open(RESULTS / fname) as f:
            return json.load(f)
    except FileNotFoundError:
        return None


def _fresh_lookup(channel, row_name, point):
    for fname, rows in _FRESH_SOURCES:
        key = rows.get((channel, row_name))
        data = _fresh_data(fname) if key else None
        if data is None:
            continue
        for r in data["rows"].get(key, ()):
            if abs(r["crossover"] - point) < 1e-12:
                return r
    return None


def _cluster_for(records, i, min_events=10):
    """Bits per frame event of records[i], borrowed from the nearest point
    of the curve with at least ``min_events`` frame errors (errors arrive in
    per-frame bursts whose size the decoder and code set, not the SNR)."""
    order = sorted(range(len(records)), key=lambda j: (abs(j - i), j))
    for j in order:
        r = records[j]
        if r.frame_errors >= min_events:
            return max(1.0, r.bit_errors / r.frame_errors)
    return None


def compare(records, channel, row_name) -> Tuple[List[str], float]:
    """The cluster-corrected z of every record against the published row:
    (one line a point, the worst |z|)."""
    gold = published()
    pub = gold[channel][row_name]
    grid = gold[channel]["SNR" if channel == "awgn" else "ber_uncoded"]
    tier = tier_bits(channel)
    ulp = _table_ulp(channel, row_name)
    lines = []
    worst = 0.0
    for ri, r in enumerate(records):
        idx = min(range(len(grid)), key=lambda j: abs(grid[j] - r.point))
        p_pub = pub[idx]
        n_pub = tier(r.point)
        if p_pub == 0 and r.ber < ulp / 2:
            # printed 0 = anything below half an ulp
            z = 0.0
        elif r.bit_errors == 0 and p_pub > 0:
            # no errors: the expected count of frame events (Poisson) decides
            cl = _cluster_for(records, ri)
            if cl is None:
                cl = max(1.0, r.bits / max(r.frames, 1) / 4)
            lam = p_pub * r.bits / cl
            z = -math.sqrt(lam)
        else:
            cluster = _cluster_for(records, ri)
            if cluster is None:
                cluster = max(1.0, r.bit_errors / max(r.frame_errors, 1))
            p_ref = max(p_pub, ulp / 2)
            # clustered two-sample variance with the pooled proportion, plus
            # the table's rounding variance (uniform over one print ulp)
            p_pool = ((r.ber * r.bits + p_ref * n_pub)
                      / max(r.bits + n_pub, 1))
            denom2 = (cluster * p_pool * (1 - p_pool)
                      * (1.0 / max(r.bits, 1) + 1.0 / max(n_pub, 1))
                      + ulp * ulp / 12.0)
            z = (r.ber - p_ref) / math.sqrt(denom2)
        fresh = _fresh_lookup(channel, row_name, r.point)
        note = ""
        if fresh is not None:
            cluster = _cluster_for(records, ri)
            if cluster is None:
                cluster = max(1.0, r.bit_errors / max(r.frame_errors, 1))
            zf = zscore(r.ber, r.bits, fresh["ber"], fresh["bits"], cluster)
            if r.bit_errors == 0 and fresh["bit_errors"] == 0:
                zf = 0.0
            note = f"  fresh_ref={fresh['ber']:.6e} z_fresh={zf:+.2f}"
            z = zf
        worst = max(worst, abs(z))
        lines.append(f"  point={r.point:<10g} ours={r.ber:.6e} "
                     f"published={p_pub:.6e} z={z:+.2f}{note}")
    return lines, worst


def compare_recorded(records, reference) -> Tuple[List[str], float]:
    """Two-sample clustered z of each record against the JAX package's
    recording of the same point (the grids with no published row)."""
    by_point = {r.point: r for r in reference}
    lines, worst = [], 0.0
    for ri, r in enumerate(records):
        ref = by_point[r.point]
        cluster = _cluster_for(records, ri) or max(1.0, r.bit_errors / max(r.frame_errors, 1))
        z = zscore(r.ber, r.bits, ref.ber, ref.bits, cluster)
        worst = max(worst, abs(z))
        lines.append(f"  point={r.point:<10g} ours={r.ber:.6e} recorded={ref.ber:.6e} "
                     f"z={z:+.2f}")
    return lines, worst


def load(name: str, directory: Path = RESULTS_TORCH) -> Optional[list]:
    path = Path(directory) / f"{name}.jsonl"
    if not path.exists():
        return None
    return rec.read_jsonl(path, PointRecord)


def exact_diffs(records, reference) -> List[str]:
    """Points whose counters differ from the committed recording's."""
    ref = {r.point: r for r in reference}
    return [f"point {r.point:g}: ({r.bits}, {r.bit_errors}, {r.frame_errors}) vs "
            f"({ref[r.point].bits}, {ref[r.point].bit_errors}, {ref[r.point].frame_errors})"
            for r in records
            if r.point not in ref or (r.bits, r.bit_errors, r.frame_errors)
            != (ref[r.point].bits, ref[r.point].bit_errors, ref[r.point].frame_errors)]


def check(name: str, directory: Path = RESULTS_TORCH) -> Dict:
    """Every check of one grid: {"lines", "worst", "scale", "exact" (list of
    differing points, or None where not required), "problems"}."""
    kw, row, channel = CONFIGS[name]
    records = load(name, directory)
    if not records:
        return {"lines": [], "worst": float("inf"), "scale": 0.0, "exact": None,
                "problems": [f"missing {directory}/{name}.jsonl"]}
    reference = load(name, RESULTS)
    want = kw.get("points") or published()[channel][
        "SNR" if channel == "awgn" else "ber_uncoded"]
    problems = []
    if [r.point for r in records] != [float(p) for p in want]:
        problems.append(f"points {[r.point for r in records]} are not the grid's {list(want)}")
    if row is None:
        lines, worst = compare_recorded(records, reference)
    else:
        lines, worst = compare(records, channel, row)
    scale = scale_of(records, channel)
    exact = exact_diffs(records, reference) if name in EXACT else None
    if scale < 1.0:
        problems.append(f"scale {scale:.3g} of the reference tiers")
    if not worst < Z_THRESHOLD:
        problems.append(f"worst |z| {worst:.2f}")
    if exact:
        problems.append(f"counters differ from results/: {exact}")
    return {"lines": lines, "worst": worst, "scale": scale, "exact": exact,
            "problems": problems}


def cli_argv(name: str, jsonl: str) -> List[str]:
    """The port's CLI arguments that record grid ``name`` into ``jsonl``."""
    kw, _, channel = CONFIGS[name]
    argv = [kw["channel"], "--code", str(kw["code"]), "--seed", str(SEED),
            "--frames", str(kw.get("frames_per_step", FRAMES)), "--jsonl", jsonl]
    if kw["channel"] != "uncoded":
        argv += ["--decoder", kw["decoder"], "--demapper", kw.get("demapper", "soft")]
    if kw.get("points"):
        argv += ["--points", *map(str, kw["points"])]
    return argv


def record(names: Sequence[str], out: Path, budget: float = float("inf")) -> List[str]:
    """Record ``names`` through the port's CLI into ``out``, skipping those
    already in ``out`` or ``results_torch/``, and starting no grid after
    ``budget`` seconds.  Returns the names recorded."""
    from convolutional_codes_tpu_torch.sim import cli

    out.mkdir(parents=True, exist_ok=True)
    t0, done = time.time(), []
    for name in names:
        if (out / f"{name}.jsonl").exists() or (RESULTS_TORCH / f"{name}.jsonl").exists():
            print(f"=== {name}: recorded already", flush=True)
            continue
        if time.time() - t0 > budget:
            print(f"=== {name}: not started (budget of {budget:g} s spent)", flush=True)
            continue
        print(f"=== {name}", flush=True)
        t1 = time.time()
        tmp = out / f"{name}.jsonl.part"
        rc = cli.main(cli_argv(name, str(tmp)))
        if rc != 0:
            raise RuntimeError(f"the CLI returned {rc} on {name}")
        tmp.rename(out / f"{name}.jsonl")
        done.append(name)
        print(f"=== {name}: {time.time() - t1:.1f} s", flush=True)
    return done


def report(names: Sequence[str], directory: Path = RESULTS_TORCH) -> int:
    """Print every grid's comparison and a summary; returns the number of
    grids with a problem."""
    bad = 0
    for name in names:
        res = check(name, directory)
        print(f"=== {name}")
        print("\n".join(res["lines"]))
        records = load(name, directory) or []
        exact = ("" if res["exact"] is None
                 else " exact" if not res["exact"] else f" {len(res['exact'])} points off")
        print(f"  worst |z| = {res['worst']:.2f}, scale {res['scale']:.3g},"
              f"{exact} {aggregate_bits_per_s(records):.3e} bits/s" if records else "  missing")
        for p in res["problems"]:
            print(f"  PROBLEM: {p}")
        bad += bool(res["problems"])
    print(f"{len(names) - bad} of {len(names)} grids pass")
    return bad


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="convolutional_codes_tpu_torch.sim.reproduce")
    ap.add_argument("--record", action="store_true",
                    help="record the grids through the CLI (on the card) before checking")
    ap.add_argument("--config", nargs="*", default=None, help="grid names (default: all)")
    ap.add_argument("--out", type=str, default=None,
                    help="where --record writes and the check reads (default results_torch/)")
    ap.add_argument("--budget", type=float, default=float("inf"),
                    help="seconds after which --record starts no new grid")
    args = ap.parse_args(argv)
    names = args.config or list(CONFIGS)
    unknown = [n for n in names if n not in CONFIGS]
    if unknown:
        ap.error(f"unknown grid(s) {unknown}")
    directory = Path(args.out) if args.out else RESULTS_TORCH
    if args.record:
        record(names, directory, args.budget)
    return 1 if report(names, directory) else 0


if __name__ == "__main__":
    sys.exit(main())
