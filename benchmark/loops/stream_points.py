"""The long-frame stream loop: a closed loop of one link designer's sweep
of long streaming frames, one BER point after another through the port's
``run_sweep`` stream leg.

Each point is a one-point ``SweepSpec`` with the cell's code, channel,
demapper, ``frames_per_step`` streams, ``stream_window`` / ``stream_warmup``
(the workload's ``window`` and ``warmup``) and ``bits_per_point``, and a
fresh seed made from the run's seed and the point's index; points run
back to back until the window's seconds have passed, as
``sweep_points`` runs them (its window, tap and read-back are this loop's).

``correct`` compares what the timed path produced: the tap keeps the
per-lane counters of every launch of a sampled point (``sample.points``
drawn among the window's first points), and for each:
  * ``bits_gap``: the point's bits against the bits of the reference's
    plan of the point (``benchmark/reference/longframe.launches``);
  * ``launch_gap``: launches and lanes the program ran against the plan;
  * ``sum_gap``: the point's bit and window errors against the sum of its
    launches' per-lane counters;
  * ``lanes_off``: in ``sample.launches`` launches drawn from the seed
    (0: every launch), ``sample.lanes`` lanes drawn from the seed (0:
    every lane) whose counters over all of the launch's windows differ
    from the plain reference's.  ``k7-longframe-6db`` compares every lane
    of every launch: at 6 dB a point holds a few error events, and a
    kernel that drops or zeroes counters shows only on the lanes that
    hold them.
"""

from __future__ import annotations

import random
from typing import List, Tuple

from benchmark.loops import sweep_points
from benchmark.loops.sweep_points import lanes_differ, point_seed
from benchmark.reference import longframe as ref
from benchmark.reference.common import CodeSpec

#: keys of a workload file this loop reads
KEYS = {"traffic", "loop", "decoder", "point", "frames_per_step", "window", "warmup",
        "bits_per_point", "tap", "sample", "limits"}
CHECKS = ("bits_gap", "launch_gap", "sum_gap", "lanes_off")


def validate(wl: dict, cfg: dict) -> None:
    """Refuse a workload file this loop cannot run."""
    missing, extra = KEYS - set(wl), set(wl) - KEYS
    if missing or extra:
        raise ValueError(f"workload keys: missing {sorted(missing)}, unknown {sorted(extra)}")
    if wl["decoder"] != "viterbi":
        raise ValueError(f"decoder {wl['decoder']!r}: long streams run the Viterbi decoder")
    if ":" not in wl["tap"]:
        raise ValueError(f"tap {wl['tap']!r} is not module:function")
    if set(wl["limits"]) != set(CHECKS):
        raise ValueError(f"limits {sorted(wl['limits'])} against {CHECKS}")
    if set(wl["sample"]) != {"points", "launches", "lanes"}:
        raise ValueError("sample needs points, launches and lanes")
    if cfg["channel"] not in ("awgn", "bsc") or cfg["demapper"] not in ("soft", "hard"):
        raise ValueError("channel awgn or bsc, demapper soft or hard")
    for k in ("bits_per_point", "frames_per_step", "window"):
        if int(wl[k]) <= 0:
            raise ValueError(f"{k} must be positive")
    if int(wl["warmup"]) < 0:
        raise ValueError("warmup must not be negative")


def sample_lanes(wl: dict, plan, rng: random.Random) -> List[Tuple[int, List[int]]]:
    """(launch index, sorted lanes) to compare: ``sample.launches``
    launches (0: all), and in each ``sample.lanes`` lanes (0: all), drawn
    with ``rng``."""
    n = wl["sample"]["launches"] or len(plan)
    out = []
    for li in sorted(rng.sample(range(len(plan)), min(n, len(plan)))):
        lanes = plan[li].lanes
        k = min(lanes, wl["sample"]["lanes"] or lanes)
        out.append((li, sorted(rng.sample(range(lanes), k))))
    return out


def control_readings(cfg: dict, wl: dict, seed: int, device, low_dtype) -> dict:
    """The numbers the check compares with the reference computed in
    ``low_dtype`` as the program, against the float32 reference, on the
    sample of the point a run seeded ``seed`` draws first."""
    import torch
    code = CodeSpec.from_config(cfg)
    plan = ref.launches(code, wl, point_seed(seed, 0))
    out = {"lanes_off": 0}
    for li, lanes in sample_lanes(wl, plan, random.Random(f"{seed}:lanes")):
        args = (code, cfg, float(wl["point"]), plan[li], torch.tensor(lanes),
                int(wl["window"]), int(wl["warmup"]), device)
        want = ref.lane_counters(*args, dtype=torch.float32)
        got = ref.lane_counters(*args, dtype=low_dtype)
        out["lanes_off"] += lanes_differ(got, want)[0]
    return out


class Loop(sweep_points.Loop):
    def __init__(self, cfg: dict, wl: dict, device, seed: int):
        validate(wl, cfg)
        self.cfg, self.wl, self.device, self.seed = cfg, wl, device, int(seed)
        self.code = CodeSpec.from_config(cfg)
        self.records, self.spans, self.sampled = [], [], []
        self._taps = None

    def _run_point(self, seed: int):
        spec = self._SweepSpec(
            code=self.port_code, channel=self.cfg["channel"], decoder="viterbi",
            demapper=self.cfg["demapper"], points=[float(self.wl["point"])],
            frames_per_step=int(self.wl["frames_per_step"]),
            bits_per_point=int(self.wl["bits_per_point"]), seed=seed, trace_dir=None,
            stream_window=int(self.wl["window"]), stream_warmup=int(self.wl["warmup"]))
        return self._run_sweep(spec, mesh=None, checkpoint_path=None, verbose=False,
                               device=str(self.device))[0]

    def check(self, dtype=None) -> List[Tuple[str, float, float]]:
        """(name, number, limit) of every comparison, summed over the
        sampled points."""
        import torch
        dtype = dtype or torch.float32
        wl, limits = self.wl, self.wl["limits"]
        totals = {name: 0 for name in CHECKS}
        rng = random.Random(f"{self.seed}:lanes")
        for index, rec, prog in sorted(self.sampled, key=lambda s: s[0]):
            plan = ref.launches(self.code, wl, point_seed(self.seed, index))
            totals["bits_gap"] += abs(rec["bits"] - ref.launch_bits(wl, plan))
            shape_off = len(prog) != len(plan) or any(
                p.shape[1] != la.lanes for p, la in zip(prog, plan))
            totals["launch_gap"] += abs(len(prog) - len(plan)) + int(shape_off)
            totals["sum_gap"] += (abs(sum(int(p[0].sum()) for p in prog) - rec["bit_errors"])
                                  + abs(sum(int(p[1].sum()) for p in prog) - rec["frame_errors"]))
            for li, lanes in sample_lanes(wl, plan, rng):
                if shape_off:
                    totals["lanes_off"] += len(lanes)
                    continue
                want = ref.lane_counters(self.code, self.cfg, float(wl["point"]), plan[li],
                                         torch.tensor(lanes), int(wl["window"]),
                                         int(wl["warmup"]), self.device, dtype)
                totals["lanes_off"] += lanes_differ(prog[li][:, lanes], want)[0]
        return [(name, totals[name], limits[name]) for name in CHECKS]
