"""The Monte-Carlo sweep loop: a closed loop of one researcher's sweep,
one BER point after another through the port's ``run_sweep``.

Each point is a one-point ``SweepSpec`` with the cell's code, channel,
decoder, demapper, ``bits_per_point``, ``frames_per_step`` and
``timeout_per_bit``, and a fresh seed made from the run's seed and the
point's index; points run back to back until the window's seconds have
passed, and the point in flight finishes.

``correct`` compares what the timed path produced.  A tap wraps the kernel
entry the workload names (``"tap": "module:function"``), as the sweep's own
module calls it, and keeps the per-lane counters each launch returns for a
sample of the window's points drawn from the seed (``FIRST_POINTS``).  For
each sampled point:
  * ``bits_gap``: the point's bits against the bits its launches, as the
    reference plans them, simulate (exact);
  * ``launch_gap``: launches and lanes the program ran against the plan;
  * ``sum_gap``: the point's bit and frame errors against the sum of its
    launches' per-lane counters (exact);
  * ``lanes_off``: lanes, drawn from the seed, whose counters differ from
    the plain reference's (``benchmark/reference/<decoder>.py``, found
    from the workload's decoder); ``iters_off`` the same for the walks'
    iterations, where the workload compares them.
"""

from __future__ import annotations

import hashlib
import importlib
import random
import time
from typing import Dict, List, Optional, Tuple

from benchmark.reference.common import CodeSpec, launch_bits

#: keys of a workload file this loop reads
KEYS = {"traffic", "loop", "decoder", "point", "frames_per_step", "bits_per_point",
        "timeout_per_bit", "tap", "sample", "limits"}
CHECKS = ("bits_gap", "launch_gap", "sum_gap", "lanes_off", "iters_off")
#: the sampled points are drawn from the window's first points (the last
#: point stands in for a drawn one the window did not reach); a point that
#: is not drawn keeps nothing, so the sampling holds no memory across points
FIRST_POINTS = 8


def point_seed(seed: int, index: int) -> int:
    """The sweep seed of point ``index`` of a run seeded ``seed`` (index -1:
    the warm point)."""
    digest = hashlib.sha256(f"{int(seed)}:{int(index)}".encode()).digest()
    return int.from_bytes(digest[:4], "little") & 0x7FFFFFFF


def validate(wl: dict, cfg: dict) -> None:
    """Refuse a workload file this loop cannot run."""
    missing, extra = KEYS - set(wl), set(wl) - KEYS
    if missing or extra:
        raise ValueError(f"workload keys: missing {sorted(missing)}, unknown {sorted(extra)}")
    if wl["decoder"] not in ("viterbi", "stack", "fano"):
        raise ValueError(f"decoder {wl['decoder']!r}")
    if ":" not in wl["tap"]:
        raise ValueError(f"tap {wl['tap']!r} is not module:function")
    if set(wl["limits"]) - set(CHECKS) or not {"bits_gap", "launch_gap", "sum_gap",
                                                "lanes_off"} <= set(wl["limits"]):
        raise ValueError(f"limits {sorted(wl['limits'])} against {CHECKS}")
    if set(wl["sample"]) != {"points", "launches", "frames"}:
        raise ValueError("sample needs points, launches and frames")
    if cfg["channel"] not in ("awgn", "bsc") or cfg["demapper"] not in ("soft", "hard"):
        raise ValueError("channel awgn or bsc, demapper soft or hard")
    for k in ("bits_per_point", "frames_per_step", "timeout_per_bit"):
        if int(wl[k]) <= 0:
            raise ValueError(f"{k} must be positive")


def reference_module(decoder: str):
    return importlib.import_module(f"benchmark.reference.{decoder}")


def plan(code: CodeSpec, wl: dict, seed: int):
    """The reference's launches of the point seeded ``seed``."""
    return reference_module(wl["decoder"]).launches(code, wl, seed)


def sample_lanes(wl: dict, launches, rng: random.Random) -> List[Tuple[int, List[int]]]:
    """(launch index, sorted lanes) to compare: ``sample.launches`` launches
    (0: all), and in each the lanes that hold ``sample.frames`` frames (0:
    every lane), drawn with ``rng``."""
    n = wl["sample"]["launches"] or len(launches)
    chosen = sorted(rng.sample(range(len(launches)), min(n, len(launches))))
    out = []
    for li in chosen:
        la = launches[li]
        frames = wl["sample"]["frames"]
        if not frames:
            out.append((li, list(range(la.lanes))))
            continue
        k = min(la.lanes, -(-frames // la.steps))
        out.append((li, sorted(rng.sample(range(la.lanes), k))))
    return out


def lanes_differ(got, want) -> Tuple[int, int]:
    """(lanes whose bit or frame errors differ, lanes whose iterations
    differ) of per-lane counters [rows, lanes]; iterations where both have
    a third row."""
    lanes_off = int(((got[:2] != want[:2]).any(dim=0)).sum())
    iters_off = int((got[2] != want[2]).sum()) if min(len(got), len(want)) > 2 else 0
    return lanes_off, iters_off


def lane_tensor(out):
    """A launch's per-lane counters as int64 [rows, lanes] on the host."""
    import torch
    if isinstance(out, (tuple, list)):
        out = torch.stack([o.to(torch.int64) for o in out])
    return out.to(torch.int64).cpu()


class Loop:
    def __init__(self, cfg: dict, wl: dict, device, seed: int):
        validate(wl, cfg)
        self.cfg, self.wl, self.device, self.seed = cfg, wl, device, int(seed)
        self.code = CodeSpec.from_config(cfg)
        self.records: List[dict] = []
        self.spans: List[Tuple[float, float]] = []
        self.sampled: List[Tuple[int, dict, list]] = []
        self._taps: Optional[list] = None

    # ---------------------------------------------------------------- set-up
    def setup(self) -> None:
        """Import the port, build its code from the configuration, tap the
        kernel entry and run one warm point of the cell's shape."""
        from convolutional_codes_tpu_torch.models.codebook import Code
        from convolutional_codes_tpu_torch.models.tables import code_tables
        from convolutional_codes_tpu_torch.sim.sweep import SweepSpec, run_sweep
        import numpy as np

        c = self.cfg["code"]
        self.port_code = Code(
            name=c["name"], symlen_out=c["symlen_out"], constraint_length=c["constraint_length"],
            block_length=c["block_length"], polynomials=tuple(c["polynomials"]),
            bit_metrics=tuple(c["bit_metrics"]), fano_bit_metrics=tuple(c["fano_bit_metrics"]),
            metric_weight=c["metric_weight"], fano_metric_weight=c["fano_metric_weight"],
            parity=c["parity"])
        pts = code_tables(self.port_code).points_np
        if self.cfg["channel"] == "awgn" and not np.array_equal(
                pts, np.asarray(self.cfg["constellation"], np.float32)):
            raise ValueError("the port's constellation is not the configuration's")
        self._SweepSpec, self._run_sweep = SweepSpec, run_sweep
        mod_name, fn_name = self.wl["tap"].split(":")
        module = importlib.import_module(mod_name)
        inner = getattr(module, fn_name)

        def tapped(*args, **kwargs):
            out = inner(*args, **kwargs)
            if self._taps is not None:
                self._taps.append(out)
            return out

        setattr(module, fn_name, tapped)
        self._untap = lambda: setattr(module, fn_name, inner)
        self._run_point(point_seed(self.seed, -1))
        self._sync()

    def _sync(self) -> None:
        import torch
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _run_point(self, seed: int):
        spec = self._SweepSpec(
            code=self.port_code, channel=self.cfg["channel"], decoder=self.wl["decoder"],
            demapper=self.cfg["demapper"], points=[float(self.wl["point"])],
            frames_per_step=int(self.wl["frames_per_step"]),
            bits_per_point=int(self.wl["bits_per_point"]), seed=seed,
            timeout_per_bit=int(self.wl["timeout_per_bit"]), trace_dir=None)
        return self._run_sweep(spec, mesh=None, checkpoint_path=None, verbose=False,
                               device=str(self.device))[0]

    # ---------------------------------------------------------------- window
    def window(self, seconds: float, annotate) -> None:
        """Points back to back until ``seconds`` have passed."""
        k = int(self.wl["sample"]["points"])
        picks = set(random.Random(f"{self.seed}:points").sample(range(FIRST_POINTS), k))
        t_first = time.perf_counter()
        i = 0
        while True:
            tapping = len(self.sampled) < k
            self._taps = [] if tapping else None
            t0 = time.perf_counter()
            with annotate(f"bench_point_{i}"):
                rec = self._run_point(point_seed(self.seed, i))
            t1 = time.perf_counter()   # the counters are host ints: the device is done
            self.spans.append((t0, t1))
            self.records.append(rec.to_dict())
            last = t1 - t_first >= seconds
            if tapping and (i in picks or last):
                self.sampled.append((i, self.records[-1], self._taps))
            self._taps = None
            i += 1
            if last:
                break

    def attempted(self) -> int:
        return len(self.records)

    def end_to_end(self) -> Dict[str, float]:
        bits = sum(r["bits"] for r in self.records)
        return {"info_bits_per_s": bits / (self.spans[-1][1] - self.spans[0][0])}

    def release(self) -> None:
        """Bring the sampled counters to the host and free the program's
        device memory before the reference runs."""
        import torch
        self._untap()
        self.sampled = [(i, rec, [lane_tensor(o) for o in taps]) for i, rec, taps in self.sampled]
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # ---------------------------------------------------------------- check
    def check(self, dtype=None) -> List[Tuple[str, float, float]]:
        """(name, number, limit) of every comparison, summed over the
        sampled points."""
        import torch
        dtype = dtype or torch.float32
        ref = reference_module(self.wl["decoder"])
        limits = self.wl["limits"]
        totals = {name: 0 for name in limits}
        rng = random.Random(f"{self.seed}:lanes")
        for index, rec, prog in sorted(self.sampled, key=lambda s: s[0]):
            launches = plan(self.code, self.wl, point_seed(self.seed, index))
            totals["bits_gap"] += abs(rec["bits"] - launch_bits(self.code, launches))
            shape_off = len(prog) != len(launches) or any(
                p.shape[1] != la.lanes for p, la in zip(prog, launches))
            totals["launch_gap"] += abs(len(prog) - len(launches)) + int(shape_off)
            totals["sum_gap"] += (abs(sum(int(p[0].sum()) for p in prog) - rec["bit_errors"])
                                  + abs(sum(int(p[1].sum()) for p in prog) - rec["frame_errors"]))
            for li, lanes in sample_lanes(self.wl, launches, rng):
                want = ref.lane_counters(self.code, self.cfg, float(self.wl["point"]),
                                         launches[li], torch.tensor(lanes),
                                         int(self.wl["timeout_per_bit"]), self.device, dtype)
                if shape_off:
                    totals["lanes_off"] += len(lanes)
                    if "iters_off" in totals:
                        totals["iters_off"] += len(lanes)
                    continue
                lanes_off, iters_off = lanes_differ(prog[li][:, lanes], want)
                totals["lanes_off"] += lanes_off
                if "iters_off" in totals:
                    totals["iters_off"] += iters_off
        return [(name, totals[name], limits[name]) for name in CHECKS if name in limits]
