"""The control of a cell's check: the plain reference put in the program's
place and computed in the precision below the configuration's (bfloat16
for its float32), on the sample a run compares, at the cell's own size.

    python3 benchmark/control.py --workload <cell> --seeds 1 2 3

prints one JSON line a seed with the numbers the check compares (the
control's counters against the float32 reference's) beside the cell's
limits; a sound check fails every one of them.  The benchmark's own runs do
not run it.
"""

from __future__ import annotations

import argparse
import json
import random
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def control_readings(cfg: dict, wl: dict, seed: int, device, low_dtype) -> dict:
    """The numbers the check compares, with the low-precision reference as
    the program, for the point a run seeded ``seed`` would sample first."""
    import torch
    from benchmark.loops.sweep_points import (
        lanes_differ, plan, point_seed, reference_module, sample_lanes)
    from benchmark.reference.common import CodeSpec

    code = CodeSpec.from_config(cfg)
    ref = reference_module(wl["decoder"])
    launches = plan(code, wl, point_seed(seed, 0))
    out = {name: 0 for name in wl["limits"]}
    for li, lanes in sample_lanes(wl, launches, random.Random(f"{seed}:lanes")):
        args = (code, cfg, float(wl["point"]), launches[li], torch.tensor(lanes),
                int(wl["timeout_per_bit"]), device)
        want = ref.lane_counters(*args, dtype=torch.float32)
        got = ref.lane_counters(*args, dtype=low_dtype)
        lanes_off, iters_off = lanes_differ(got, want)
        out["lanes_off"] += lanes_off
        if "iters_off" in out:
            out["iters_off"] += iters_off
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    import torch
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = next(w for w in manifest["workloads"] if w["name"] == args.workload)
    cfg_entry = next(c for c in manifest["configs"] if c["name"] == entry["config"])
    cfg = json.loads((ROOT / cfg_entry["file"]).read_text())
    wl = json.loads((ROOT / "benchmark" / "workloads" / f"{args.workload}.json").read_text())
    device = torch.device("cuda", 0) if torch.cuda.is_available() else torch.device("cpu")
    for seed in args.seeds:
        t0 = time.perf_counter()
        got = control_readings(cfg, wl, seed, device, torch.bfloat16)
        fails = {k: v > wl["limits"][k] for k, v in got.items() if k in ("lanes_off", "iters_off")}
        print(json.dumps({"workload": args.workload, "seed": seed, "readings": got,
                          "limits": wl["limits"], "control_fails": any(fails.values()),
                          "seconds": time.perf_counter() - t0,
                          "device": str(device)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
