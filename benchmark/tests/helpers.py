"""Shared pieces of the benchmark's tests: a copy of the benchmark in a
temporary checkout, with cells shrunk to a size the CPU runs in seconds."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

#: each cell's traffic cut to CPU size: two launches a point (the stack's
#: plain machine is the slowest: one), few frames, and on the BSC a
#: crossover at which the plain lockstep machines finish in seconds
TINY = {
    "code0-viterbi-8db": {"frames_per_step": 2048, "bits_per_point": 2048 * 40 * 2,
                          "sample": {"points": 1, "launches": 2, "frames": 0}},
    "wspr-fano-p05": {"bits_per_point": 1024 * 50 * 2, "timeout_per_bit": 20, "point": 0.02,
                      "sample": {"points": 1, "launches": 0, "frames": 24}},
    "wspr-stack-p05": {"bits_per_point": 1024 * 50, "point": 0.005,
                       "sample": {"points": 1, "launches": 0, "frames": 24}},
    "code0-fano-4db": {"bits_per_point": 1024 * 40 * 2, "timeout_per_bit": 20,
                       "sample": {"points": 1, "launches": 0, "frames": 24}},
}


def checkout(tmp: Path, cells=()) -> Path:
    """A copy of ``BENCHMARK.json`` and ``benchmark/`` under ``tmp``, with
    ``cells`` shrunk by :data:`TINY`."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp / "BENCHMARK.json")
    shutil.copytree(ROOT / "benchmark", tmp / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for cell in cells:
        path = tmp / "benchmark" / "workloads" / f"{cell}.json"
        wl = json.loads(path.read_text())
        wl.update(TINY[cell])
        path.write_text(json.dumps(wl))
    return tmp


def load(root: Path, cell: str):
    """(config, workload) of ``cell`` under ``root``."""
    m = json.loads((root / "BENCHMARK.json").read_text())
    entry = next(w for w in m["workloads"] if w["name"] == cell)
    cfg_entry = next(c for c in m["configs"] if c["name"] == entry["config"])
    return (json.loads((root / cfg_entry["file"]).read_text()),
            json.loads((root / "benchmark" / "workloads" / f"{cell}.json").read_text()))
