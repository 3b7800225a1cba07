"""The port's benchmark: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell, its configuration and its metrics
are found by name in ``BENCHMARK.json``: the configuration's file under
``benchmark/configs/``, the cell's traffic under
``benchmark/workloads/<cell>.json`` (which names its loop,
``benchmark/loops/<loop>.py``), each per-layer metric's reader under
``benchmark/metrics/<metric>.py``, and the plain reference the loop
compares with under ``benchmark/reference/``.  A new cell, configuration or
metric is a new file and a new entry; nothing here names one.

A run: set-up (import torch and the port, load the cell's kernel library
from the build cache inside the checkout, one warm point of the cell's
shape), the window of ``--seconds`` (with ``--trace 1`` under
``torch.profiler``), the peak memory, the check against the plain
reference, and one JSON line on standard output, last.  Without a card, or
with fewer cards than the cell asks for, it prints no result and exits 3.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import bisect  # noqa: E402
import heapq  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import re  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

#: top-level module names that may not be loaded in a run's process
FORBIDDEN = ("jax", "jaxlib", "flax", "convolutional_codes_tpu")

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
SOURCES_E2E = ("host_clock", "device_trace")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")


class ManifestError(ValueError):
    pass


def _line(text, what: str) -> None:
    if not isinstance(text, str) or not 1 <= len(text) <= 200 or "\n" in text or "\t" in text:
        raise ManifestError(f"{what}: 1 to 200 characters on one line, no tab")


def _name(text, what: str) -> None:
    if not isinstance(text, str) or not NAME.match(text):
        raise ManifestError(f"{what} {text!r} is not a name")


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def validate_manifest(root: Path) -> dict:
    """Read ``BENCHMARK.json`` under ``root`` and check it against the
    contract and the files it names; returns it."""
    raw = (root / "BENCHMARK.json").read_bytes()
    if len(raw) > 64 * 1024:
        raise ManifestError("BENCHMARK.json is over 64 KiB")
    m = json.loads(raw)
    keys = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    if set(m) != keys:
        raise ManifestError(f"keys {sorted(m)}")
    cmd, paths = m["command"], m["paths"]
    if not (isinstance(cmd, list) and 1 <= len(cmd) <= 32):
        raise ManifestError("command: a list of 1 to 32 strings")
    for word in cmd:
        _line(word, "command word")
    if not (isinstance(paths, list) and 1 <= len(paths) <= 16):
        raise ManifestError("paths: 1 to 16 directories")
    for p in paths:
        if not PATH.match(p) or p.startswith("/") or ".." in p.split("/"):
            raise ManifestError(f"path {p!r}")
    rs = m["run_seconds"]
    if not (isinstance(rs, int) and 1 <= rs <= 51):
        raise ManifestError("run_seconds: a whole number from 1 to 51")

    def under_paths(rel: str) -> bool:
        return any(rel == p or rel.startswith(p.rstrip("/") + "/") for p in paths)

    names = set()

    def unique(n, what):
        _name(n, what)
        if n in names:
            raise ManifestError(f"{what} {n!r} is not unique")
        names.add(n)

    if not 1 <= len(m["configs"]) <= 24:
        raise ManifestError("1 to 24 configs")
    files = set()
    for c in m["configs"]:
        if set(c) != {"name", "source", "file", "reduced", "why"}:
            raise ManifestError(f"config keys {sorted(c)}")
        unique(c["name"], "config")
        _line(c["source"], "source")
        _line(c["why"], "why")
        if not under_paths(c["file"]) or c["file"] in files or not (root / c["file"]).is_file():
            raise ManifestError(f"config file {c['file']!r}")
        files.add(c["file"])
        if not isinstance(c["reduced"], list) or len(c["reduced"]) > 16:
            raise ManifestError("reduced: at most 16 keys")
        for k in c["reduced"]:
            _name(k, "reduced key")
    configs = {c["name"]: c for c in m["configs"]}

    if not 1 <= len(m["workloads"]) <= 24:
        raise ManifestError("1 to 24 workloads")
    pairs, used = set(), set()
    four = 0
    for w in m["workloads"]:
        if set(w) != {"name", "config", "traffic", "chips", "why"}:
            raise ManifestError(f"workload keys {sorted(w)}")
        unique(w["name"], "workload")
        _name(w["traffic"], "traffic")
        _line(w["why"], "why")
        if w["config"] not in configs or w["chips"] not in (1, 4):
            raise ManifestError(f"workload {w['name']}: config or chips")
        four += w["chips"] == 4
        if (w["config"], w["traffic"]) in pairs:
            raise ManifestError(f"workload {w['name']}: config and traffic repeat")
        pairs.add((w["config"], w["traffic"]))
        used.add(w["config"])
        wl = json.loads((root / "benchmark" / "workloads" / f"{w['name']}.json").read_text())
        if wl.get("traffic") != w["traffic"]:
            raise ManifestError(f"workload {w['name']}: its file's traffic is "
                                f"{wl.get('traffic')!r}")
        if not (root / "benchmark" / "loops" / f"{wl.get('loop')}.py").is_file():
            raise ManifestError(f"workload {w['name']}: no loop {wl.get('loop')!r}")
    if four > max(1, len(m["workloads"]) // 4):
        raise ManifestError("too many four-chip cells")
    if used != set(configs):
        raise ManifestError(f"configs without a cell: {sorted(set(configs) - used)}")
    cells = {w["name"] for w in m["workloads"]}

    def metric_common(x, allowed_sources):
        unique(x["name"], "metric")
        if not isinstance(x.get("unit"), str) or not UNIT.match(x["unit"]):
            raise ManifestError(f"metric {x['name']}: unit {x.get('unit')!r}")
        if x.get("better") not in ("lower", "higher"):
            raise ManifestError(f"metric {x['name']}: better")
        if x.get("source") not in allowed_sources:
            raise ManifestError(f"metric {x['name']}: source {x.get('source')!r}")
        if "workloads" in x and (not x["workloads"] or set(x["workloads"]) - cells):
            raise ManifestError(f"metric {x['name']}: workloads {x['workloads']}")

    if not 1 <= len(m["end_to_end"]) <= 16:
        raise ManifestError("1 to 16 end-to-end metrics")
    for x in m["end_to_end"]:
        if not {"name", "unit", "better", "bound", "source"} <= set(x) or \
                set(x) - {"name", "unit", "better", "bound", "source", "workloads"}:
            raise ManifestError(f"end-to-end keys {sorted(x)}")
        metric_common(x, SOURCES_E2E)
        if not isinstance(x["bound"], (int, float)) or not 0.01 <= x["bound"] <= 0.25:
            raise ManifestError(f"metric {x['name']}: bound from 0.01 to 0.25")
    e2e = {x["name"]: x for x in m["end_to_end"]}
    if "setup_s" not in e2e:
        raise ManifestError("no setup_s")

    def reports(metric: dict, cell: str) -> bool:
        return "workloads" not in metric or cell in metric["workloads"]

    if not 1 <= len(m["per_layer"]) <= 128:
        raise ManifestError("1 to 128 per-layer metrics")
    for x in m["per_layer"]:
        if not {"name", "unit", "better", "source", "layer", "moves"} <= set(x) or \
                set(x) - {"name", "unit", "better", "source", "layer", "moves", "workloads"}:
            raise ManifestError(f"per-layer keys {sorted(x)}")
        metric_common(x, SOURCES)
        _line(x["layer"], "layer")
        if x["moves"] not in e2e or x["moves"] == "setup_s":
            raise ManifestError(f"metric {x['name']}: moves {x['moves']!r}")
        for cell in x.get("workloads", sorted(cells)):
            if not reports(e2e[x["moves"]], cell):
                raise ManifestError(f"metric {x['name']}: cell {cell} lacks {x['moves']}")
        reader = root / "benchmark" / "metrics" / f"{x['name']}.py"
        if not reader.is_file():
            raise ManifestError(f"metric {x['name']}: no reader {reader.name}")
        mod = load_module(reader, f"bench_metric_{x['name'].replace('.', '_')}")
        for attr, want in (("LAYER", x["layer"]), ("MOVES", x["moves"]), ("SOURCE", x["source"])):
            if getattr(mod, attr, None) != want:
                raise ManifestError(f"metric {x['name']}: {attr} of its reader is not {want!r}")
    for cell in cells:
        if not any(reports(x, cell) for x in m["end_to_end"] if x["name"] != "setup_s"):
            raise ManifestError(f"cell {cell} reports no end-to-end metric besides setup_s")
        if not any(reports(x, cell) for x in m["per_layer"]):
            raise ManifestError(f"cell {cell} reports no per-layer metric")
    return m


def forbidden_modules() -> list:
    return sorted({k.split(".")[0] for k in sys.modules} & set(FORBIDDEN))


# --------------------------------------------------------------------------
# the trace
# --------------------------------------------------------------------------

def _union(intervals):
    """Merged, sorted (start, end) intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


class TraceContext:
    """What a per-layer reader reads: the cell, its points, the window's
    spans and the device's kernels (seconds on the trace's clock)."""

    def __init__(self, cfg, wl, code, points, spans, kernels, host_ops):
        self.config, self.workload, self.code = cfg, wl, code
        self.points = points            # the window's point records
        self.spans = spans              # [(start, end)] of each point
        self.kernels = kernels          # [(name, start, end)]
        self.host_ops = host_ops        # [(name, start, end)] of the main thread
        self.window = (spans[0][0], spans[-1][1]) if spans else (0.0, 0.0)
        self._merged = _union((a, b) for _, a, b in kernels)
        self._ends = [b for _, b in self._merged]

    def busy(self, start: float, end: float) -> float:
        """Seconds of [start, end] in which some kernel ran."""
        i = bisect.bisect_right(self._ends, start)
        total = 0.0
        while i < len(self._merged) and self._merged[i][0] < end:
            a, b = self._merged[i]
            total += max(0.0, min(b, end) - max(a, start))
            i += 1
        return total

    def gaps(self):
        """Idle stretches of the window: (start, end)."""
        w0, w1 = self.window
        edges = [(max(a, w0), min(b, w1)) for a, b in self._merged if b > w0 and a < w1]
        cur, out = w0, []
        for a, b in edges:
            if a > cur:
                out.append((cur, a))
            cur = max(cur, b)
        if w1 > cur:
            out.append((cur, w1))
        return out


def read_trace(path: Path, span_prefix: str):
    """(spans, kernels, host ops) of a Chrome trace, in seconds."""
    events = json.loads(path.read_text()).get("traceEvents", [])
    spans, kernels, host = [], [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        a, b = e["ts"] * 1e-6, (e["ts"] + e["dur"]) * 1e-6
        cat = e.get("cat", "")
        if cat == "kernel":
            kernels.append((e["name"], a, b))
        elif cat == "user_annotation" and e["name"].startswith(span_prefix):
            spans.append((int(e["name"][len(span_prefix):]), a, b))
        elif cat in ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation", "python_function"):
            host.append((e["name"], a, b))
    spans = [(a, b) for _, a, b in sorted(spans)]
    return spans, kernels, host


def breakdown(ctx: TraceContext) -> dict:
    """The ten kernels that took most time, and the longest idle gaps by the
    innermost host operation running at each gap's middle."""
    w0, w1 = ctx.window
    by_kernel = {}
    for name, a, b in ctx.kernels:
        d = max(0.0, min(b, w1) - max(a, w0))
        by_kernel[name] = by_kernel.get(name, 0.0) + d
    by_host = {}
    # a sweep over the gaps' middles in order, with the host operations that
    # have started in a heap by their end: those left after popping the
    # ended ones contain the middle
    ops = sorted((s, e, n) for n, s, e in ctx.host_ops if not n.startswith("bench_point"))
    active, k = [], 0
    for a, b in ctx.gaps():
        mid = 0.5 * (a + b)
        while k < len(ops) and ops[k][0] <= mid:
            heapq.heappush(active, (ops[k][1], ops[k][0], ops[k][2]))
            k += 1
        while active and active[0][0] < mid:
            heapq.heappop(active)
        label = min((e - s, n) for e, s, n in active)[1] if active else "between host operations"
        by_host[label] = by_host.get(label, 0.0) + (b - a)
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]
    return {"device_ops": top(by_kernel), "idle_gaps": top(by_host)}


# --------------------------------------------------------------------------
# one run
# --------------------------------------------------------------------------

def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else ""
    except (OSError, subprocess.SubprocessError):
        return ""


def run(workload: str, seed: int, seconds: float, trace: bool, root: Path = ROOT,
        device: str = "cuda", t_start: float = None) -> dict:
    """One run of ``workload``; returns the result line's object (without
    printing it).  ``device`` "cpu" runs the plain versions at whatever
    size the workload asks (the tests' tiny cells)."""
    t_start = T_START if t_start is None else t_start
    manifest = validate_manifest(root)
    entry = next((w for w in manifest["workloads"] if w["name"] == workload), None)
    if entry is None:
        raise ManifestError(f"no workload {workload!r}")
    cfg_entry = next(c for c in manifest["configs"] if c["name"] == entry["config"])
    cfg = json.loads((root / cfg_entry["file"]).read_text())
    wl = json.loads((root / "benchmark" / "workloads" / f"{workload}.json").read_text())

    import torch
    if device == "cuda":
        if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
            raise NoCard(f"the cell asks for {entry['chips']} card(s); "
                         f"cuda available: {torch.cuda.is_available()}, "
                         f"count: {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
    else:
        dev = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(min(4, torch.get_num_threads()))

    loop_mod = importlib.import_module(f"benchmark.loops.{wl['loop']}")
    loop = loop_mod.Loop(cfg, wl, dev, seed)
    loop.setup()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = time.perf_counter() - t_start

    annotate = torch.profiler.record_function
    tmp = None
    if trace:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
        tmp = tempfile.TemporaryDirectory(prefix="bench_trace_")
        prof = profile(activities=acts)
        with prof:
            loop.window(seconds, annotate)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        trace_path = Path(tmp.name) / "trace.json"
        prof.export_chrome_trace(str(trace_path))
        del prof
    else:
        loop.window(seconds, annotate)

    found = forbidden_modules()
    if found:
        raise ForbiddenModules(found)
    peak = int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" else 0
    e2e = {"setup_s": setup_s, **loop.end_to_end()}
    units = {x["name"]: x["unit"] for x in manifest["end_to_end"] + manifest["per_layer"]}
    dev_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                "count": entry["chips"], "memory_peak_bytes": peak}
    result = {}
    if trace:
        spans, kernels, host = read_trace(trace_path, "bench_point_")
        tmp.cleanup()
        ctx = TraceContext(cfg, wl, loop.code, loop.records, spans, kernels, host)
        metrics = {}
        for x in manifest["per_layer"]:
            if "workloads" in x and workload not in x["workloads"]:
                continue
            mod = load_module(root / "benchmark" / "metrics" / f"{x['name']}.py",
                              f"bench_metric_{x['name'].replace('.', '_')}")
            value = mod.read(ctx)
            if value is not None:
                metrics[x["name"]] = {"value": float(value), "unit": units[x["name"]]}
        w0, w1 = ctx.window
        dev_info["busy_s"] = ctx.busy(w0, w1)
        dev_info["window_s"] = w1 - w0
        result["breakdown"] = breakdown(ctx)
    else:
        metrics = {}
        for x in manifest["end_to_end"]:
            if "workloads" in x and workload not in x["workloads"]:
                continue
            if x["name"] not in e2e:
                raise KeyError(f"the loop gives no {x['name']}")
            metrics[x["name"]] = {"value": float(e2e[x["name"]]), "unit": units[x["name"]]}
    if dev.type == "cuda":
        dev_info["power"] = power_limit()

    loop.release()
    t_check = time.perf_counter()
    checks = loop.check()
    print(f"reference check: {time.perf_counter() - t_check:.3f} s", file=sys.stderr)
    correct = all(value <= limit for _, value, limit in checks)
    out = {"correct": correct, "attempted": loop.attempted(), "failed": 0,
           "metrics": metrics, "device": dev_info}
    out.update(result)
    out["checks"] = {name: {"value": value, "limit": limit} for name, value, limit in checks}
    return out


class NoCard(RuntimeError):
    pass


class ForbiddenModules(RuntimeError):
    pass


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        out = run(args.workload, args.seed, args.seconds, bool(args.trace))
    except NoCard as e:
        print(f"no card: {e}", file=sys.stderr)
        return 3
    except ForbiddenModules as e:
        print(f"modules that may not load in a run: {e.args[0]}", file=sys.stderr)
        return 4
    except Exception:  # noqa: BLE001 - the run's boundary: report and fail
        traceback.print_exc()
        return 1
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
