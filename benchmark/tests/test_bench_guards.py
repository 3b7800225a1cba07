"""Guards of the benchmark: what it may import, the manifest against the
contract, that a new cell is data alone, and that no card means no result."""

from __future__ import annotations

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark import run as bench_run
from benchmark.tests.helpers import ROOT, checkout

BENCH = ROOT / "benchmark"
FORBIDDEN = {"jax", "jaxlib", "flax", "convolutional_codes_tpu"}
PORT = "convolutional_codes_tpu_torch"


def imported_top_names(path: Path) -> set:
    """Whole top-level names of every module a file imports."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module" \
                and node.args and isinstance(node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split(".")[0])
    return names


def harness_files():
    return [p for p in BENCH.rglob("*.py") if "tests" not in p.relative_to(BENCH).parts]


def test_no_benchmark_file_imports_jax_or_the_jax_package():
    for path in harness_files():
        bad = imported_top_names(path) & FORBIDDEN
        assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"
    assert "convolutional_codes_tpu_torch".split(".")[0] not in FORBIDDEN


def test_the_reference_imports_nothing_of_the_port():
    for path in (BENCH / "reference").glob("*.py"):
        assert PORT not in imported_top_names(path), path.name
    for path in (BENCH / "yardstick").glob("*.py"):
        assert PORT not in imported_top_names(path), path.name
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import benchmark.reference.common, benchmark.reference.viterbi, "
            "benchmark.reference.fano, benchmark.reference.stack, benchmark.yardstick.opcounts, "
            "benchmark.control\n"
            "print(sorted({k.split('.')[0] for k in sys.modules}))" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True)
    loaded = set(json.loads(out.stdout.strip().replace("'", '"')))
    assert not loaded & (FORBIDDEN | {PORT})


def test_a_dry_run_of_every_cell_loads_no_jax(tmp_path):
    """Validate the manifest and run the smallest cell on the CPU in a child
    process; then the whole top-level names in ``sys.modules``."""
    root = checkout(tmp_path, ["code0-viterbi-8db"])
    code = ("import sys, json; sys.path.insert(0, %r)\n"
            "from pathlib import Path\n"
            "from benchmark import run as R\n"
            "out = R.run('code0-viterbi-8db', 5, 0.2, False, root=Path(%r), device='cpu')\n"
            "assert out['correct'], out\n"
            "print(json.dumps(sorted({k.split('.')[0] for k in sys.modules})))"
            % (str(ROOT), str(root)))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, env=env, timeout=600)
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert PORT in loaded and not loaded & FORBIDDEN


def test_the_manifest_meets_the_contract():
    m = bench_run.validate_manifest(ROOT)
    names = [x["name"] for x in m["configs"] + m["workloads"] + m["end_to_end"] + m["per_layer"]]
    assert len(names) == len(set(names))
    for n in names:
        assert bench_run.NAME.match(n)
    for x in m["end_to_end"] + m["per_layer"]:
        assert bench_run.UNIT.match(x["unit"])
    assert {x["name"] for x in m["end_to_end"]} == {"info_bits_per_s", "setup_s"}
    assert {x["name"] for x in m["per_layer"]} == {
        "device_idle_pct", "sweep_host_ms", "viterbi_mc_roofline_pct",
        "fano_mc_roofline_pct", "stack_mc_roofline_pct"}
    cells = {w["name"] for w in m["workloads"]}
    for x in m["per_layer"]:
        assert x["moves"] == "info_bits_per_s" and set(x["workloads"]) <= cells
    for c in m["configs"]:
        assert any(w["config"] == c["name"] for w in m["workloads"])
    assert all(w["chips"] == 1 for w in m["workloads"])
    assert m["paths"] == ["benchmark"] and m["command"] == ["python3", "benchmark/run.py"]
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_a_bad_manifest_is_refused(tmp_path):
    root = checkout(tmp_path)
    m = json.loads((root / "BENCHMARK.json").read_text())
    m["end_to_end"][0]["unit"] = "bits per s"
    (root / "BENCHMARK.json").write_text(json.dumps(m))
    with pytest.raises(bench_run.ManifestError):
        bench_run.validate_manifest(root)


def test_a_dropped_workload_file_is_found_and_validated(tmp_path):
    """A new cell is a workload file and a manifest entry: no other file
    changes, and it runs."""
    root = checkout(tmp_path)
    wl = json.loads((root / "benchmark" / "workloads" / "code0-viterbi-8db.json").read_text())
    wl.update(traffic="viterbi-bsc-tiny", point=0.02, frames_per_step=1024,
              bits_per_point=1024 * 40 * 2)
    (root / "benchmark" / "workloads" / "code0-bsc-tiny.json").write_text(json.dumps(wl))
    m = json.loads((root / "BENCHMARK.json").read_text())
    m["configs"].append({"name": "code0-bsc", "source": "https://example.org/code0",
                         "file": "benchmark/configs/code0-bsc.json", "reduced": [],
                         "why": "the hard twin"})
    cfg = json.loads((root / "benchmark" / "configs" / "code0-awgn-soft.json").read_text())
    cfg.update(name="code0-bsc", channel="bsc", demapper="hard")
    (root / "benchmark" / "configs" / "code0-bsc.json").write_text(json.dumps(cfg))
    m["workloads"].append({"name": "code0-bsc-tiny", "config": "code0-bsc",
                           "traffic": "viterbi-bsc-tiny", "chips": 1, "why": "a test cell"})
    for x in m["per_layer"]:
        if x["name"] == "device_idle_pct":
            x["workloads"].append("code0-bsc-tiny")
    (root / "BENCHMARK.json").write_text(json.dumps(m))
    before = {p: p.read_bytes() for p in (root / "benchmark").rglob("*") if p.is_file()}
    assert "code0-bsc-tiny" in {w["name"] for w in bench_run.validate_manifest(root)["workloads"]}
    out = bench_run.run("code0-bsc-tiny", 77, 0.2, False, root=root, device="cpu")
    assert out["correct"] and out["checks"]["lanes_off"]["value"] == 0
    assert out["metrics"]["info_bits_per_s"]["value"] > 0
    assert {p: p.read_bytes() for p in (root / "benchmark").rglob("*") if p.is_file()
            and "__pycache__" not in p.parts} == {p: b for p, b in before.items()
                                                  if "__pycache__" not in p.parts}
    # a workload file whose traffic disagrees with its entry is refused
    wl["traffic"] = "other"
    (root / "benchmark" / "workloads" / "code0-bsc-tiny.json").write_text(json.dumps(wl))
    with pytest.raises(bench_run.ManifestError):
        bench_run.validate_manifest(root)


def test_a_run_without_a_card_fails_and_prints_no_result(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "code0-viterbi-8db",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode != 0
    assert "{" not in out.stdout
    assert "no card" in out.stderr


def test_a_checkout_of_the_benchmark_alone_fails(tmp_path):
    root = checkout(tmp_path)
    code = ("import sys; sys.path = [p for p in sys.path if p not in ('', %r)]; "
            "sys.argv = ['run.py', '--workload', 'code0-viterbi-8db', '--seed', '1', "
            "'--seconds', '1', '--trace', '0']; "
            "import runpy; runpy.run_path('benchmark/run.py', run_name='__main__')" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                         text=True, timeout=300, env=dict(os.environ, PYTHONPATH=""))
    assert out.returncode != 0 and "{" not in out.stdout


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_a_short_run_on_the_card(card, tmp_path):
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "code0-viterbi-8db",
                          "--seed", str(2 ** 31 + 5), "--seconds", "2", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
    assert list(line)[-1] == "checks"
