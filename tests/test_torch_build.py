"""PyTorch port, ``utils/build.py``: a kernel library keeps nvcc's report
beside it, so a library loaded from an earlier build still has it (the
``-Xptxas -v`` lines that chip_smoke.py's phase 2 checks).

nvcc is replaced by a small script that writes the library and prints a
report, and loading by a stub, so this runs without the CUDA toolkit.
"""

import sys

import pytest

from convolutional_codes_tpu_torch.utils import build

REPORT = "ptxas info    : Used 51 registers, 0 bytes stack frame"


@pytest.fixture
def fake_build(tmp_path, monkeypatch):
    """A build directory under ``tmp_path``, an nvcc that writes its ``-o``
    file and prints REPORT, and ``ctypes.CDLL`` returning the path."""
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(f"#!{sys.executable}\nimport sys\n"
                    "open(sys.argv[sys.argv.index('-o') + 1], 'wb').close()\n"
                    f"print({REPORT!r}, file=sys.stderr)\n")
    nvcc.chmod(0o755)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(build, "nvcc_path", lambda: str(nvcc))
    monkeypatch.setattr(build.ctypes, "CDLL", lambda path: path)
    monkeypatch.setattr(build, "build_log", {})
    monkeypatch.setattr(build, "build_seconds", {})
    return tmp_path / "kernels" / f"libfano_mc-{build._digest('fano_mc')}.so"


def test_built_library_writes_its_report_beside_it(fake_build):
    assert build.load_library.__wrapped__("fano_mc") == str(fake_build)
    assert build.build_log["fano_mc"].strip() == REPORT
    assert fake_build.with_suffix(".log").read_text().strip() == REPORT
    assert build.build_seconds["fano_mc"] > 0


def test_cached_library_reads_its_report_back(fake_build):
    build.load_library.__wrapped__("fano_mc")
    build.build_log.clear()
    build.build_seconds.clear()
    assert build.load_library.__wrapped__("fano_mc") == str(fake_build)
    assert build.build_log["fano_mc"].strip() == REPORT
    assert build.build_seconds["fano_mc"] == 0.0
