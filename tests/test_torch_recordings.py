"""PyTorch port, its own recordings of the 55 published grids
(``results_torch/*.jsonl``, recorded on an H100 through the port's CLI by
``python -m convolutional_codes_tpu_torch.sim.reproduce --record``) held to
the reference's published tables by the port's comparator
(``sim/reproduce.py``, the cluster-corrected z of
``tools/reproduce_curves.py``):

* every grid at the reference's full sample tiers at every point, on the
  grid's own points;
* every published row at |z| < 4.5 (the stale and sampler-biased rows
  against the fresh reruns in ``results/reference_fresh_*.json``); the
  16-QAM extension grids, which have no published row, against the JAX
  package's recordings of the same points (two-sample clustered z);
* the BSC stack and Fano grids (``reproduce.EXACT``) with exactly the
  committed counters of ``results/``, point for point;
* the comparator, run in a child process, imports no JAX.
"""

import subprocess
import sys
from pathlib import Path

import pytest

from convolutional_codes_tpu_torch.sim import reproduce

ROOT = Path(__file__).resolve().parents[1]


def test_the_comparator_is_the_reference_tools():
    """The port's copy of the grids and the threshold equals the JAX
    package's tools (which the port may not import)."""
    from tools.reproduce_curves import CONFIGS, Z_THRESHOLD

    assert reproduce.CONFIGS == CONFIGS and reproduce.Z_THRESHOLD == Z_THRESHOLD
    assert len(reproduce.CONFIGS) == 55


@pytest.mark.parametrize("name", sorted(reproduce.CONFIGS))
def test_recorded_grid_matches_published(name):
    res = reproduce.check(name)
    assert not res["problems"], (name, res["problems"])
    assert res["scale"] >= 1.0 and res["worst"] < reproduce.Z_THRESHOLD
    if name in reproduce.EXACT:
        assert res["exact"] == []


def test_the_comparator_imports_no_jax():
    proc = subprocess.run(
        [sys.executable, "-c",
         "import sys\n"
         "from convolutional_codes_tpu_torch.sim import reproduce\n"
         "bad = reproduce.report(list(reproduce.CONFIGS))\n"
         "assert not [m for m in sys.modules if m.split('.')[0] in "
         "('jax', 'jaxlib', 'convolutional_codes_tpu', 'tools')], sorted(sys.modules)\n"
         "sys.exit(1 if bad else 0)\n"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "55 of 55 grids pass" in proc.stdout
