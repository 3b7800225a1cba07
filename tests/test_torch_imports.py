"""The PyTorch port imports no JAX: statically (an AST scan of every port
module and of chip_smoke.py) and at run time (a fresh interpreter that
imports every port module)."""

import ast
import os
import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "convolutional_codes_tpu_torch"
ALLOWED_REFERENCE = ("convolutional_codes_tpu.models.codebook",
                     "convolutional_codes_tpu.models.trellis",
                     "convolutional_codes_tpu.models.constellations")


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _port_modules():
    return sorted(PORT.rglob("*.py"))


def test_port_sources_import_no_jax():
    files = _port_modules() + [REPO / "chip_smoke.py"]
    assert len(files) >= 20
    bad = []
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            if top in ("jax", "jaxlib"):
                bad.append((path.name, mod))
            if top == "convolutional_codes_tpu" and mod not in ALLOWED_REFERENCE:
                bad.append((path.name, mod))
    assert not bad, bad


def test_importing_every_port_module_loads_no_jax():
    mods = [".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(".__init__")
            for p in _port_modules()]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'triton')))\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120, check=True)
    assert out.stdout.strip() == "[]", out.stdout
