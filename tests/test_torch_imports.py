"""The PyTorch port imports no JAX and nothing of the JAX package:
statically (an AST scan of every port module and of chip_smoke.py) and at
run time (a fresh interpreter that imports every port module)."""

import ast
import os
import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "convolutional_codes_tpu_torch"
#: modules of the JAX package the port may import: none
ALLOWED_REFERENCE = ()


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
            "('jax', 'jaxlib', 'triton', 'convolutional_codes_tpu')))\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120, check=True)
    assert out.stdout.strip() == "[]", out.stdout


#: names of the JAX package's API that the port leaves out (ROADMAP "Do not port")
DO_NOT_PORT = {"long_frame_decode_pallas", "long_frame_decode_hostseg"}


def _reference_all(sub):
    """``__all__`` of the JAX package's ``sub/__init__.py``, read without
    importing it."""
    tree = ast.parse((REPO / "convolutional_codes_tpu" / sub / "__init__.py").read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and node.targets[0].id == "__all__":
            return set(ast.literal_eval(node.value))
    raise AssertionError(f"no __all__ in {sub}")


def test_package_exports_the_reference_names():
    import importlib

    for sub, extra in (("ops", {"mc_awgn_viterbi", "mc_bsc_viterbi"}), ("parallel", set())):
        mod = importlib.import_module(f"convolutional_codes_tpu_torch.{sub}")
        assert set(mod.__all__) == (_reference_all(sub) - DO_NOT_PORT) | extra, sub
        assert all(callable(getattr(mod, name)) for name in mod.__all__), sub


def test_oracle_and_profiling_load_no_jax():
    """The port's C oracle (built and called) and its profiling hooks pull
    in neither JAX nor the JAX package (whose copies of both import it)."""
    code = ("import sys\n"
            "from convolutional_codes_tpu_torch.utils import native, profiling\n"
            "from convolutional_codes_tpu_torch.models.codebook import get_code\n"
            "import numpy as np\n"
            "if native.available():\n"
            "    native.encode_blocks(get_code(0), np.zeros((1, 40), np.int8))\n"
            "with profiling.trace(None), profiling.annotate('x'):\n"
            "    pass\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'convolutional_codes_tpu')))\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120, check=True)
    assert out.stdout.strip() == "[]", out.stdout
