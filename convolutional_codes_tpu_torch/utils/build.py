"""Build the CUDA kernels in ``csrc/`` with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` (plus the shared ``csrc/*.cuh`` headers) becomes
``build/kernels/lib<name>-<hash>.so`` at the repository root, where the
hash covers the sources and the flags, so an edited source rebuilds and
an unchanged one loads at once.  ``stack_mc_wide`` and ``fano_mc_wide``
are ``stack_mc.cu`` and ``fano_mc.cu`` built again for codes of 5-8 coded
bits a symbol (``-DCC_SEQ_MAX_SYMLEN=8``, ``SOURCES``), so that the
libraries of the registered codes compile as they did without them.  The
sources have a plain C interface and include no PyTorch header, which
keeps a build to seconds.

Flags: ``sm_90a`` (Hopper), ``-O3``, and ``-fmad=false`` so that every
product is rounded before it is added, as in the reference's C code; no
fast-math.  ``fano_mc.cu``, ``fused_chain.cu``, ``fused_chain_lin.cu``,
``longframe.cu``, ``longframe_mc.cu`` and ``stack_mc.cu`` are also built with
``-Xptxas -v``, whose report
(registers, stack frame, spills per kernel) is kept in ``build_log``
(``EXTRA_FLAGS``).
nvcc's messages are kept beside each library, ``lib<name>-<hash>.log``,
so a library loaded from an earlier build still has its report.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

from convolutional_codes_tpu_torch.utils.profiling import annotate

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "--split-compile=0")   # optimise the template instances in parallel

#: flags some libraries take on top of NVCC_FLAGS: the ptxas report, and
#: for the fused chain ptxas's least register-usage optimisation (at the
#: default level it spilled 4 bytes in the S = 8, M = 4 instances to stay
#: at 48 and 56 registers)
EXTRA_FLAGS = {name: ("-Xptxas", "-v")
               for name in ("fano_mc", "fano_mc_wide", "fused_chain", "fused_chain_lin",
                            "longframe", "longframe_mc", "stack_mc", "stack_mc_wide")}
EXTRA_FLAGS["fused_chain"] += ("-Xptxas", "--register-usage-level=0")
EXTRA_FLAGS["fused_chain_lin"] += ("-Xptxas", "--register-usage-level=0")
#: the wide builds of the sequential kernels (csrc/sequential.cuh)
EXTRA_FLAGS["stack_mc_wide"] += ("-DCC_SEQ_MAX_SYMLEN=8",)
EXTRA_FLAGS["fano_mc_wide"] += ("-DCC_SEQ_MAX_SYMLEN=8",)

#: libraries built from another library's source (with their own flags)
SOURCES = {"stack_mc_wide": "stack_mc", "fano_mc_wide": "fano_mc"}

#: every kernel library of the package
LIBRARIES = ("longframe", "fused_chain", "fused_chain_lin", "mc_datagen", "stack_mc",
             "fano_mc", "longframe_mc", "stack_mc_wide", "fano_mc_wide")

#: wall seconds each library took to build in this process (0 when cached)
build_seconds = {}
#: nvcc's messages for each library loaded in this process, from its build
build_log = {}


def nvcc_path() -> str:
    """The nvcc binary: ``$CUDA_HOME/bin/nvcc``, else PATH, else the
    default toolkit location.  Raises when none exists."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        cands.append(found)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit "
                       "(set CUDA_HOME or put nvcc on PATH)")


def _flags(name: str) -> tuple:
    return NVCC_FLAGS + EXTRA_FLAGS.get(name, ())


def source_path(name: str) -> Path:
    """The ``.cu`` file library ``name`` is built from."""
    return CSRC / f"{SOURCES.get(name, name)}.cu"


def _digest(name: str) -> str:
    h = hashlib.sha256(" ".join(_flags(name)).encode())
    for path in sorted(CSRC.glob("*.cuh")) + [source_path(name)]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    """Where library ``name`` is (or will be) built."""
    return BUILD_DIR / f"lib{name}-{_digest(name)}.so"


@functools.lru_cache(maxsize=None)
def load_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load library ``name``; cached per process.
    While a profiler session records, the span ``build_load``."""
    with annotate("build_load"):
        out = library_path(name)
        log = out.with_suffix(".log")
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc_path(), *_flags(name), "-o", str(tmp), str(source_path(name))]
            t0 = time.time()
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed building {name}.cu "
                                   f"(exit {proc.returncode}):\n{proc.stderr}")
            build_log[name] = proc.stdout + proc.stderr
            log.write_text(build_log[name])   # before the library: a library has its log
            os.replace(tmp, out)
            build_seconds[name] = time.time() - t0
        else:
            build_seconds.setdefault(name, 0.0)
            build_log[name] = log.read_text() if log.exists() else ""
        return ctypes.CDLL(str(out))


def build_all() -> None:
    """Build every kernel library, the nvcc processes side by side."""
    with concurrent.futures.ThreadPoolExecutor(len(LIBRARIES)) as pool:
        for future in [pool.submit(load_library, n) for n in LIBRARIES]:
            future.result()


def check_status(status: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a C entry point."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status} at launch")
