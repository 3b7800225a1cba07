"""Build the CUDA kernels in ``csrc/`` with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` (plus the shared ``csrc/*.cuh`` headers) becomes
``build/kernels/lib<name>-<hash>.so`` at the repository root, where the
hash covers the sources and the flags, so an edited source rebuilds and
an unchanged one loads at once.  The sources have a plain C interface and
include no PyTorch header, which keeps a build to seconds.

Flags: ``sm_90a`` (Hopper), ``-O3``, and ``-fmad=false`` so that every
product is rounded before it is added, as in the reference's C code; no
fast-math.
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

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "--split-compile=0")   # optimise the template instances in parallel

#: every kernel library of the package
LIBRARIES = ("viterbi", "fused_chain")

#: wall seconds each library took to build in this process (0 when cached)
build_seconds = {}


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


def _digest(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


@functools.lru_cache(maxsize=None)
def load_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; cached per process."""
    out = BUILD_DIR / f"lib{name}-{_digest(name)}.so"
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        t0 = time.time()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed building {name}.cu "
                               f"(exit {proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, out)
        build_seconds[name] = time.time() - t0
    else:
        build_seconds.setdefault(name, 0.0)
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
