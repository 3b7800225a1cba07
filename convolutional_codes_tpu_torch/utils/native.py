"""ctypes bindings for the native host runtime (``native/convcodes_native.c``).

The port's copy of the JAX package's ``utils/native.py``: the same entry
points and parameter block, over the port's own :class:`Code`.  It builds
the shared library on first use with the host C compiler (``$CC``, else
gcc) into ``build/native/`` at the repository root, keyed by a hash of the
source and the flags as ``utils/build.py`` keys the CUDA libraries, and
exposes batch encoder/Viterbi/stack/Fano entry points as NumPy functions.
It is the fuzz oracle of the port's tests and of ``chip_smoke.py``'s
random-code check (the C code was validated bit for bit against the scalar
spec in ``tests/golden_model.py``), and a host-side decoder.
``available()`` is False when no C compiler is present or the build fails.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from convolutional_codes_tpu_torch.models.codebook import PARITY_COMPAT, Code

_ROOT = Path(__file__).resolve().parents[2]
_SRC = _ROOT / "native" / "convcodes_native.c"
BUILD_DIR = _ROOT / "build" / "native"

# -ffp-contract=off: the soft stack/Fano metrics compute 1.0f + w*dist and
# the golden contract rounds the product BEFORE the add (see
# ops/sequential_common.force_rounded).  Toolchains that contract onto FMA
# by default (aarch64 gcc, clang) would otherwise make this oracle deviate
# from the goldens.
CFLAGS = ("-O3", "-ffp-contract=off", "-shared", "-fPIC")

_MAX_POLYS = 8


class _Params(ctypes.Structure):
    _fields_ = [
        ("symlen_out", ctypes.c_int32),
        ("constraint_length", ctypes.c_int32),
        ("block_length", ctypes.c_int32),
        ("compat_parity", ctypes.c_int32),
        ("polynomials", ctypes.c_uint32 * _MAX_POLYS),
    ]


def _params(code: Code) -> _Params:
    p = _Params()
    p.symlen_out = code.symlen_out
    p.constraint_length = code.constraint_length
    p.block_length = code.block_length
    p.compat_parity = 1 if code.parity == PARITY_COMPAT else 0
    for i, poly in enumerate(code.polynomials):
        p.polynomials[i] = poly
    return p


def library_path(cc: str) -> Path:
    """Where the library built by compiler ``cc`` from the current source
    is (or will be)."""
    h = hashlib.sha256(" ".join((cc,) + CFLAGS).encode())
    h.update(_SRC.read_bytes())
    return BUILD_DIR / f"libconvcodes_native-{h.hexdigest()[:16]}.so"


@functools.lru_cache(maxsize=1)
def _load() -> Optional[ctypes.CDLL]:
    if not _SRC.exists():
        return None
    cc = os.environ.get("CC", "gcc")
    lib_path = library_path(cc)
    if not lib_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
        try:
            subprocess.run([cc, *CFLAGS, "-o", str(tmp), str(_SRC), "-lm"],
                           check=True, capture_output=True)
        except (OSError, subprocess.CalledProcessError):
            return None
        os.replace(tmp, lib_path)   # atomic: processes may build side by side
    lib = ctypes.CDLL(str(lib_path))
    i8p = np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    P, I32, I64, F = ctypes.POINTER(_Params), ctypes.c_int32, ctypes.c_int64, ctypes.c_float
    lib.cc_encode_blocks.argtypes = [P, i8p, i32p, I64]
    lib.cc_viterbi_soft_blocks.argtypes = [P, f32p, i8p, I64]
    lib.cc_viterbi_hard_blocks.argtypes = [P, i32p, i8p, i32p, I64]
    lib.cc_stack_soft_blocks.argtypes = [P, f32p, F, i8p, I64]
    lib.cc_stack_hard_blocks.argtypes = [P, i32p, I32, I32, i8p, I64]
    lib.cc_fano_soft_blocks.argtypes = [P, f32p, F, F, I32, i8p, i8p, I64]
    lib.cc_fano_hard_blocks.argtypes = [P, i32p, I32, I32, I32, I32, i8p, i8p, I64]
    return lib


def available() -> bool:
    return _load() is not None


def _lib() -> ctypes.CDLL:
    lib = _load()
    assert lib is not None, "native library unavailable"
    return lib


def encode_blocks(code: Code, bits: np.ndarray) -> np.ndarray:
    """bits [N, L] {0,1} → symbols [N, T] int32 (tail-terminated)."""
    lib = _lib()
    bits = np.ascontiguousarray(bits, dtype=np.int8)
    n, L = bits.shape
    assert L == code.block_length
    out = np.empty((n, code.num_block_symbols), dtype=np.int32)
    lib.cc_encode_blocks(ctypes.byref(_params(code)), bits, out, n)
    return out


def _soft_input(code: Code, dists: np.ndarray) -> np.ndarray:
    dists = np.ascontiguousarray(dists, dtype=np.float32)
    assert dists.shape[1:] == (code.num_block_symbols, code.points_per_symbol)
    return dists


def _hard_input(code: Code, rx: np.ndarray) -> np.ndarray:
    rx = np.ascontiguousarray(rx, dtype=np.int32)
    assert rx.shape[1] == code.num_block_symbols
    return rx


def viterbi_soft_blocks(code: Code, dists: np.ndarray) -> np.ndarray:
    """dists [N, T, 2^m] float32 → decoded bits [N, L] int8."""
    lib, dists = _lib(), _soft_input(code, dists)
    out = np.empty((dists.shape[0], code.block_length), dtype=np.int8)
    lib.cc_viterbi_soft_blocks(ctypes.byref(_params(code)), dists, out, dists.shape[0])
    return out


def viterbi_hard_blocks(code: Code, rx: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """rx [N, T] int32 symbols → (bits [N, L] int8, path metrics [N] int32)."""
    lib, rx = _lib(), _hard_input(code, rx)
    n = rx.shape[0]
    out = np.empty((n, code.block_length), dtype=np.int8)
    metrics = np.empty((n,), dtype=np.int32)
    lib.cc_viterbi_hard_blocks(ctypes.byref(_params(code)), rx, out, metrics, n)
    return out, metrics


def stack_soft_blocks(code: Code, dists: np.ndarray) -> np.ndarray:
    """dists [N, T, 2^m] float32 → decoded bits [N, L] int8."""
    lib, dists = _lib(), _soft_input(code, dists)
    out = np.empty((dists.shape[0], code.block_length), dtype=np.int8)
    lib.cc_stack_soft_blocks(ctypes.byref(_params(code)), dists,
                             ctypes.c_float(code.metric_weight), out, dists.shape[0])
    return out


def stack_hard_blocks(code: Code, rx: np.ndarray) -> np.ndarray:
    """rx [N, T] int32 symbols → decoded bits [N, L] int8."""
    lib, rx = _lib(), _hard_input(code, rx)
    out = np.empty((rx.shape[0], code.block_length), dtype=np.int8)
    lib.cc_stack_hard_blocks(ctypes.byref(_params(code)), rx, code.bit_metrics[0],
                             code.bit_metrics[1], out, rx.shape[0])
    return out


def fano_soft_blocks(code: Code, dists: np.ndarray, timeout_per_bit: int = 10000,
                     delta: float = 17.0) -> Tuple[np.ndarray, np.ndarray]:
    """dists [N, T, 2^m] float32 → (bits [N, L] int8, timed_out [N] int8)."""
    lib, dists = _lib(), _soft_input(code, dists)
    n = dists.shape[0]
    out = np.empty((n, code.block_length), dtype=np.int8)
    tout = np.empty((n,), dtype=np.int8)
    lib.cc_fano_soft_blocks(ctypes.byref(_params(code)), dists,
                            ctypes.c_float(code.fano_metric_weight), ctypes.c_float(delta),
                            timeout_per_bit, out, tout, n)
    return out, tout


def fano_hard_blocks(code: Code, rx: np.ndarray, timeout_per_bit: int = 10000,
                     delta: int = 17) -> Tuple[np.ndarray, np.ndarray]:
    """rx [N, T] int32 symbols → (bits [N, L] int8, timed_out [N] int8)."""
    lib, rx = _lib(), _hard_input(code, rx)
    n = rx.shape[0]
    out = np.empty((n, code.block_length), dtype=np.int8)
    tout = np.empty((n,), dtype=np.int8)
    lib.cc_fano_hard_blocks(ctypes.byref(_params(code)), rx, code.fano_bit_metrics[0],
                            code.fano_bit_metrics[1], delta, timeout_per_bit, out, tout, n)
    return out, tout
