"""PyTorch port, the C oracle (``utils/native.py``): the port's twin of
``tests/test_native.py``.

The oracle, built from ``native/convcodes_native.c`` by the port's own
binding, reproduces every golden that ``test_native.py`` checks (encoder,
Viterbi soft and hard with path metrics, stack, Fano); then the port's
plain decoders (``ops/viterbi.py``, ``ops/stack.py``, ``ops/fano.py`` on
CPU tensors) are held against it on random inputs.  Every comparison is
exact.

Sizes: Viterbi on 64 random frames per code, as ``test_native.py``; stack
and Fano on 32 noisy codeword frames (2 of them pure noise) per code where
the JAX test takes 256 (16), since the plain machines are lockstep loops
over the batch; Fano with a budget of 20 SEARCH steps a bit on both sides,
so the pure-noise frames time out within a few thousand micro-steps.
"""

import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

from conftest import load_golden
from convolutional_codes_tpu_torch.models.codebook import get_code
from convolutional_codes_tpu_torch.models.constellations import get_constellation
from convolutional_codes_tpu_torch.ops import fano, stack
from convolutional_codes_tpu_torch.ops.encoder import encode
from convolutional_codes_tpu_torch.ops.viterbi import viterbi_decode_hard, viterbi_decode_soft
from convolutional_codes_tpu_torch.utils import native

pytestmark = pytest.mark.skipif(not native.available(), reason="no C compiler / native lib")

torch.set_num_threads(2)

#: Fano's SEARCH budget per bit in the random-input checks (both sides)
FANO_TPB = 20


def test_builds_into_the_ports_own_directory():
    """``build/native/`` under the repository root, never ``native/build/``
    (the JAX package's copy writes there)."""
    root = Path(__file__).resolve().parents[1]
    assert native.BUILD_DIR == root / "build" / "native"
    assert native.library_path("gcc").parent == native.BUILD_DIR


@pytest.mark.parametrize("idx", range(6))
def test_encoder_matches_goldens(idx):
    g = load_golden(f"enc_{idx}.npz")
    assert np.array_equal(native.encode_blocks(get_code(idx), g["bits"]), g["symbols"])


@pytest.mark.parametrize("idx", [0, 1, 2, 3, 5])
@pytest.mark.parametrize("mode", [0, 1])
def test_viterbi_matches_goldens(idx, mode):
    code = get_code(idx)
    gs = load_golden(f"viterbi_soft_{idx}_m{mode}.npz")
    assert np.array_equal(native.viterbi_soft_blocks(code, gs["dists"]), gs["decoded"])
    gh = load_golden(f"viterbi_hard_{idx}_m{mode}.npz")
    bits, metrics = native.viterbi_hard_blocks(code, gh["received"].astype(np.int32))
    assert np.array_equal(bits, gh["decoded"])
    assert np.array_equal(metrics, gh["metrics"])


@pytest.mark.parametrize("idx", range(6))
@pytest.mark.parametrize("mode", [0, 1])
def test_stack_matches_goldens(idx, mode):
    code = get_code(idx)
    gs = load_golden(f"stack_soft_{idx}_m{mode}.npz")
    assert np.array_equal(native.stack_soft_blocks(code, gs["dists"]), gs["decoded"])
    gh = load_golden(f"stack_hard_{idx}_m{mode}.npz")
    assert np.array_equal(native.stack_hard_blocks(code, gh["received"].astype(np.int32)),
                          gh["decoded"])


@pytest.mark.parametrize("idx", range(6))
@pytest.mark.parametrize("mode", [0, 1])
def test_fano_matches_goldens(idx, mode):
    code = get_code(idx)
    gs = load_golden(f"fano_soft_{idx}_m{mode}.npz")
    assert np.array_equal(native.fano_soft_blocks(code, gs["dists"])[0], gs["decoded"])
    gh = load_golden(f"fano_hard_{idx}_m{mode}.npz")
    assert np.array_equal(native.fano_hard_blocks(code, gh["received"].astype(np.int32))[0],
                          gh["decoded"])


@pytest.mark.parametrize("idx", [0, 3, 5, "nasa-k7"])
def test_plain_viterbi_matches_oracle(idx):
    """Random bits through the port's encoder, random distance vectors and
    received symbols through its plain Viterbi: bits and hard path metrics
    equal to the oracle's."""
    code = get_code(idx)
    rng = np.random.default_rng(zlib.crc32(str(idx).encode()))
    N, T, M = 64, code.num_block_symbols, code.points_per_symbol
    bits = rng.integers(0, 2, size=(N, code.block_length))
    assert np.array_equal(encode(code, torch.as_tensor(bits)).numpy(),
                          native.encode_blocks(code, bits))
    dists = rng.random((N, T, M)).astype(np.float32)
    assert np.array_equal(viterbi_decode_soft(code, torch.as_tensor(dists)).numpy(),
                          native.viterbi_soft_blocks(code, dists))
    rx = rng.integers(0, M, size=(N, T)).astype(np.int32)
    pb, pm = viterbi_decode_hard(code, torch.as_tensor(rx))
    nb, nm = native.viterbi_hard_blocks(code, rx)
    assert np.array_equal(pb.numpy(), nb)
    assert np.array_equal(pm.numpy(), nm)


@pytest.mark.parametrize("idx", [0, 3, 5, "k9-r12"])
def test_plain_sequential_matches_oracle(idx):
    """Noisy codewords (and pure-noise frames) through the port's plain
    stack and Fano machines, soft and hard: bits equal to the oracle's,
    and Fano's timeout flags too."""
    code = get_code(idx)
    rng = np.random.default_rng(zlib.crc32(f"seqfuzz-{idx}".encode()))
    N, T, M = 32, code.num_block_symbols, code.points_per_symbol
    bits = rng.integers(0, 2, size=(N, code.block_length))
    syms = native.encode_blocks(code, bits)
    const = np.asarray(get_constellation(code.symlen_out), np.float32)
    iq = const[syms] + rng.normal(0.0, 0.45, (N, T, 2)).astype(np.float32)
    d = iq[:, :, None, :] - const
    ndist = ((const[0] - const[1]) ** 2).sum()
    dists = ((d * d).sum(-1) / ndist).astype(np.float32)
    dists[N - 2:] = rng.random((2, T, M), np.float32) * 4.0      # pure noise
    td = torch.as_tensor(dists)
    assert np.array_equal(stack.stack_decode_soft(code, td).numpy(),
                          native.stack_soft_blocks(code, dists))
    pf, diag = fano.fano_decode_soft_with_diag(code, td, FANO_TPB)
    nf, nt = native.fano_soft_blocks(code, dists, FANO_TPB)
    assert np.array_equal(pf.numpy(), nf)
    assert np.array_equal(diag["timed_out"].numpy().astype(np.int8), nt)
    assert nt[N - 2:].all()                      # the budget runs out on pure noise

    flips = (rng.random((N, T)) < 0.04) * rng.integers(0, M, (N, T))
    rx = (syms ^ flips).astype(np.int32)
    trx = torch.as_tensor(rx)
    assert np.array_equal(stack.stack_decode_hard(code, trx).numpy(),
                          native.stack_hard_blocks(code, rx))
    pf, diag = fano.fano_decode_hard_with_diag(code, trx, FANO_TPB)
    nf, nt = native.fano_hard_blocks(code, rx, FANO_TPB)
    assert np.array_equal(pf.numpy(), nf)
    assert np.array_equal(diag["timed_out"].numpy().astype(np.int8), nt)
