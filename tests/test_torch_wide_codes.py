"""PyTorch port, codes of 4-8 coded bits a symbol (16-256 points): every
path the JAX package decodes them on, held against it and the C oracle.

The JAX package takes ``symlen_out`` 1-8 (``models/codebook.py``); its
decoders of supplied frames take any symbol width, and its Monte-Carlo
kernels (the long-frame chain, TPU kernel 6, and the sequential kernels
7-8) any width with a registered constellation.  Here:

* kernel 6's plain version (``mc_longframe_viterbi_ref``) against the JAX
  interpret-mode kernel on a rate-1/4 code (16 points) and on the probe
  code (K = 3, polys 0o7 0o5 0o6 0o3 0o1, 32 points);
* the sequential Monte-Carlo plain versions (``mc_stack_ref``,
  ``mc_fano_ref``) against the JAX interpret-mode kernels on the probe
  code (BSC, totals), and against the JAX XLA decoders on the port's own
  frames (AWGN, per lane);
* hard and soft Viterbi, stack and Fano on supplied frames of a symlen-5
  and a symlen-8 code against the JAX XLA decoders and the C oracle.

Codes of 5-8 bits have no constellation in either package: the tests
register the same rectangular unit-power grids in both for their duration
(``wide_constellations``), and without them both packages raise
``ValueError`` on every Monte-Carlo path, BSC included, because their
datagen builds its stage helpers from the constellation on every channel.

Tolerances: BSC counters and every decode exactly; AWGN long-frame
counters on at most 1 of 128 lanes off (log/sqrt/sin/cos differ in the
last ulp between torch's and XLA's CPU kernels, as in
tests/test_torch_fused_longframe.py).
"""

import contextlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from convolutional_codes_tpu.models import constellations as jax_constellations
from convolutional_codes_tpu.models.codebook import Code as JaxCode
from convolutional_codes_tpu.ops import fano as jfano
from convolutional_codes_tpu.ops import fano_mc as jfano_mc
from convolutional_codes_tpu.ops import fused_longframe as jfl
from convolutional_codes_tpu.ops import stack as jstack
from convolutional_codes_tpu.ops import stack_mc as jstack_mc
from convolutional_codes_tpu.ops import viterbi as jviterbi
from convolutional_codes_tpu_torch.models import constellations
from convolutional_codes_tpu_torch.models.codebook import Code
from convolutional_codes_tpu_torch.ops import fano, fano_mc, mc_datagen, stack, stack_mc
from convolutional_codes_tpu_torch.ops import fused_longframe as fl
from convolutional_codes_tpu_torch.ops.channels import awgn_sigma
from convolutional_codes_tpu_torch.ops.viterbi import viterbi_decode_hard, viterbi_decode_soft
from convolutional_codes_tpu_torch.utils import native

torch.set_num_threads(2)

#: the probe code: K = 3, rate 1/5 (32 points)
PROBE = Code(name="probe-r15", symlen_out=5, constraint_length=3, block_length=12,
             polynomials=(0o7, 0o5, 0o6, 0o3, 0o1))
#: a rate-1/4 code (16 points, the registered 16-QAM) that kernel 6 refused
R14 = Code(name="wide-r14", symlen_out=4, constraint_length=5, block_length=24,
           polynomials=(0o23, 0o35, 0o27, 0o31), parity="compat")
#: supplied-frame codes of 5 and 8 coded bits a symbol
R15 = Code(name="wide-r15", symlen_out=5, constraint_length=4, block_length=16,
           polynomials=(0o13, 0o15, 0o17, 0o11, 0o16), bit_metrics=(1, -11),
           fano_bit_metrics=(1, -16), metric_weight=-9.0, fano_metric_weight=-60.0,
           parity="compat")
R18 = Code(name="wide-r18", symlen_out=8, constraint_length=3, block_length=14,
           polynomials=(0o7, 0o5, 0o6, 0o3, 0o4, 0o7, 0o5, 0o6), bit_metrics=(1, -9),
           fano_bit_metrics=(1, -14), metric_weight=-7.0, fano_metric_weight=-90.0)
FANO_TPB = 30


def jax_twin(code: Code) -> JaxCode:
    return JaxCode(**{f: getattr(code, f) for f in code.__dataclass_fields__})


def rect_points(bits: int) -> np.ndarray:
    """A rectangular 2^ceil(b/2) x 2^floor(b/2) grid, unit average power.
    The same as chip_smoke.py's (which the tests do not import); the port
    itself ships no constellation of 5-8 bits: a user registers their own."""
    nx, ny = 1 << ((bits + 1) // 2), 1 << (bits // 2)
    pts = np.array([(x, y) for x in np.arange(nx) * 2 - (nx - 1)
                    for y in np.arange(ny) * 2 - (ny - 1)], np.float64)
    return (pts / np.sqrt((pts ** 2).sum(1).mean())).astype(np.float32)


@contextlib.contextmanager
def wide_constellations(widths=(5, 8)):
    """The same ``rect_points`` constellations of ``widths`` bits registered
    in the port and the JAX package, and taken out again afterwards."""
    modules = (constellations, jax_constellations)
    for bits in widths:
        for m in modules:
            m.register_constellation(bits, rect_points(bits), overwrite=True)
    try:
        yield
    finally:
        for m in modules:
            for bits in widths:
                m._TABLES.pop(bits, None)
            m.get_constellation.cache_clear()
            for clear in m._dependent_cache_clears:
                clear()


@pytest.fixture
def wide():
    with wide_constellations():
        yield


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """One intra-op thread: torch's float32 transcendentals on the CPU split
    tensors of more than 2048 elements between threads, and the second
    share can come out ulps off (ROADMAP Q3, "torch's float32 transcendentals")."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("code", [R14, PROBE], ids=lambda c: c.name)
@pytest.mark.parametrize("channel,param", [("bsc", 0.12), ("awgn", float(awgn_sigma(1.0)))])
def test_longframe_plain_matches_jax_interpret(wide, code, channel, param):
    """Kernel 6's plain version at M = 16 and 32, which the port refused
    before while the JAX kernel decodes any M."""
    be, we = fl.mc_longframe_viterbi(code, 128, 2, 7, param, channel, window=64, warmup=32,
                                     device="cpu")
    jbe, jwe = jfl.mc_longframe_viterbi(jax_twin(code), 128, 2, 7, param, channel=channel,
                                        window=64, warmup=32, block_lanes=128, interpret=True)
    differ = int(((be.numpy() != np.asarray(jbe)) | (we.numpy() != np.asarray(jwe))).sum())
    assert differ == 0 if channel == "bsc" else differ <= 1, (code.name, channel, differ)
    assert int(be.sum()) > 0


def test_sequential_mc_plain_matches_jax_interpret(wide):
    """The stack and Fano Monte-Carlo plain versions on the probe code
    (BSC): the totals of the JAX interpret-mode kernels, exactly."""
    jcode = jax_twin(PROBE)
    ours = stack_mc.mc_stack_ref(PROBE, 8, 2, 5, 0.06, "bsc")
    want = jstack_mc.mc_stack(jcode, 8, 2, 5, 0.06, channel="bsc", interpret=True)
    assert (int(ours[0].sum()), int(ours[1].sum())) == want[:2] and want[0] > 0
    ours = fano_mc.mc_fano_ref(PROBE, 8, 2, 5, 0.06, "bsc", timeout_per_bit=10)
    want = jfano_mc.mc_fano(jcode, 8, 2, 5, 0.06, channel="bsc", timeout_per_bit=10,
                            block_lanes=8, interpret=True)
    assert (int(ours[0].sum()), int(ours[1].sum())) == want[:2] and want[0] > 0


@pytest.mark.parametrize("code,decoder,demapper", [(PROBE, "stack", "soft"),
                                                    (R18, "fano", "hard")], ids=str)
def test_sequential_mc_awgn_counts_match_jax_decoders(wide, code, decoder, demapper):
    """AWGN (soft and snap-then-soft demapper) on the probe and the symlen-8
    code: per-lane counters equal the JAX XLA decoder run on the port's own
    frames."""
    sigma = float(awgn_sigma(3.0))
    jcode = jax_twin(code)
    bits, syms = mc_datagen.frames_host(code, np.arange(16), 42, sigma, "awgn", demapper)
    if decoder == "stack":
        ours = stack_mc.mc_stack_ref(code, 8, 2, 42, sigma, "awgn", demapper)
        dec = jstack.stack_decode_soft(jcode, jnp.asarray(syms.numpy()))
    else:
        ours = fano_mc.mc_fano_ref(code, 8, 2, 42, sigma, "awgn", demapper, FANO_TPB)
        dec = jfano.fano_decode_soft(jcode, jnp.asarray(syms.numpy()), FANO_TPB)
    err = (np.asarray(dec) != bits.numpy()[:, :code.block_length]).sum(1).reshape(8, 2)
    assert np.array_equal(ours[:2].numpy(), np.stack([err.sum(1), (err > 0).sum(1)]))
    assert int(ours[0].sum()) > 0


def test_monte_carlo_paths_refuse_a_width_without_constellation():
    """Without a registered 5-bit constellation both packages raise
    ValueError on every Monte-Carlo path, BSC included.  (A code object of
    its own: the JAX package caches built kernels by code, and a kernel
    built while the constellation was registered would not raise.)"""
    jcode = jax_twin(PROBE.replace(name="probe-r15-unregistered"))
    for call in (lambda: stack_mc.mc_stack_ref(PROBE, 8, 1, 0, 0.05, "bsc"),
                 lambda: fano_mc.mc_fano_ref(PROBE, 8, 1, 0, 0.05, "bsc"),
                 lambda: fl.mc_longframe_viterbi_ref(PROBE, 8, 1, 0, 0.05, "bsc"),
                 lambda: jstack_mc.mc_stack(jcode, 8, 1, 0, 0.05, channel="bsc",
                                            interpret=True),
                 lambda: jfl.mc_longframe_viterbi(jcode, 8, 1, 0, 0.05, channel="bsc",
                                                  block_lanes=8, interpret=True)):
        with pytest.raises(ValueError, match="constellation"):
            call()


def noisy_frames(code: Code, seed: int, frames: int = 6):
    """(hard symbols [B, T] int32, soft distances [B, T, M] float32): the
    oracle's encoder on random bits, coded bits flipped with probability
    0.06, and Hamming distances to every point plus uniform noise."""
    rng = np.random.default_rng(seed)
    T, M = code.num_block_symbols, code.points_per_symbol
    syms = native.encode_blocks(code, rng.integers(0, 2, (frames, code.block_length)))
    flips = (rng.random((frames, T, code.symlen_out)) < 0.06) << np.arange(code.symlen_out)
    rx = (syms ^ flips.sum(-1)).astype(np.int32)
    ham = np.array([[bin(e ^ s).count("1") for e in range(M)] for s in range(M)], np.float32)
    dists = ham[rx] + rng.random((frames, T, M)).astype(np.float32) * 0.25
    return rx, dists


@pytest.mark.parametrize("code", [R15, R18], ids=lambda c: c.name)
def test_supplied_frame_decoders_match_jax_and_oracle(code):
    """Viterbi (soft, hard with path metrics), stack and Fano (soft, hard)
    on supplied frames of 5 and 8 coded bits a symbol: the port's plain
    decoders equal the JAX XLA decoders and the C oracle bit for bit."""
    jcode = jax_twin(code)
    rx, dists = noisy_frames(code, code.symlen_out)
    td, trx, jd, jrx = torch.as_tensor(dists), torch.as_tensor(rx), jnp.asarray(dists), \
        jnp.asarray(rx)
    vb, vm = viterbi_decode_hard(code, trx)
    nb, nm = native.viterbi_hard_blocks(code, rx)
    jb, jm = jviterbi.viterbi_decode_hard(jcode, jrx)
    assert np.array_equal(vb.numpy(), nb) and np.array_equal(vm.numpy(), nm)
    assert np.array_equal(vb.numpy(), np.asarray(jb)) and np.array_equal(vm.numpy(),
                                                                          np.asarray(jm))
    triples = [
        (viterbi_decode_soft(code, td), jviterbi.viterbi_decode_soft(jcode, jd),
         native.viterbi_soft_blocks(code, dists)),
        (stack.stack_decode_soft(code, td), jstack.stack_decode_soft(jcode, jd),
         native.stack_soft_blocks(code, dists)),
        (stack.stack_decode_hard(code, trx), jstack.stack_decode_hard(jcode, jrx),
         native.stack_hard_blocks(code, rx)),
        (fano.fano_decode_soft(code, td, FANO_TPB), jfano.fano_decode_soft(jcode, jd, FANO_TPB),
         native.fano_soft_blocks(code, dists, FANO_TPB)[0]),
        (fano.fano_decode_hard(code, trx, FANO_TPB), jfano.fano_decode_hard(jcode, jrx, FANO_TPB),
         native.fano_hard_blocks(code, rx, FANO_TPB)[0]),
    ]
    for i, (ours, ref, oracle) in enumerate(triples):
        assert np.array_equal(ours.numpy(), np.asarray(ref)), (i, code.name)
        assert np.array_equal(ours.numpy(), oracle), (i, code.name)
    assert (vb.numpy() != 0).any()
