"""PyTorch port, differential fuzz on random user codes: the port's twin of
``tests/test_fuzz_differential.py``.

The goldens cover the shipped codes; users register codes at run time, so
this draws codes as the JAX fuzz does (random K, rate, polynomials with the
top bit set, parity mode, stack/Fano metrics and weights, block length),
makes noisy symbol streams with the port's encoder (checked equal to the C
oracle's first), and holds the port's plain decoders on CPU tensors —
Viterbi soft, hard with path metrics, stack and Fano, soft and hard —
against the C oracle (``utils/native.py``) bit for bit, Fano's timeout
flags included.  Big-K codes (K 28-32) go through the sequential decoders.
The twin holds against the oracle, not ``tests/golden_model.py`` (which
reads the JAX package's ``Code``); one more case runs a random code through
the JAX package's XLA decoders and the port's and requires equal bits.

Sizes as the JAX file: 6 frames a code on seeds 11, 22, 33, 44 (and 13,
15) and 4 on the big-K seeds 55, 66.  The draws take rates 1/2 to 1/8
(the JAX file: 1/2 and 1/3), every width the JAX package decodes.  Fano
runs with a budget of FANO_TPB SEARCH steps a bit on both sides (the JAX
file: 10,000): the plain machine takes about a
millisecond a micro-step, and these walks run to 24,000 micro-steps at the
full budget, so the longest walks here time out, which exercises the
timeout path as well.  Every comparison is exact.
"""

import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from convolutional_codes_tpu_torch.models.codebook import PARITY_COMPAT, Code
from convolutional_codes_tpu_torch.models.trellis import quirk_mask_low
from convolutional_codes_tpu_torch.ops import fano, stack
from convolutional_codes_tpu_torch.ops.encoder import encode
from convolutional_codes_tpu_torch.ops.viterbi import viterbi_decode_hard, viterbi_decode_soft
from convolutional_codes_tpu_torch.utils import native

pytestmark = pytest.mark.skipif(not native.available(), reason="no C compiler / native lib")

torch.set_num_threads(2)

#: 11-44 as the JAX file; 13 and 15 draw rates 1/8 and 1/6 with the compat
#: quirk biting
SEEDS = (11, 22, 33, 44, 13, 15)
BIG_K_SEEDS = (55, 66)
#: Fano's SEARCH budget a bit in these checks, on both sides
FANO_TPB = 50


ROOT = Path(__file__).resolve().parents[1]

#: argv = the repository and a directory holding job.pkl, (code, dists):
#: writes bits.npy, the C oracle's soft stack decode
ORACLE_STACK_WORKER = r"""
import pickle
import sys
import numpy as np
sys.path.insert(0, sys.argv[1])
from convolutional_codes_tpu_torch.utils import native
with open(f"{sys.argv[2]}/job.pkl", "rb") as f:
    code, dists = pickle.load(f)
np.save(f"{sys.argv[2]}/bits.npy", native.stack_soft_blocks(code, dists))
"""


def oracle_stack_soft_isolated(code: Code, dists: np.ndarray, tmp_path: Path) -> np.ndarray:
    """The C oracle's soft stack decode in a child process: on the alias
    corner it writes a byte past its row, which must not reach the test
    process's memory."""
    (tmp_path / "job.pkl").write_bytes(pickle.dumps((code, dists)))
    proc = subprocess.run([sys.executable, "-c", ORACLE_STACK_WORKER, str(ROOT), str(tmp_path)],
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    return np.load(tmp_path / "bits.npy")


def random_code(rng: np.random.Generator, idx: int) -> Code:
    """The JAX fuzz's ``_random_code``, K 3-6, with rates 1/2 to 1/8: every
    symbol width the JAX package's decoders take beyond rate 1/1."""
    K = int(rng.integers(3, 7))
    symlen = int(rng.integers(2, 9))
    polys = tuple(int(rng.integers(1, 1 << K)) | (1 << (K - 1)) for _ in range(symlen))
    wrong = -int(rng.integers(5, 60))
    return Code(name=f"fuzz-{idx}", symlen_out=symlen, constraint_length=K,
                block_length=int(rng.integers(8, 24)), polynomials=polys,
                bit_metrics=(1, wrong), fano_bit_metrics=(1, wrong - 5),
                metric_weight=-float(rng.integers(5, 25)),
                fano_metric_weight=-float(rng.integers(40, 220)),
                parity=("compat" if rng.integers(2) else "true"))


def random_big_code(rng: np.random.Generator, idx: int) -> Code:
    """The JAX fuzz's big-K draw: K 28-32, rate 1/2."""
    K = int(rng.integers(28, 33))
    polys = tuple(int(rng.integers(1, 1 << K)) | (1 << (K - 1)) for _ in range(2))
    wrong = -int(rng.integers(20, 50))
    return Code(name=f"fuzz-big-{idx}", symlen_out=2, constraint_length=K,
                block_length=int(rng.integers(12, 20)), polynomials=polys,
                bit_metrics=(1, wrong), fano_bit_metrics=(1, wrong - 8),
                metric_weight=-9.0, fano_metric_weight=-13.0,
                parity=("compat" if rng.integers(2) else "true"))


def noisy_streams(code: Code, rng: np.random.Generator, frames: int):
    """(bits, corrupted hard symbols, perturbed soft distance vectors), as
    the JAX fuzz's ``_noisy_streams``, the symbols from the port's encoder
    (equal to the oracle's)."""
    T, M = code.num_block_symbols, code.points_per_symbol
    bits = rng.integers(0, 2, (frames, code.block_length)).astype(np.int32)
    syms = encode(code, torch.as_tensor(bits)).numpy()
    assert np.array_equal(syms, native.encode_blocks(code, bits)), code
    flips = rng.random((frames, T, code.symlen_out)) < 0.06
    fl = (flips << np.arange(code.symlen_out)).sum(-1).astype(np.int32)
    hard_rx = syms ^ fl
    dists = np.array([[bin(e ^ s).count("1") for e in range(M)] for s in range(M)],
                     np.float32)[hard_rx]
    dists = dists + rng.random(dists.shape).astype(np.float32) * 0.25
    return bits, hard_rx, dists


def check_sequential(code: Code, hard_rx: np.ndarray, dists: np.ndarray) -> None:
    td, trx = torch.as_tensor(dists), torch.as_tensor(hard_rx)
    assert np.array_equal(stack.stack_decode_soft(code, td).numpy(),
                          native.stack_soft_blocks(code, dists)), ("stack_soft", code)
    assert np.array_equal(stack.stack_decode_hard(code, trx).numpy(),
                          native.stack_hard_blocks(code, hard_rx)), ("stack_hard", code)
    for soft, x, oracle in ((True, td, native.fano_soft_blocks),
                            (False, trx, native.fano_hard_blocks)):
        bits, diag = fano.fano_machine(code, x, soft, FANO_TPB)
        nb, nt = oracle(code, x.numpy(), FANO_TPB)
        assert np.array_equal(bits.numpy(), nb), ("fano", soft, code)
        assert np.array_equal(diag["timed_out"].numpy().astype(np.int8), nt), ("fano", soft, code)


@pytest.mark.parametrize("seed", SEEDS)
def test_random_code_decoders_match_oracle(seed):
    rng = np.random.default_rng(seed)
    code = random_code(rng, seed)
    _, hard_rx, dists = noisy_streams(code, rng, 6)
    assert np.array_equal(viterbi_decode_soft(code, torch.as_tensor(dists)).numpy(),
                          native.viterbi_soft_blocks(code, dists)), ("viterbi_soft", code)
    pb, pm = viterbi_decode_hard(code, torch.as_tensor(hard_rx))
    nb, nm = native.viterbi_hard_blocks(code, hard_rx)
    assert np.array_equal(pb.numpy(), nb), ("viterbi_hard", code)
    assert np.array_equal(pm.numpy(), nm), ("viterbi_hard_metric", code)
    check_sequential(code, hard_rx, dists)


@pytest.mark.parametrize("seed", BIG_K_SEEDS)
def test_random_big_k_sequential_matches_oracle(seed):
    """WSPR-class constraint lengths: the sequential decoders carry the
    encoder state in wide integers; Viterbi is excluded (2^(K-1) states)."""
    rng = np.random.default_rng(seed)
    code = random_big_code(rng, seed)
    _, hard_rx, dists = noisy_streams(code, rng, 4)
    check_sequential(code, hard_rx, dists)


def test_draws_reach_the_compat_quirk():
    """At least one drawn code has compat parity with a polynomial that taps
    the quirk's register bits, so the quirk's corruption is exercised."""
    hits = []
    for seed in SEEDS + BIG_K_SEEDS:
        rng = np.random.default_rng(seed)
        code = (random_code if seed in SEEDS else random_big_code)(rng, seed)
        qmask = quirk_mask_low(code.constraint_length)
        if code.parity == PARITY_COMPAT and any(p & qmask for p in code.polynomials):
            hits.append(seed)
    assert len(hits) >= 2, hits


def test_random_code_port_equals_jax_xla():
    """One random code through the JAX package's XLA decoders and the
    port's plain ones on the same numpy inputs: equal bits (and hard
    Viterbi metrics), tying the port to the JAX package directly."""
    from convolutional_codes_tpu.models.codebook import Code as JaxCode
    from convolutional_codes_tpu.ops import fano as jfano
    from convolutional_codes_tpu.ops import stack as jstack
    from convolutional_codes_tpu.ops import viterbi as jviterbi

    rng = np.random.default_rng(77)
    code = random_code(rng, 77)
    jcode = JaxCode(**{f: getattr(code, f) for f in code.__dataclass_fields__})
    _, hard_rx, dists = noisy_streams(code, rng, 6)
    td, trx = torch.as_tensor(dists), torch.as_tensor(hard_rx)
    jd, jrx = jnp.asarray(dists), jnp.asarray(hard_rx)
    pairs = [
        (viterbi_decode_soft(code, td), jviterbi.viterbi_decode_soft(jcode, jd)),
        (stack.stack_decode_soft(code, td), jstack.stack_decode_soft(jcode, jd)),
        (stack.stack_decode_hard(code, trx), jstack.stack_decode_hard(jcode, jrx)),
        (fano.fano_decode_soft(code, td, FANO_TPB), jfano.fano_decode_soft(jcode, jd, FANO_TPB)),
        (fano.fano_decode_hard(code, trx, FANO_TPB), jfano.fano_decode_hard(jcode, jrx, FANO_TPB)),
    ]
    pairs += zip(viterbi_decode_hard(code, trx), jviterbi.viterbi_decode_hard(jcode, jrx))
    for i, (ours, ref) in enumerate(pairs):
        assert np.array_equal(ours.numpy(), np.asarray(ref)), (i, code)


def test_stack_alias_corner_follows_the_jax_package(tmp_path):
    """The stack decoder's alias corner, met on real frames: at capacity with
    every live metric equal, the best path is also the slot its duplicate
    overwrites.  A big-K compat code whose quirk zeroes both branches'
    symbols (chip_smoke.py's random big-K draw) reaches it on frame 67 of
    its 512 noisy frames.  There the C oracle extends the one path twice
    (writing past its row) and the scalar spec (tests/golden_model.py)
    fails with an IndexError; the port's plain machine keeps one input-0
    extension, as the JAX package's kernels do, and its bits equal the
    JAX XLA decoder's on every frame.  Every frame where the port and the
    oracle part ways is such a frame.  The oracle runs in a child process
    (its write past the row is undefined behaviour)."""
    import tests.golden_model as gm
    from convolutional_codes_tpu.models.codebook import Code as JaxCode
    from convolutional_codes_tpu.ops import stack as jstack
    from convolutional_codes_tpu_torch.models.constellations import get_constellation

    code = Code(name="random-big-k", symlen_out=2, constraint_length=28, block_length=13,
                polynomials=(0o1434102571, 0o1276643721), bit_metrics=(1, -23),
                fano_bit_metrics=(1, -31), metric_weight=-9.0, fano_metric_weight=-13.0,
                parity="compat")
    jcode = JaxCode(**{f: getattr(code, f) for f in code.__dataclass_fields__})
    rng = np.random.default_rng(56)            # chip_smoke.oracle_frames(code, 512, 56)
    n, T = 512, code.num_block_symbols
    syms = native.encode_blocks(code, rng.integers(0, 2, (n, code.block_length)))
    const = np.asarray(get_constellation(2), np.float32)
    d = (const[syms] + rng.normal(0.0, 0.4, (n, T, 2)).astype(np.float32))[:, :, None] - const
    dists = ((d * d).sum(-1) / ((const[0] - const[1]) ** 2).sum()).astype(np.float32)[60:76]
    ours = stack.stack_decode_soft(code, torch.as_tensor(dists)).numpy()
    assert np.array_equal(ours, np.asarray(jstack.stack_decode_soft(jcode, jnp.asarray(dists))))
    off = np.where((ours != oracle_stack_soft_isolated(code, dists, tmp_path)).any(1))[0]
    assert list(off) == [7]                    # frame 67
    for i in range(len(dists)):
        if i in off:
            with pytest.raises(IndexError):
                gm.stack_soft(jcode, dists[i])
        else:
            assert np.array_equal(gm.stack_soft(jcode, dists[i]), ours[i])


def test_rate_quarter_code_viterbi_matches_oracle():
    """A random rate-1/4 code (16 points, K = 8): the plain Viterbi equals
    the oracle, and the ACS kernel's limits admit it and codes of up to 8
    coded bits a symbol (256 points), as the JAX package's ACS kernels take
    any M; before, the card refused such codes that the JAX package
    decodes (M > 16 until now)."""
    from convolutional_codes_tpu_torch.ops import viterbi_cuda as vc

    rng = np.random.default_rng(88)
    K = 8
    code = Code(name="fuzz-r14", symlen_out=4, constraint_length=K, block_length=20,
                polynomials=tuple(int(rng.integers(1, 1 << K)) | (1 << (K - 1))
                                  for _ in range(4)), parity="compat")
    vc._check_code(code)
    _, hard_rx, dists = noisy_streams(code, rng, 8)
    assert np.array_equal(viterbi_decode_soft(code, torch.as_tensor(dists)).numpy(),
                          native.viterbi_soft_blocks(code, dists))
    pb, pm = viterbi_decode_hard(code, torch.as_tensor(hard_rx))
    nb, nm = native.viterbi_hard_blocks(code, hard_rx)
    assert np.array_equal(pb.numpy(), nb) and np.array_equal(pm.numpy(), nm)
    for extra in ((0o201,), (0o201, 0o311, 0o245, 0o377)):   # rates 1/5 and 1/8
        vc._check_code(code.replace(symlen_out=4 + len(extra),
                                    polynomials=code.polynomials + extra))
    with pytest.raises(ValueError, match="S <= 256"):
        vc._check_code(code.replace(constraint_length=10, polynomials=(0o1001,) * 4))
