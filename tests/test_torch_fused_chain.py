"""PyTorch port, fused Monte-Carlo chain: the hash RNG bit for bit against
the JAX interpret-mode generator, and the plain fused chain against the
pinned interpret-mode counters and a live interpret-mode JAX run.

Tolerances: the hash streams and every BSC counter exactly (no float
transcendental on that path); AWGN counters go through log/sqrt/sin/cos,
whose last ulp differs between torch and XLA on the CPU, so at least
120 of the 128 golden lanes must agree.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from convolutional_codes_tpu.models.codebook import get_code as jax_code
from convolutional_codes_tpu.ops import fused_chain as jfc
from convolutional_codes_tpu_torch.models.codebook import get_code
from convolutional_codes_tpu_torch.ops import fused_chain as fc
from convolutional_codes_tpu_torch.ops.channels import awgn_sigma

torch.set_num_threads(2)

GOLD_CASES = [
    (0, "bsc", "soft", 0.0125),
    (1, "bsc", "soft", 0.05),              # compat parity-quirk code
    (0, "awgn", "soft", float(awgn_sigma(6.0))),
    (0, "awgn", "hard", float(awgn_sigma(6.0))),
    (5, "awgn", "soft", float(awgn_sigma(4.0))),   # rate 1/3, 8-QAM
    ("nasa-k7", "awgn", "soft", float(awgn_sigma(4.0))),  # S=64
]


@pytest.mark.parametrize("shape,salt", [((7,), 0), ((42, 128), 1), ((3, 42, 64), 2),
                                        ((2, 5, 1024), 7)])
def test_interp_hash_matches_jax(shape, salt):
    rng = np.random.default_rng(sum(shape) + salt)
    for base in rng.integers(0, 1 << 32, 4, dtype=np.uint64):
        ref = np.asarray(jfc._interp_bits(shape, jnp.uint32(base), salt))
        idx = torch.arange(int(np.prod(shape)), dtype=torch.int64).reshape(shape)
        ours = fc._interp_bits(idx, torch.tensor(int(base)), salt).numpy()
        assert np.array_equal(ours, ref.astype(np.int64))
        ref_u = np.asarray(jfc._interp_uniform(shape, jnp.uint32(base), salt))
        ours_u = fc._interp_uniform(idx, torch.tensor(int(base)), salt).numpy()
        assert ours_u.dtype == np.float32 and np.array_equal(ours_u, ref_u)


@pytest.mark.parametrize("case", GOLD_CASES, ids=lambda c: f"{c[0]}-{c[1]}-{c[2]}")
def test_plain_chain_reproduces_pinned_counters(case):
    key, channel, demapper, param = case
    code = get_code(key)
    gold = np.load(os.path.join(os.path.dirname(__file__), "goldens",
                                "fused_interp_counters.npz"))
    launches = fc.mc_chain_viterbi.launches
    e, f = fc.mc_chain_viterbi(code, 128, 2, 11, param, channel, block_lanes=128,
                               demapper=demapper, device="cpu")
    assert fc.mc_chain_viterbi.launches == launches      # CPU: plain version
    name = f"{code.name}_{channel}_{demapper}"
    same = (e.numpy() == gold[name + "_e"]) & (f.numpy() == gold[name + "_f"])
    if channel == "bsc":
        assert same.all()
    else:
        assert same.sum() >= 120, f"{name}: {int(same.sum())}/128 lanes agree"


def test_plain_chain_equals_jax_interpret_bsc():
    code = get_code(0)
    kw = dict(batch=1024, nsteps=2, seed=123, param=0.03, channel="bsc",
              block_lanes=1024)
    e_j, f_j = jfc.mc_chain_viterbi(jax_code(0), interpret=True, **kw)
    e_t, f_t = fc.mc_chain_viterbi(code, device="cpu", **kw)
    assert np.array_equal(e_t.numpy(), np.asarray(e_j))
    assert np.array_equal(f_t.numpy(), np.asarray(f_j))
    assert int(e_t.sum()) > 0


def test_tile_width_keys_the_stream():
    """Same seed, different logical tile → a different (but valid) stream;
    the same tile → identical counters."""
    code = get_code(0)
    a = fc.mc_chain_viterbi(code, 256, 1, 5, 0.05, "bsc", block_lanes=128, device="cpu")
    b = fc.mc_chain_viterbi(code, 256, 1, 5, 0.05, "bsc", block_lanes=128, device="cpu")
    c = fc.mc_chain_viterbi(code, 256, 1, 5, 0.05, "bsc", block_lanes=256, device="cpu")
    assert torch.equal(a[0], b[0]) and not torch.equal(a[0], c[0])


def test_limits_raise():
    with pytest.raises(NotImplementedError):
        fc.mc_chain_viterbi(get_code("k15-r12"), 128, 1, 0, 0.05, "bsc", device="cpu")
    with pytest.raises(ValueError):
        fc.mc_chain_viterbi(get_code(0), 100, 1, 0, 0.05, "bsc", block_lanes=64,
                            device="cpu")
    with pytest.raises(ValueError):
        fc.mc_chain_viterbi(get_code(0), 128, 1, 0, 0.05, "awgn", device="meta")
