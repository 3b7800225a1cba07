"""PyTorch port, plain Fano decoder: bit-exact on the C-reference goldens
and against the JAX package's XLA Fano decoder on the same numpy inputs,
including timeout-rich walks.  Every comparison is exact: both sides add
the same rounded float32 metrics in the same order, and thresholds stay
multiples of DELTA.

The plain decoder is a lockstep machine whose every micro-step costs a few
dozen tensor operations, so it is held here on the goldens whose walks end
within ~22,000 SEARCH steps (hard m1 of every code, soft m1 of codes 4 and
5).  The other Fano goldens (random-symbol m0 files, soft m1 of codes 0-3,
``fano_fma_regression.npz``) walk 1e5-8e5 steps per frame; chip_smoke.py
decodes every one of them bit for bit through kernel 8's device code on the
card.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from conftest import load_golden
from convolutional_codes_tpu.models.codebook import get_code as jax_code
from convolutional_codes_tpu.ops import fano as jfano
from convolutional_codes_tpu_torch.models.codebook import get_code
from convolutional_codes_tpu_torch.ops import fano
from convolutional_codes_tpu_torch.ops import mc_datagen as dg
from convolutional_codes_tpu_torch.ops.channels import awgn_sigma

torch.set_num_threads(2)


@pytest.mark.parametrize("kind,idx", [("hard", i) for i in range(6)]
                         + [("soft", 4), ("soft", 5)])
def test_goldens(kind, idx):
    g = load_golden(f"fano_{kind}_{idx}_m1.npz")
    if kind == "soft":
        out = fano.fano_decode_soft(get_code(idx), torch.as_tensor(g["dists"]))
    else:
        out = fano.fano_decode_hard(get_code(idx), torch.as_tensor(g["received"]))
    assert out.dtype == torch.int32 and np.array_equal(out.numpy(), g["decoded"])


@pytest.mark.parametrize("ck,channel,point,tpb", [
    (0, "awgn", 2.0, 40),            # timeout-rich: exhaustion and relaxes
    (0, "bsc", 0.05, 60),
    (4, "awgn", 5.0, 25),            # WSPR K=32, compat quirk on P1
    (4, "bsc", 0.02, 30),
    (5, "awgn", 3.0, 50)], ids=str)
def test_matches_jax_xla_with_diag(ck, channel, point, tpb):
    code = get_code(ck)
    param = float(awgn_sigma(point)) if channel == "awgn" else point
    _, syms = dg.frames_host(code, np.arange(32), 3, param, channel)
    x = jnp.asarray(syms.numpy())
    if channel == "awgn":
        bits, diag = fano.fano_decode_soft_with_diag(code, syms, tpb)
        ref, rdiag = jfano.fano_decode_soft_with_diag(jax_code(ck), x, tpb)
    else:
        bits, diag = fano.fano_decode_hard_with_diag(code, syms, tpb)
        ref, rdiag = jfano.fano_decode_hard_with_diag(jax_code(ck), x, tpb)
    assert np.array_equal(bits.numpy(), np.asarray(ref))
    for k in ("timeout_left", "depth", "timed_out"):
        assert np.array_equal(diag[k].numpy(), np.asarray(rdiag[k])), k
    assert np.array_equal(diag["metric"].numpy(), np.asarray(rdiag["metric"], np.float32))
    if ck == 0 and channel == "awgn":
        assert bool(diag["timed_out"].any())


def test_noiseless_roundtrip():
    code = get_code("k15-r12")
    bits = np.random.default_rng(11).integers(0, 2, (4, code.block_length))
    from convolutional_codes_tpu_torch.ops.encoder import encode
    syms = encode(code, torch.as_tensor(bits))
    assert np.array_equal(fano.fano_decode_hard(code, syms).numpy(), bits)
    dists = torch.ones(syms.shape + (code.points_per_symbol,))
    dists.scatter_(-1, syms.long()[..., None], 0.0)
    assert np.array_equal(fano.fano_decode_soft(code, dists).numpy(), bits)
