"""PyTorch port, chain stages: code tables, encoder, mapper, channels and
demappers against the JAX reference package and its goldens.

Inputs come from numpy seeds and pass between the packages as numpy
arrays.  Tolerances: integer outputs and ``awgn_sigma`` exactly; demapper
distances within 4 float32 ulp (XLA-CPU may contract ``d0*d0 + d1*d1``
into an FMA, torch rounds each product); channel moments within 5 sigma.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from conftest import load_golden
from convolutional_codes_tpu.models.codebook import get_code as jax_code
from convolutional_codes_tpu.models.constellations import get_constellation, min_sq_distance
from convolutional_codes_tpu.models.trellis import build_trellis
from convolutional_codes_tpu.ops import channels as jch
from convolutional_codes_tpu.ops import demapper as jdm
from convolutional_codes_tpu.ops import encoder as jenc
from convolutional_codes_tpu.ops import mapper as jmap
from convolutional_codes_tpu_torch.models.codebook import get_code
from convolutional_codes_tpu_torch.models.tables import code_tables
from convolutional_codes_tpu_torch.ops import channels, demapper, encoder, mapper
from convolutional_codes_tpu_torch.utils.bitops import parity32, popcount32

torch.set_num_threads(2)


def ulps(a, b):
    a = np.ascontiguousarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.ascontiguousarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


@pytest.mark.parametrize("key", [0, 1, 2, 3, 5, "nasa-k7", "k9-r12"])
def test_code_tables_match_numpy_trellis(key):
    code = get_code(key)
    t = code_tables(code, "cpu")
    tr = build_trellis(jax_code(key))
    assert np.array_equal(t.prev_state.numpy(), tr.prev_state)
    assert np.array_equal(t.esym_prev.numpy(), tr.esym_prev)
    assert np.array_equal(t.esym_prev_np, tr.esym_prev)
    pts = get_constellation(code.symlen_out)
    assert np.array_equal(t.points.numpy(), pts)
    assert t.min_sq_distance == min_sq_distance(code.symlen_out)
    assert t.nwords == (code.num_states + 31) // 32
    assert code_tables(code, "cpu") is t                 # cached


def test_code_tables_without_dense_trellis():
    t = code_tables(get_code("wspr-k32"), "cpu")
    assert t.prev_state is None and t.esym_prev is None
    assert t.quirk_mask != 0                             # compat code


@pytest.mark.parametrize("idx", range(6))
def test_encoder_matches_golden(idx):
    g = load_golden(f"enc_{idx}.npz")
    out = encoder.encode(get_code(idx), torch.as_tensor(g["bits"]))
    assert out.dtype == torch.int32
    assert np.array_equal(out.numpy(), g["symbols"])


@pytest.mark.parametrize("key", ["nasa-k7", "k9-r12", "wspr-k32"])
def test_encoder_matches_jax(key):
    code = get_code(key)
    bits = np.random.default_rng(7).integers(0, 2, (64, code.block_length))
    ours = encoder.encode(code, torch.as_tensor(bits)).numpy()
    assert np.array_equal(ours, np.asarray(jenc.encode(jax_code(key), jnp.asarray(bits))))


@pytest.mark.parametrize("terminate", [True, False])
def test_encode_stream_and_tb_match_jax(terminate):
    code = get_code(1)                                   # compat-quirk code
    bits = np.random.default_rng(8).integers(0, 2, (16, 97))
    ours = encoder.encode_stream(code, torch.as_tensor(bits), terminate).numpy()
    assert np.array_equal(
        ours, np.asarray(jenc.encode_stream(jax_code(1), jnp.asarray(bits), terminate)))
    ours_tb = encoder.encode_tb(code, torch.as_tensor(bits.T), terminate).numpy()
    assert np.array_equal(
        ours_tb, np.asarray(jenc.encode_tb(jax_code(1), jnp.asarray(bits.T), terminate)))


def test_encode_rejects_wrong_length():
    with pytest.raises(ValueError):
        encoder.encode(get_code(0), torch.zeros((2, 39), dtype=torch.int32))


def test_bitops_match_numpy():
    x = np.random.default_rng(9).integers(0, 1 << 32, 4096, dtype=np.int64)
    pc = np.array([bin(int(v)).count("1") for v in x])
    assert np.array_equal(popcount32(torch.as_tensor(x)).numpy(), pc)
    assert np.array_equal(parity32(torch.as_tensor(x)).numpy(), pc & 1)


@pytest.mark.parametrize("m", [1, 2, 3])
def test_awgn_sigma_bit_equal_to_jax(m):
    pts = np.concatenate([np.arange(-20.0, 40.0, 0.05), [0.0, 2.0, 4.0, 6.0, 8.0,
                                                        10.0, 12.0, 14.0]])
    pts = pts.astype(np.float32)
    ours = channels.awgn_sigma(torch.as_tensor(pts), m).numpy()
    ref = np.asarray(jch.awgn_sigma(jnp.asarray(pts), m))
    assert ours.dtype == np.float32
    assert np.array_equal(ours, ref)
    for p in (0.0, 4.0, 8.0):                           # python scalars too
        assert float(channels.awgn_sigma(p, m)) == float(jch.awgn_sigma(p, m))


@pytest.mark.parametrize("m", [1, 2, 3, 4])
def test_mapper_matches_jax(m):
    syms = np.random.default_rng(10).integers(0, 1 << m, (8, 50))
    ours = mapper.map_symbols_m(m, torch.as_tensor(syms)).numpy()
    assert np.array_equal(ours, np.asarray(jmap.map_symbols_m(m, jnp.asarray(syms))))


@pytest.mark.parametrize("m", [1, 2, 3, 4])
def test_demappers_match_jax(m):
    rng = np.random.default_rng(11 + m)
    iq = rng.normal(0.0, 0.8, (256, 40, 2)).astype(np.float32)
    # exact ties between points 0 and 1 go to the lower index
    iq[0, 0] = (get_constellation(m)[0] + get_constellation(m)[1]) / 2
    t_iq, j_iq = torch.as_tensor(iq), jnp.asarray(iq)
    soft = demapper.soft_demap(m, t_iq).numpy()
    assert ulps(soft, np.asarray(jdm.soft_demap(m, j_iq))).max() <= 4
    hard = demapper.hard_demap(m, t_iq).numpy()
    assert ulps(hard, np.asarray(jdm.hard_demap(m, j_iq))).max() <= 4
    dec = demapper.hard_decide(m, t_iq).numpy()
    assert np.array_equal(dec, np.asarray(jdm.hard_decide(m, j_iq)))


def test_awgn_moments_and_reproducibility():
    n, sigma = 1 << 18, 0.7
    iq = torch.zeros((n // 2, 2))
    g = torch.Generator().manual_seed(3)
    noise = channels.awgn(g, iq, sigma).flatten().double()
    assert abs(noise.mean().item()) < 5 * sigma / np.sqrt(n)
    assert abs(noise.var().item() - sigma ** 2) < 5 * sigma ** 2 * np.sqrt(2.0 / n)
    again = channels.awgn(torch.Generator().manual_seed(3), iq, sigma).flatten().double()
    assert torch.equal(noise, again)


def test_bsc_moments_and_reproducibility():
    n, p, m = 1 << 16, 0.1, 3
    syms = torch.zeros(n, dtype=torch.int32)
    rx = channels.bsc(torch.Generator().manual_seed(4), syms, p, m)
    assert rx.dtype == torch.int32 and int(rx.max()) < (1 << m)
    flips = popcount32(rx).sum().item()
    nbits = n * m
    assert abs(flips - nbits * p) < 5 * np.sqrt(nbits * p * (1 - p))
    again = channels.bsc(torch.Generator().manual_seed(4), syms, p, m)
    assert torch.equal(rx, again)
