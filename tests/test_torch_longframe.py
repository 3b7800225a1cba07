"""PyTorch port, streaming long-frame decode (TPU kernels 4-5): the plain
versions ``stream_acs_ref``/``stream_traceback_ref`` against the JAX
package's interpret-mode Pallas kernels, and ``long_frame_decode_stream``
against the JAX package's streaming and monolithic decoders.

Every comparison is exact: both sides run the same float32 additions in
the same order on the same inputs (distances made once from a numpy seed
and handed to both packages), and ties go the same way (strict-less).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from convolutional_codes_tpu.models.codebook import get_code as jax_code
from convolutional_codes_tpu.models.trellis import build_trellis
from convolutional_codes_tpu.ops import longframe_pallas as jlp
from convolutional_codes_tpu.ops import viterbi as jv
from convolutional_codes_tpu.parallel import streaming as jst
from convolutional_codes_tpu_torch.models.codebook import get_code
from convolutional_codes_tpu_torch.ops import longframe_cuda as lc
from convolutional_codes_tpu_torch.ops.channels import awgn_sigma
from convolutional_codes_tpu_torch.ops.demapper import soft_demap
from convolutional_codes_tpu_torch.ops.encoder import encode_stream
from convolutional_codes_tpu_torch.ops.mapper import map_symbols
from convolutional_codes_tpu_torch.ops.viterbi import (
    BIG_METRIC, HARD_METRIC_SAT, hard_branch_metrics)
from convolutional_codes_tpu_torch.parallel import streaming as st

torch.set_num_threads(2)


def _soft_dists(code, seed, B, T, snr_db):
    """(bits [B, L], distances [B, T, M] float32 numpy) of terminated frames
    of T symbols through AWGN at ``snr_db``."""
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, (B, T - code.constraint_length + 1))
    iq = map_symbols(code, encode_stream(code, torch.as_tensor(bits)))
    noise = rng.standard_normal(tuple(iq.shape)).astype(np.float32)
    rx = iq + awgn_sigma(snr_db) * torch.as_tensor(noise)
    return bits, soft_demap(code.symlen_out, rx).numpy()


def _hard_dists(code, seed, B, T, p=0.05):
    """Hamming distances [B, T, M] float32 of BSC-flipped terminated frames."""
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, (B, T - code.constraint_length + 1))
    syms = encode_stream(code, torch.as_tensor(bits)).numpy()
    flips = (rng.random(syms.shape + (code.symlen_out,)) < p).astype(np.int64)
    rx = syms ^ (flips << np.arange(code.symlen_out)).sum(-1)
    return bits, hard_branch_metrics(code, torch.as_tensor(rx)).to(torch.float32).numpy()


def _init(S, B, hard):
    init = np.full((S, B), float(HARD_METRIC_SAT) if hard else BIG_METRIC, np.float32)
    init[0] = 0.0
    return init


@pytest.mark.parametrize("key,hard", [("nasa-k7", False), (0, True)])
def test_stream_acs_ref_matches_pallas(key, hard):
    code = get_code(key)
    B, T = 4, 64
    _, d = _hard_dists(code, 7, B, T) if hard else _soft_dists(code, 7, B, T, 3.0)
    d_tmb = np.ascontiguousarray(d.transpose(1, 2, 0))
    init = _init(code.num_states, B, hard)
    fm_j, dec_j = jlp.stream_acs_pallas(build_trellis(jax_code(key)), jnp.asarray(d_tmb),
                                        jnp.asarray(init), hard, chunk=16, interpret=True)
    fm, dec = lc.stream_acs_ref(code, torch.as_tensor(d_tmb), torch.as_tensor(init), hard)
    assert np.array_equal(fm.numpy(), np.asarray(fm_j))
    assert dec.dtype == torch.int32 and np.array_equal(dec.numpy(), np.asarray(dec_j))


def test_stream_traceback_ref_matches_pallas_with_carry():
    """Bits and carry exactly, whole and as two segments chained through
    the carry."""
    code = get_code("nasa-k7")
    trellis = build_trellis(jax_code("nasa-k7"))
    B, T = 8, 64
    _, d = _soft_dists(code, 9, B, T, 2.0)
    d_tmb = torch.as_tensor(np.ascontiguousarray(d.transpose(1, 2, 0)))
    fm, dec = lc.stream_acs_ref(code, d_tmb, torch.as_tensor(_init(code.num_states, B, False)),
                                False)
    start = torch.as_tensor(np.random.default_rng(4).integers(0, code.num_states, B),
                            dtype=torch.int32)
    bits_j, cur_j = jlp.stream_traceback_pallas(trellis, jnp.asarray(dec.numpy()),
                                                jnp.asarray(start.numpy()), chunk=16,
                                                interpret=True)
    bits, cur = lc.stream_traceback_ref(code, dec, start)
    assert bits.shape == (T, B) and bits.dtype == torch.int32 and cur.dtype == torch.int32
    assert np.array_equal(bits.numpy(), np.asarray(bits_j))
    assert np.array_equal(cur.numpy(), np.asarray(cur_j))
    hi, mid = lc.stream_traceback_ref(code, dec[T // 2:], start)
    lo, cur0 = lc.stream_traceback_ref(code, dec[:T // 2], mid)
    assert torch.equal(torch.cat([lo, hi]), bits) and torch.equal(cur0, cur)


# code 0's generators share (1+D): its soft case runs at an SNR where error
# smearing cannot start (as tests/test_longframe_pallas.py)
@pytest.mark.parametrize("key,snr", [(0, 6.0), ("nasa-k7", 4.0), ("k9-r12", 5.0)])
def test_long_frame_decode_stream_matches_jax_soft(key, snr):
    code = get_code(key)
    bits, d = _soft_dists(code, 3, 8, 192, snr)
    ours = st.long_frame_decode_stream(code, torch.as_tensor(d))
    assert ours.shape == (8, 192) and ours.dtype == torch.int32
    ref_stream = jst.long_frame_decode_stream(jax_code(key), jnp.asarray(d), chunk=32,
                                              interpret=True)
    ref_mono = jst.monolithic_reference_decode(jax_code(key), jnp.asarray(d))
    assert np.array_equal(ours.numpy(), np.asarray(ref_stream))
    assert np.array_equal(ours.numpy(), np.asarray(ref_mono))
    assert torch.equal(st.monolithic_reference_decode(code, torch.as_tensor(d)), ours)
    assert np.mean(ours.numpy()[:, :bits.shape[1]] != bits) < 0.2


def test_long_frame_decode_stream_matches_jax_hard_bsc():
    code, jcode = get_code(0), jax_code(0)
    _, d = _hard_dists(code, 11, 16, 128)
    ours = st.long_frame_decode_stream(code, torch.as_tensor(d), hard=True)
    ref = jst.long_frame_decode_stream(jcode, jnp.asarray(d), hard=True, chunk=16,
                                       interpret=True)
    assert np.array_equal(ours.numpy(), np.asarray(ref))
    trellis = build_trellis(jcode)
    fm, dec = jv.acs_forward(trellis, jnp.asarray(d), True, jv.initial_metrics(trellis, 16, True))
    mono = jv.traceback_from(trellis, dec, jnp.argmin(fm, axis=-1).astype(jnp.int32))
    assert np.array_equal(ours.numpy(), np.asarray(mono))


def test_frame_length_no_chunk_divides_matches_xla():
    """T = 187: odd, so no power-of-two chunk of the TPU kernels divides
    it; the port takes any T and equals the JAX XLA monolithic decode."""
    code = get_code("nasa-k7")
    bits, d = _soft_dists(code, 21, 6, 187, 4.0)
    ours = st.long_frame_decode_stream(code, torch.as_tensor(d))
    ref = jst.monolithic_reference_decode(jax_code("nasa-k7"), jnp.asarray(d))
    assert np.array_equal(ours.numpy(), np.asarray(ref))
    assert np.mean(ours.numpy()[:, :bits.shape[1]] != bits) < 0.2
