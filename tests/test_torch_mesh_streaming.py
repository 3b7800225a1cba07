"""PyTorch port, long frames across a ``seq`` mesh (``parallel/streaming.py``):
the time-block decode against the JAX package's (XLA backend, 4 virtual
devices) and the port's monolithic decode, the dry run, and the
time-range sharded Monte-Carlo against the one-device run and the JAX
package's interpret-mode run.

Tolerances: exact.  The halo'd blocks run the same float32 ACS in the same
order as the JAX XLA scan, and the sharded Monte-Carlo sums integer
counters of the same hash-addressed windows.
"""

import jax
import numpy as np
import pytest
import torch

from convolutional_codes_tpu.models.codebook import get_code as jax_code
from convolutional_codes_tpu.parallel import streaming as jst
from convolutional_codes_tpu.parallel.mesh import make_mesh as jax_mesh
from convolutional_codes_tpu_torch.models.codebook import get_code
from convolutional_codes_tpu_torch.ops.channels import awgn_sigma
from convolutional_codes_tpu_torch.ops.demapper import soft_demap
from convolutional_codes_tpu_torch.ops.encoder import encode_stream
from convolutional_codes_tpu_torch.ops.fused_longframe import mc_longframe_viterbi
from convolutional_codes_tpu_torch.ops.mapper import map_symbols
from convolutional_codes_tpu_torch.parallel import streaming as st
from convolutional_codes_tpu_torch.parallel.mesh import Mesh, make_mesh

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """One intra-op thread: float32 transcendentals on tensors of more than
    2048 elements (ROADMAP Q3)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _noisy_dists(code, B, T, snr_db, seed):
    """[B, T, M] float32 soft distances of terminated frames of T symbols,
    bits and noise from numpy."""
    rng = np.random.default_rng(seed)
    L = T - (code.constraint_length - 1)
    bits = torch.as_tensor(rng.integers(0, 2, (B, L)), dtype=torch.int32)
    iq = map_symbols(code, encode_stream(code, bits, terminate=True))
    noise = rng.normal(0.0, float(awgn_sigma(snr_db)), tuple(iq.shape))
    return soft_demap(code.symlen_out, iq + torch.as_tensor(noise, dtype=torch.float32))


@pytest.mark.parametrize("snr_db", [2.0, 6.0])
def test_streaming_decode_equals_jax_and_monolithic(snr_db):
    code = get_code("nasa-k7")
    dists = _noisy_dists(code, 2, 1024, snr_db, seed=3)
    ours = st.streaming_viterbi_decode(code, dists, make_mesh({"seq": 4}, devices=[CPU] * 4),
                                       warmup=96)
    ref = jst.streaming_viterbi_decode(jax_code("nasa-k7"), dists.numpy(),
                                       jax_mesh({"seq": 4}, devices=jax.devices()[:4]),
                                       warmup=96, backend="xla")
    assert ours.shape == (2, 1024) and ours.dtype == torch.int32
    assert np.array_equal(ours.numpy(), np.asarray(ref))
    assert torch.equal(ours, st.monolithic_reference_decode(code, dists))


def test_streaming_decode_checks_its_shapes():
    code = get_code("nasa-k7")
    d = torch.zeros((1, 1000, 4))
    mesh = make_mesh({"seq": 4}, devices=[CPU] * 4)
    with pytest.raises(ValueError, match="not divisible"):
        st.streaming_viterbi_decode(code, d[:, :998], mesh)
    with pytest.raises(ValueError, match="warmup"):
        st.streaming_viterbi_decode(code, d, mesh, warmup=251)
    two = Mesh(("seq",), mesh.devices, np.array([0, 0, 1, 1]), 0, 2)
    with pytest.raises(RuntimeError, match="not initialized"):   # a mesh of 2 processes
        st.streaming_viterbi_decode(code, d, two)


def test_dryrun_streaming():
    st.dryrun_streaming(8, [CPU] * 8)


def test_streaming_mc_shards_equal_the_one_device_run():
    """Twin of tests/test_streaming.py::test_fused_streaming_mc_shards_bit_identical."""
    code = get_code("nasa-k7")
    be0, we0 = mc_longframe_viterbi(code, 16, 8, 9, 0.6, window=96, warmup=48, device="cpu")
    for D in (4, 8):
        be, we, nb = st.streaming_mc_accumulate(code, 16, 8, 9, 0.6, window=96, warmup=48,
                                                mesh=make_mesh({"seq": D}, devices=[CPU] * D))
        assert nb == 16 * 8 * 96
        assert torch.equal(be, be0.long()) and torch.equal(we, we0.long()), D
    assert int(be0.sum()) > 0


def test_streaming_mc_bsc_equals_jax():
    be, we, nb = st.streaming_mc_accumulate(get_code("nasa-k7"), 16, 8, 9, 0.03, "bsc",
                                            window=96, warmup=48,
                                            mesh=make_mesh({"seq": 4}, devices=[CPU] * 4))
    rbe, rwe, rnb = jst.streaming_mc_accumulate(
        jax_code("nasa-k7"), 16, 8, 9, 0.03, jax_mesh({"seq": 4}, devices=jax.devices()[:4]),
        channel="bsc", window=96, warmup=48, interpret=True)
    assert nb == rnb
    assert be.tolist() == np.asarray(rbe).tolist() and we.tolist() == np.asarray(rwe).tolist()
    # windows that do not divide, and fewer windows than slots: the first
    # slots take one more, a slot with none launches nothing
    for windows in (6, 3):
        be1, we1 = mc_longframe_viterbi(get_code("nasa-k7"), 16, windows, 9, 0.03, "bsc",
                                        window=96, warmup=48, device="cpu")
        be, we, nb = st.streaming_mc_accumulate(
            get_code("nasa-k7"), 16, windows, 9, 0.03, "bsc", window=96, warmup=48,
            mesh=make_mesh({"seq": 4}, devices=[CPU] * 4))
        assert nb == 16 * windows * 96
        assert torch.equal(be, be1.long()) and torch.equal(we, we1.long()), windows
