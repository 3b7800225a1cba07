"""PyTorch port, long-frame entry points (``parallel/streaming.py``): the
one-device Monte-Carlo accumulation, the refusals, the kernel wrappers'
routing, the mesh (more in test_torch_mesh_streaming.py), and one
``cuda``-marked test that holds kernels 4-6 against their plain versions
on a card (it skips where there is none).
"""

import numpy as np
import pytest
import torch

from convolutional_codes_tpu_torch.models.codebook import get_code
from convolutional_codes_tpu_torch.ops import fused_longframe as fl
from convolutional_codes_tpu_torch.ops import longframe_cuda as lc
from convolutional_codes_tpu_torch.ops.channels import awgn_sigma
from convolutional_codes_tpu_torch.ops.viterbi import BIG_METRIC
from convolutional_codes_tpu_torch.parallel import streaming as st
from convolutional_codes_tpu_torch.parallel.mesh import make_mesh
from convolutional_codes_tpu_torch.utils.bitops import first_argmin

torch.set_num_threads(2)


def test_streaming_mc_accumulate_is_one_kernel_call():
    code = get_code("k3-75")
    seed = 2 ** 31 + 77                  # taken & 0x7FFFFFFF, as the JAX package does
    be, we, bits = st.streaming_mc_accumulate(code, 64, 2, seed, 0.03, "bsc", window=128,
                                              warmup=64, device="cpu")
    rbe, rwe = fl.mc_longframe_viterbi(code, 64, 2, 77, 0.03, "bsc", window=128, warmup=64,
                                       device="cpu")
    assert bits == 64 * 2 * 128
    assert torch.equal(be, rbe) and torch.equal(we, rwe) and int(be.sum()) > 0


def test_mesh_is_not_ported():
    """The mesh runs (``parallel/mesh.py``): two CPU slots, each on its own
    window range, give the one-device run's per-lane counters."""
    code = get_code("k3-75")
    mesh = make_mesh({"seq": 2}, devices=[torch.device("cpu")] * 2)
    be, we, bits = st.streaming_mc_accumulate(code, 8, 2, 0, 0.03, "bsc", window=128,
                                              warmup=64, mesh=mesh)
    rbe, rwe, rbits = st.streaming_mc_accumulate(code, 8, 2, 0, 0.03, "bsc", window=128,
                                                 warmup=64, device="cpu")
    assert bits == rbits == 8 * 2 * 128
    assert torch.equal(be, rbe.long()) and torch.equal(we, rwe.long()) and int(be.sum()) > 0


def test_default_device_raises_without_a_card():
    """The Monte-Carlo entry points default to the card; on a machine
    without one they raise instead of running the plain version."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device launches the kernel")
    code = get_code("k3-75")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fl.mc_longframe_viterbi(code, 8, 1, 0, 0.03, "bsc")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        st.streaming_mc_accumulate(code, 8, 1, 0, 0.03, "bsc")


def test_stream_wrappers_route_cpu_to_the_plain_version():
    code = get_code("nasa-k7")
    rng = np.random.default_rng(1)
    d = torch.as_tensor(rng.uniform(0, 8, (3, 100, 4)).astype(np.float32))
    launches = (lc.stream_acs_cuda.launches, lc.stream_traceback_cuda.launches)
    out = st.long_frame_decode_stream(code, d)
    assert (lc.stream_acs_cuda.launches, lc.stream_traceback_cuda.launches) == launches
    assert torch.equal(out, st.monolithic_reference_decode(code, d))
    with pytest.raises(ValueError):
        lc.stream_acs_cuda(code, torch.empty((5, 4, 2), device="meta"),
                           torch.empty((64, 2), device="meta"), False)
    with pytest.raises(ValueError):
        lc.stream_traceback_cuda(code, torch.empty((5, 2, 2), dtype=torch.int32, device="meta"),
                                 torch.empty((2,), dtype=torch.int32, device="meta"))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the CUDA kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_cuda_kernels_match_plain(cuda_device):
    """On a card: kernels 4-5 equal their plain versions bit for bit, and
    kernel 6 equals its plain version on BSC (AWGN: at most 1% of lanes)."""
    for key in ("k3-75", "nasa-k7", "k9-r12"):
        code = get_code(key)
        S, B, T = code.num_states, 64, 1001
        d = torch.rand((T, code.points_per_symbol, B), device=cuda_device) * 8.0
        init = torch.full((S, B), BIG_METRIC, device=cuda_device)
        init[0] = 0.0
        fm, dec = lc.stream_acs_cuda(code, d, init, False)
        fm_r, dec_r = lc.stream_acs_ref(code, d, init, False)
        assert torch.equal(fm, fm_r) and torch.equal(dec, dec_r)
        start = first_argmin(fm, dim=0).to(torch.int32)
        assert all(torch.equal(a, b) for a, b in zip(lc.stream_traceback_cuda(code, dec, start),
                                                     lc.stream_traceback_ref(code, dec, start)))
    for key, channel, param in (("k3-75", "bsc", 0.0125),
                                ("nasa-k7", "awgn", float(awgn_sigma(3.0)))):
        kw = dict(channel=channel, window=256, warmup=128)
        be, we = fl.mc_longframe_viterbi(get_code(key), 256, 2, 7, param, device=cuda_device, **kw)
        rbe, rwe = fl.mc_longframe_viterbi_ref(get_code(key), 256, 2, 7, param,
                                               device=cuda_device, **kw)
        differ = int(((be != rbe) | (we != rwe)).sum())
        assert differ == 0 if channel == "bsc" else differ <= 2
