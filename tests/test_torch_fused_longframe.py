"""PyTorch port, fused long-frame Monte-Carlo chain (TPU kernel 6): the
stream generator and the plain chain ``mc_longframe_viterbi(device="cpu")``
against the JAX package's ``stream_segment_host`` and interpret-mode
kernel, on the cases of tests/test_fused_longframe.py.

Tolerances: info bits, BSC metrics and every BSC counter exactly (integer
hash math and exactly converted uniforms); AWGN distances within 16
float32 ulp of max(|d|, 1), and at most 1 of 128 AWGN lanes with other
counters — log/sqrt/sin/cos differ in the last ulp between torch's and
XLA's CPU kernels (the tolerance of tests/test_torch_datagen.py).
"""

import numpy as np
import pytest
import torch

from convolutional_codes_tpu.models.codebook import get_code as jax_code
from convolutional_codes_tpu.ops import fused_longframe as jfl
from convolutional_codes_tpu_torch.models.codebook import get_code
from convolutional_codes_tpu_torch.ops import fused_longframe as fl
from convolutional_codes_tpu_torch.ops import longframe_cuda as lc
from convolutional_codes_tpu_torch.ops.channels import awgn_sigma
from convolutional_codes_tpu_torch.utils.bitops import first_argmin

torch.set_num_threads(2)

CASES = [  # tests/test_fused_longframe.py:41-51
    ("k3-75", "bsc", 0.0125, "soft"),
    ("k3-75", "awgn", float(awgn_sigma(4.0)), "soft"),
    ("k3-75", "awgn", float(awgn_sigma(4.0)), "hard"),
    ("nasa-k7", "awgn", float(awgn_sigma(3.0)), "soft"),
    ("k9-r12", "awgn", float(awgn_sigma(1.5)), "soft"),
]
W, WN, NSTEPS, LANES = 128, 256, 3, 128


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """Run each test on one intra-op thread.  torch's float32
    transcendentals on the CPU (MKL vector math) split tensors of more than
    2048 elements between threads; in about one process in ten the second
    thread's share came out up to 2e-5 off (300 ulp of the distances)
    while the first share stayed within 4 ulp of XLA.  A module-level
    ``set_num_threads`` does not hold: the last test module collected in a
    process sets the count."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _max_ulps(a, b):
    scale = np.maximum(np.abs(b), 1.0).astype(np.float32)
    return float((np.abs(a.astype(np.float64) - b) / np.spacing(scale)).max())


@pytest.mark.parametrize("ck,channel,param,dem", CASES, ids=str)
def test_stream_segment_host_matches_jax(ck, channel, param, dem):
    lanes = np.array([0, 1, 5, 127, 1000, 2 ** 20 + 3, 2 ** 31 - 1], np.int64)
    jb, jd = jfl.stream_segment_host(jax_code(ck), lanes, 7, param, channel, -W, 300, dem)
    tb, td = fl.stream_segment_host(get_code(ck), lanes, 7, param, channel, -W, 300, dem)
    assert tb.dtype == torch.int32 and np.array_equal(tb.numpy(), np.asarray(jb))
    assert td.shape == jd.shape and td.dtype == torch.float32
    if channel == "bsc":
        assert np.array_equal(td.numpy(), np.asarray(jd))
    else:
        assert _max_ulps(td.numpy(), np.asarray(jd)) <= 16


@pytest.mark.parametrize("ck,channel,param,dem", CASES, ids=str)
def test_plain_chain_matches_jax_interpret(ck, channel, param, dem):
    launches = fl.mc_longframe_viterbi.launches
    be, we = fl.mc_longframe_viterbi(get_code(ck), LANES, NSTEPS, 7, param, channel, dem,
                                     window=WN, warmup=W, device="cpu")
    assert fl.mc_longframe_viterbi.launches == launches     # CPU: plain version
    jbe, jwe = jfl.mc_longframe_viterbi(jax_code(ck), LANES, NSTEPS, 7, param,
                                        channel=channel, demapper=dem, window=WN,
                                        warmup=W, block_lanes=128, interpret=True)
    assert be.dtype == torch.int32 and be.shape == (LANES,)
    differ = int(((be.numpy() != np.asarray(jbe)) | (we.numpy() != np.asarray(jwe))).sum())
    print(f"{ck} {channel}/{dem}: {differ}/{LANES} lanes differ, bit errors "
          f"{int(be.sum())} vs {int(np.asarray(jbe).sum())}")
    assert differ == 0 if channel == "bsc" else differ <= 1
    if ck != "nasa-k7":   # the case exercises errors (deep-SNR K=7 aside)
        assert int(be.sum()) > 0


def test_plain_chain_equals_a_monolithic_decode_of_the_stream():
    """Windows with halos decode the stream as one whole-stream decode from
    zero metrics does (tests/test_fused_longframe.py's monolithic_counts)."""
    code = get_code("k3-75")
    be, _ = fl.mc_longframe_viterbi(code, 64, NSTEPS, 5, 0.03, "bsc", window=WN,
                                    warmup=W, device="cpu")
    bits, d = fl.stream_segment_host(code, np.arange(64), 5, 0.03, "bsc", -W,
                                     2 * W + NSTEPS * WN)
    fm, dec = lc.stream_acs_ref(code, d.permute(1, 2, 0).contiguous(),
                                torch.zeros((code.num_states, 64)), True)
    out, _ = lc.stream_traceback_ref(code, dec, first_argmin(fm, dim=0).to(torch.int32))
    pay = slice(W, W + NSTEPS * WN)
    assert torch.equal(be, (out.T[:, pay] != bits[:, pay]).sum(1, dtype=torch.int32))
    assert int(be.sum()) > 0


@pytest.mark.parametrize("channel,param", [("bsc", 0.03), ("awgn", float(awgn_sigma(2.0)))])
def test_win0_split_sums_to_the_whole_run(channel, param):
    code = get_code("k3-75")
    kw = dict(channel=channel, window=128, warmup=64, device="cpu")
    whole = fl.mc_longframe_viterbi(code, 64, 3, 9, param, **kw)
    head = fl.mc_longframe_viterbi(code, 64, 2, 9, param, win0=0, **kw)
    tail = fl.mc_longframe_viterbi(code, 64, 1, 9, param, win0=2, **kw)
    assert all(torch.equal(w, h + t) for w, h, t in zip(whole, head, tail))
    assert int(whole[0].sum()) > 0 and int(tail[1].sum()) > 0


def test_deterministic_and_seed_sensitive():
    code = get_code("k3-75")
    kw = dict(channel="bsc", window=256, warmup=128, device="cpu")
    a, _ = fl.mc_longframe_viterbi(code, 64, 2, 11, 0.02, **kw)
    b, _ = fl.mc_longframe_viterbi(code, 64, 2, 11, 0.02, **kw)
    c, _ = fl.mc_longframe_viterbi(code, 64, 2, 12, 0.02, **kw)
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_refusals():
    with pytest.raises(ValueError, match="0xFF00"):   # 2 * Tw >= 0xFF00
        fl.mc_longframe_viterbi(get_code("k3-75"), 8, 1, 0, 0.01, "bsc", window=32000,
                                warmup=320, device="cpu")
    with pytest.raises(NotImplementedError):           # S > 256
        fl.mc_longframe_viterbi(get_code("k15-r12"), 8, 1, 0, 0.5, device="cpu")
    with pytest.raises(ValueError):
        fl.mc_longframe_viterbi(get_code("k3-75"), 8, 1, 0, 0.5, "rayleigh", device="cpu")
    with pytest.raises(ValueError):
        fl.mc_longframe_viterbi(get_code("k3-75"), 8, 1, 0, 0.5, device="meta")
    # the BSC limit is the TPU kernel's, and the AWGN chain has none
    fl._check_args(get_code("k3-75"), "awgn", "soft", 32000, 320)
