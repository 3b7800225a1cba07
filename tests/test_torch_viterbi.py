"""PyTorch port, Viterbi: the plain decoders against the C-reference
goldens, the plain ACS/traceback against the JAX XLA path, and the kernel
wrappers' CPU routing.  Every comparison is exact (integer or bit-equal
float32): both sides run the same float32 additions in the same order.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from conftest import load_golden
from convolutional_codes_tpu.models.codebook import get_code
from convolutional_codes_tpu.models.trellis import build_trellis
from convolutional_codes_tpu.ops import viterbi as jv
from convolutional_codes_tpu_torch.ops import viterbi as tv
from convolutional_codes_tpu_torch.ops import viterbi_cuda as vc

torch.set_num_threads(2)

VITERBI_CODES = [0, 1, 2, 3, 5]


@pytest.mark.parametrize("idx", VITERBI_CODES)
@pytest.mark.parametrize("mode", [0, 1])
def test_soft_matches_golden(idx, mode):
    g = load_golden(f"viterbi_soft_{idx}_m{mode}.npz")
    out = tv.viterbi_decode_soft(get_code(idx), torch.as_tensor(g["dists"]))
    assert out.dtype == torch.int32
    assert np.array_equal(out.numpy(), g["decoded"])


@pytest.mark.parametrize("idx", VITERBI_CODES)
@pytest.mark.parametrize("mode", [0, 1])
def test_hard_matches_golden(idx, mode):
    g = load_golden(f"viterbi_hard_{idx}_m{mode}.npz")
    bits, metric = tv.viterbi_decode_hard(get_code(idx), torch.as_tensor(g["received"]))
    assert np.array_equal(bits.numpy(), g["decoded"])
    assert metric.dtype == torch.int32
    assert np.array_equal(metric.numpy(), g["metrics"])


def _inputs(code, hard, B=96, seed=0):
    rng = np.random.default_rng(seed)
    T, M = code.num_block_symbols, code.points_per_symbol
    if hard:   # Hamming metrics of random received symbols: ties everywhere
        rx = rng.integers(0, M, (B, T))
        return np.array(jv.hard_branch_metrics(code, jnp.asarray(rx)))
    return rng.uniform(0.0, 8.0, (B, T, M)).astype(np.float32)


@pytest.mark.parametrize("key", ["k3-r12", "nasa-k7", "k9-r12"])
@pytest.mark.parametrize("hard", [False, True])
def test_acs_traceback_decode_match_jax_xla(key, hard):
    code = get_code(key)
    bm = _inputs(code, hard)
    B = bm.shape[0]
    init_j = jv.initial_metrics(build_trellis(code), B, hard)
    fm_j, dec_j = jv.acs_forward(build_trellis(code), jnp.asarray(bm), hard, init_j)
    fm_t, dec_t = tv.acs_forward(code, torch.as_tensor(bm), hard,
                                 tv.initial_metrics(code, B, hard))
    assert np.array_equal(fm_t.numpy(), np.asarray(fm_j))
    assert dec_t.shape == (code.num_block_symbols, (code.num_states + 31) // 32, B)
    assert np.array_equal(dec_t.numpy(), np.asarray(dec_j))
    bits_j, metric_j = jv._decode(build_trellis(code), jnp.asarray(bm), hard, backend="xla")
    bits_t, metric_t = tv._decode(code, torch.as_tensor(bm), hard)
    assert np.array_equal(bits_t.numpy(), np.asarray(bits_j))
    assert np.array_equal(metric_t.numpy(), np.asarray(metric_j))


def test_traceback_from_any_start_state_matches_jax():
    """Traceback from arbitrary (not argmin) start states, S=64, nwords=2."""
    code = get_code("nasa-k7")
    bm = _inputs(code, False, seed=3)
    B = bm.shape[0]
    _, dec = jv.acs_forward(build_trellis(code), jnp.asarray(bm), False,
                            jv.initial_metrics(build_trellis(code), B, False))
    start = np.random.default_rng(4).integers(0, code.num_states, B)
    ref = jv.traceback_from(build_trellis(code), dec, jnp.asarray(start))
    ours = tv.traceback_from(code, torch.as_tensor(np.array(dec)), torch.as_tensor(start))
    assert np.array_equal(ours.numpy(), np.asarray(ref))


def test_hard_branch_metrics_are_hamming():
    rx = torch.tensor([[0, 1, 2, 3]])
    bm = tv.hard_branch_metrics(get_code(0), rx).numpy()
    assert np.array_equal(bm[0], [[bin(r ^ e).count("1") for e in range(4)]
                                  for r in range(4)])


@pytest.mark.parametrize("key", [0, "k9-r12"])
def test_kernel_wrappers_take_plain_path_on_cpu(key):
    """CPU tensors run the plain versions — no launch is counted — and give
    the kernel-layout results of the plain ACS and first-argmin traceback."""
    code = get_code(key)
    launches = (vc.acs_forward_cuda.launches, vc.traceback_cuda.launches)
    bm = torch.as_tensor(_inputs(code, True, seed=5))
    B, S = bm.shape[0], code.num_states
    d_tmb = bm.to(torch.float32).permute(1, 2, 0).contiguous()
    init = torch.full((S, B), float(tv.HARD_METRIC_SAT))
    init[0] = 0.0
    fm, dec = vc.acs_forward_cuda(code, d_tmb, init, True)
    bits, best = vc.traceback_cuda(code, dec, fm)
    assert (vc.acs_forward_cuda.launches, vc.traceback_cuda.launches) == launches
    assert fm.dtype == torch.float32 and bits.shape == (code.num_block_symbols, B)
    ref_bits, ref_metric = tv._decode(code, bm, True)
    assert torch.equal(bits.T, ref_bits)
    assert torch.equal(best.to(torch.int32), ref_metric)


def test_decoders_on_cpu_launch_no_kernel():
    launches = (vc.acs_forward_cuda.launches, vc.traceback_cuda.launches)
    g = load_golden("viterbi_soft_0_m0.npz")
    tv.viterbi_decode_soft(get_code(0), torch.as_tensor(g["dists"]))
    assert (vc.acs_forward_cuda.launches, vc.traceback_cuda.launches) == launches


def test_kernel_wrappers_reject_other_devices():
    code = get_code(0)
    T, S = code.num_block_symbols, code.num_states
    with pytest.raises(ValueError):
        vc.acs_forward_cuda(code, torch.empty((T, 4, 8), device="meta"),
                            torch.empty((S, 8), device="meta"), False)
    with pytest.raises(ValueError):
        vc.traceback_cuda(code, torch.empty((T, 1, 8), dtype=torch.int32, device="meta"),
                          torch.empty((S, 8), device="meta"))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the CUDA kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_cuda_kernels_match_plain(cuda_device):
    """On a card: kernels 1-2 equal their plain versions bit for bit."""
    code = get_code("nasa-k7")
    for hard in (False, True):
        bm = torch.as_tensor(_inputs(code, hard, B=512, seed=6), device=cuda_device)
        d_tmb = bm.to(torch.float32).permute(1, 2, 0).contiguous()
        init = torch.full((code.num_states, 512),
                          float(tv.HARD_METRIC_SAT) if hard else tv.BIG_METRIC,
                          device=cuda_device)
        init[0] = 0.0
        fm, dec = vc.acs_forward_cuda(code, d_tmb, init, hard)
        fm_r, dec_r = vc.acs_forward_ref(code, d_tmb, init, hard)
        assert torch.equal(fm, fm_r) and torch.equal(dec, dec_r)
        assert all(torch.equal(a, b) for a, b in zip(vc.traceback_cuda(code, dec, fm),
                                                     vc.traceback_ref(code, dec, fm)))
