"""PyTorch port, coordinate-hash Monte-Carlo datagen: ``coord_bits`` and
``frames_host`` against the JAX package's on the same (seed, frame ids).

Tolerances: the hash, the info bits and every BSC symbol exactly (integer
math and an exactly converted uniform); AWGN demapper distances within 16
float32 ulp of max(|d|, 1) — log/sqrt/sin/cos differ in the last ulp
between torch and XLA on the CPU, XLA-CPU may contract the demapper's
``di*di + dq*dq`` into an FMA, and the squared distance scaled by 1/ndist
(2.5 for 16-QAM) amplifies a last-ulp difference of the received point
(measured up to 12 ulp over 4096 frames at 2 dB).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from convolutional_codes_tpu.models.codebook import get_code as jax_code
from convolutional_codes_tpu.ops import fused_longframe as jfl
from convolutional_codes_tpu.ops import mc_datagen as jdg
from convolutional_codes_tpu_torch.models.codebook import get_code
from convolutional_codes_tpu_torch.ops import fused_longframe as fl
from convolutional_codes_tpu_torch.ops import mc_datagen as dg
from convolutional_codes_tpu_torch.ops.channels import awgn_sigma

torch.set_num_threads(2)

GIDS = np.array([0, 1, 2, 7, 63, 100, 12345, 2 ** 20 + 17, 2 ** 31 - 5], np.int64)
CODES = [0, 5, "wspr-k32", "k9-r12", "k15-r14-16qam"]
CHANNELS = [("awgn", "soft", 2.0), ("awgn", "hard", 4.0), ("bsc", "soft", 0.05)]


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


@pytest.mark.parametrize("salt", [0, 1, 2, 5])
def test_coord_bits_and_uniform_match_jax(salt):
    rng = np.random.default_rng(100 + salt)
    lane = rng.integers(0, 2 ** 31, 4096)
    pos = rng.integers(0, 2 ** 31, 4096)
    for seed in rng.integers(0, 2 ** 31, 3):
        ref = np.asarray(jfl.coord_bits(jnp.asarray(lane, jnp.int32), jnp.asarray(pos, jnp.int32),
                                        jnp.uint32(seed), salt))
        ours = fl.coord_bits(torch.as_tensor(lane), torch.as_tensor(pos), int(seed), salt)
        assert np.array_equal(ours.numpy(), ref.astype(np.int64))
        ref_u = np.asarray(jfl.coord_uniform(jnp.asarray(lane, jnp.int32),
                                             jnp.asarray(pos, jnp.int32), jnp.uint32(seed), salt))
        ours_u = fl.coord_uniform(torch.as_tensor(lane), torch.as_tensor(pos), int(seed), salt)
        assert ours_u.dtype == torch.float32 and np.array_equal(ours_u.numpy(), ref_u)


def _max_ulps(a, b):
    scale = np.maximum(np.abs(b), 1.0).astype(np.float32)
    return float((np.abs(a.astype(np.float64) - b) / np.spacing(scale)).max())


@pytest.mark.parametrize("ck", CODES, ids=str)
@pytest.mark.parametrize("channel,demapper,point", CHANNELS)
def test_frames_host_match_jax(ck, channel, demapper, point):
    param = float(awgn_sigma(point)) if channel == "awgn" else point
    gids = np.concatenate([GIDS, np.arange(256)])
    jb, js = jdg.frames_host(jax_code(ck), gids, 42, param, channel, demapper)
    tb, ts = dg.frames_host(get_code(ck), gids, 42, param, channel, demapper)
    code = get_code(ck)
    assert tb.shape == (len(gids), code.num_block_symbols) and tb.dtype == torch.int32
    assert np.array_equal(tb.numpy(), jb)
    assert 0 < tb.numpy()[:, :code.block_length].mean() < 1
    if channel == "bsc":
        assert ts.dtype == torch.int32 and np.array_equal(ts.numpy(), js)
    else:
        assert ts.shape == js.shape and ts.dtype == torch.float32
        assert _max_ulps(ts.numpy(), js) <= 16


def test_seed_is_masked_to_31_bits():
    code = get_code(0)
    a = dg.frames_host(code, np.arange(8), 5, 0.1, "bsc")
    b = dg.frames_host(code, np.arange(8), 5 + 2 ** 31, 0.1, "bsc")
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_rejects_what_the_paths_do_not_take():
    with pytest.raises(ValueError):
        dg.frames_host(get_code(0), np.arange(4), 1, 0.1, "rayleigh")
    with pytest.raises(ValueError):
        dg.frames_host(get_code(0), np.arange(4), 1, 0.1, "awgn", "fuzzy")
    with pytest.raises(ValueError):
        dg.frames_cuda(get_code(0), torch.arange(4), 1, 0.1, "bsc")
