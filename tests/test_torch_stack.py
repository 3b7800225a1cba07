"""PyTorch port, plain stack decoder: bit-exact on every C-reference golden
and against the JAX package's XLA stack decoder on the same numpy inputs.
Every comparison is exact (integer bits and metrics; both sides add the
same rounded float32 branch metrics in the same order)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from conftest import load_golden
from convolutional_codes_tpu.models.codebook import get_code as jax_code
from convolutional_codes_tpu.ops import stack as jstack
from convolutional_codes_tpu_torch.models.codebook import get_code
from convolutional_codes_tpu_torch.ops import mc_datagen as dg
from convolutional_codes_tpu_torch.ops import stack
from convolutional_codes_tpu_torch.ops.channels import awgn_sigma

torch.set_num_threads(2)


@pytest.mark.parametrize("idx", range(6))
@pytest.mark.parametrize("mode", [0, 1])
def test_goldens(idx, mode):
    g = load_golden(f"stack_soft_{idx}_m{mode}.npz")
    out = stack.stack_decode_soft(get_code(idx), torch.as_tensor(g["dists"]))
    assert out.dtype == torch.int32 and np.array_equal(out.numpy(), g["decoded"])
    g = load_golden(f"stack_hard_{idx}_m{mode}.npz")
    out = stack.stack_decode_hard(get_code(idx), torch.as_tensor(g["received"]))
    assert np.array_equal(out.numpy(), g["decoded"])


@pytest.mark.parametrize("ck,channel,point", [
    (0, "awgn", 3.0), (0, "bsc", 0.06), (4, "awgn", 4.0), (4, "bsc", 0.03),
    ("k9-r12", "awgn", 3.0), (5, "awgn", 2.0)], ids=str)
def test_matches_jax_xla(ck, channel, point):
    """Noisy hash frames, decoded by both packages' decoders."""
    code = get_code(ck)
    param = float(awgn_sigma(point)) if channel == "awgn" else point
    _, syms = dg.frames_host(code, np.arange(32), 9, param, channel)
    x = syms.numpy()
    if channel == "awgn":
        ours = stack.stack_decode_soft(code, syms)
        ref = jstack.stack_decode_soft(jax_code(ck), jnp.asarray(x))
    else:
        ours, metric = stack.stack_decode_hard_with_metric(code, syms)
        ref, ref_metric = jstack.stack_decode_hard_with_metric(jax_code(ck), jnp.asarray(x))
        assert np.array_equal(metric.numpy(), np.asarray(ref_metric))
    assert np.array_equal(ours.numpy(), np.asarray(ref))


def test_noiseless_roundtrip_and_metric():
    code = get_code("k9-r12")
    bits = np.random.default_rng(5).integers(0, 2, (8, code.block_length))
    from convolutional_codes_tpu_torch.ops.encoder import encode
    syms = encode(code, torch.as_tensor(bits))
    out, metric = stack.stack_decode_hard_with_metric(code, syms)
    assert np.array_equal(out.numpy(), bits)
    assert (metric == code.num_block_symbols * code.symlen_out * code.bit_metrics[0]).all()
