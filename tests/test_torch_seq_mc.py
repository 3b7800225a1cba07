"""PyTorch port, sequential Monte-Carlo (TPU kernels 7-8): the plain
versions ``mc_stack_ref``/``mc_fano_ref`` against the JAX package.

The cases are those of tests/test_stack_mc.py and tests/test_fano_mc.py
(64 lanes), plus 16-QAM Fano at 16 lanes.  Per-lane counters must equal
the JAX XLA decoders run on frames made by the port's ``frames_host``
(exact: this keeps datagen ulps out of the decode comparison); on BSC they
must also equal the JAX decoders on the JAX package's own ``frames_host``
(exact).  The JAX package's tests hold its interpret-mode kernels equal to
those XLA decoders on its ``frames_host``, so the BSC checks tie the port
to the TPU kernels.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from convolutional_codes_tpu.models.codebook import get_code as jax_code
from convolutional_codes_tpu.ops import fano as jfano
from convolutional_codes_tpu.ops import mc_datagen as jdg
from convolutional_codes_tpu.ops import stack as jstack
from convolutional_codes_tpu_torch.models.codebook import get_code
from convolutional_codes_tpu_torch.ops import fano_cuda, fano_mc, mc_datagen, stack_cuda, stack_mc
from convolutional_codes_tpu_torch.ops.channels import awgn_sigma

torch.set_num_threads(2)

S6, S5, S4, S3, S2 = (float(awgn_sigma(x)) for x in (6.0, 5.0, 4.0, 3.0, 2.0))
STACK_CASES = [  # (code, channel, param, demapper, frames_per_lane)
    (0, "awgn", S6, "soft", 2), (0, "bsc", 0.05, "soft", 2), (5, "awgn", S4, "soft", 2),
    (4, "awgn", S4, "soft", 1), (0, "awgn", S5, "hard", 2)]
FANO_CASES = [  # (code, channel, param, demapper, timeout_per_bit, frames_per_lane)
    (0, "awgn", S2, "soft", 40, 2), (0, "bsc", 0.05, "soft", 60, 2),
    (5, "awgn", S3, "soft", 50, 2), (4, "awgn", S5, "soft", 25, 1),
    (4, "bsc", 0.02, "soft", 30, 1), (0, "awgn", S4, "hard", 40, 2)]


def _jax_counts(decode, bits, syms, lanes, fpl):
    """Per-lane (bit errors, frame errors) of a JAX decoder on numpy frames."""
    dec = np.asarray(decode(jnp.asarray(syms)))
    err = (dec != bits[:, :dec.shape[1]]).sum(axis=1).reshape(lanes, fpl)
    return np.stack([err.sum(axis=1), (err > 0).sum(axis=1)])


def _check(ref_out, decode, ck, channel, param, demapper, lanes, fpl):
    assert ref_out.shape == (3, lanes) and ref_out.dtype == torch.int64
    ours = ref_out[:2].numpy()
    bits, syms = mc_datagen.frames_host(get_code(ck), np.arange(lanes * fpl), 42, param,
                                        channel, demapper)
    assert np.array_equal(ours, _jax_counts(decode, bits.numpy(), syms.numpy(), lanes, fpl))
    if channel == "bsc":
        jb, js = jdg.frames_host(jax_code(ck), np.arange(lanes * fpl), 42, param, channel,
                                 demapper)
        assert np.array_equal(ours, _jax_counts(decode, jb, js, lanes, fpl))
    assert ours[0].sum() > 0 and (ref_out[2] > 0).all()


@pytest.mark.parametrize("ck,channel,param,dem,fpl", STACK_CASES, ids=str)
def test_stack_ref_counts_match_jax(ck, channel, param, dem, fpl):
    out = stack_mc.mc_stack_ref(get_code(ck), 64, fpl, 42, param, channel, dem)
    jc = jax_code(ck)
    decode = ((lambda x: jstack.stack_decode_soft(jc, x)) if channel == "awgn"
              else (lambda x: jstack.stack_decode_hard(jc, x)))
    _check(out, decode, ck, channel, param, dem, 64, fpl)


@pytest.mark.parametrize("ck,channel,param,dem,tpb,fpl", FANO_CASES, ids=str)
def test_fano_ref_counts_match_jax(ck, channel, param, dem, tpb, fpl):
    out = fano_mc.mc_fano_ref(get_code(ck), 64, fpl, 42, param, channel, dem, tpb)
    jc = jax_code(ck)
    decode = ((lambda x: jfano.fano_decode_soft(jc, x, tpb)) if channel == "awgn"
              else (lambda x: jfano.fano_decode_hard(jc, x, tpb)))
    _check(out, decode, ck, channel, param, dem, 64, fpl)


def test_fano_ref_16qam_counts_match_jax():
    ck = "k15-r14-16qam"
    out = fano_mc.mc_fano_ref(get_code(ck), 16, 1, 42, S5, "awgn", "soft", 50)
    _check(out, lambda x: jfano.fano_decode_soft(jax_code(ck), x, 50), ck, "awgn", S5,
           "soft", 16, 1)


def test_wrappers_run_the_plain_version_on_cpu():
    code = get_code(0)
    launches = (stack_mc.mc_stack.launches, fano_mc.mc_fano.launches)
    a = stack_mc.mc_stack(code, 32, 2, 7, 0.04, "bsc", device="cpu")
    b = fano_mc.mc_fano(code, 32, 2, 7, 0.04, "bsc", timeout_per_bit=50, device="cpu")
    assert (stack_mc.mc_stack.launches, fano_mc.mc_fano.launches) == launches
    assert torch.equal(a, stack_mc.mc_stack_ref(code, 32, 2, 7, 0.04, "bsc"))
    assert torch.equal(b, fano_mc.mc_fano_ref(code, 32, 2, 7, 0.04, "bsc", "soft", 50))
    # the two decoders agree on most frames of the same hash stream
    assert abs(int(a[0].sum()) - int(b[0].sum())) < int(a[0].sum()) // 2 + 20
    assert not torch.equal(a, stack_mc.mc_stack(code, 32, 2, 8, 0.04, "bsc", device="cpu"))


def test_wrappers_reject_other_devices_and_shapes():
    code = get_code(0)
    with pytest.raises(ValueError):
        stack_mc.mc_stack(code, 32, 1, 0, 0.05, "bsc", device="meta")
    with pytest.raises(ValueError):
        fano_mc.mc_fano(code, 32, 1, 0, 0.05, "bsc", device="meta")
    with pytest.raises(ValueError):
        fano_mc.mc_fano_ref(code, 32, 1, 0, 0.05, "bsc", timeout_per_bit=-1)
    # a rate-1/5 code without a registered 5-bit constellation: ValueError,
    # BSC included, as the JAX package's datagen raises (it builds its stage
    # helpers from the constellation on every channel); with one registered
    # it decodes (tests/test_torch_wide_codes.py)
    r15 = code.replace(name="r15", symlen_out=5, polynomials=(5, 3, 7, 6, 1))
    for mc in (stack_mc.mc_stack_ref, fano_mc.mc_fano_ref):
        with pytest.raises(ValueError, match="no constellation for 5 bits"):
            mc(r15, 8, 1, 0, 0.05, "bsc")
    with pytest.raises(ValueError, match="no constellation for 5 bits"):
        jdg.make_datagen(jax_code(0).replace(name="r15", symlen_out=5,
                                             polynomials=(5, 3, 7, 6, 1)), 42, 40, "bsc", "soft")


def test_supplied_frames_entries_check_their_input():
    code = get_code(0)
    with pytest.raises(ValueError, match="CUDA"):
        stack_cuda.stack_decode_cuda(code, torch.zeros((2, 42), dtype=torch.int32), False)
    with pytest.raises(ValueError, match="CUDA"):
        fano_cuda.fano_decode_cuda(code, torch.zeros((2, 42, 4)), True)
