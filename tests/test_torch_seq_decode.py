"""PyTorch port, stack and Fano decoding of supplied symbols (TPU kernels
9-10, ``ops/stack_cuda.py`` and ``ops/fano_cuda.py``): their plain versions
against the JAX package's Pallas kernels in interpret mode, and the modular
chain's stack/Fano step against those kernels on the same frames.

Every comparison is exact: decoded bits, the stack's winning metric, the
Fano diagnostics and the error counters are integers or float32 sums of
the same rounded branch metrics in the same order.  The Fano budgets are
100 SEARCH steps per bit on the goldens and 25 in the chain, so that no
interpret-mode walk runs for minutes.
The CUDA kernels have no CPU mode: the ``cuda`` test holds them against the
plain machines on a card and skips here.
"""

import numpy as np
import pytest
import torch

from conftest import load_golden
from convolutional_codes_tpu.models.codebook import get_code as jax_code
from convolutional_codes_tpu.ops.fano_pallas import fano_decode_pallas
from convolutional_codes_tpu.ops.stack_pallas import stack_decode_pallas
from convolutional_codes_tpu_torch.models.codebook import get_code
from convolutional_codes_tpu_torch.ops import fano, fano_cuda, fano_mc, stack, stack_cuda
from convolutional_codes_tpu_torch.ops.stack_mc import count_errors
from convolutional_codes_tpu_torch.ops import mc_datagen as dg
from convolutional_codes_tpu_torch.ops.channels import awgn, awgn_sigma, bsc
from convolutional_codes_tpu_torch.ops.demapper import hard_demap, soft_demap
from convolutional_codes_tpu_torch.ops.encoder import encode
from convolutional_codes_tpu_torch.ops.mapper import map_symbols
from convolutional_codes_tpu_torch.sim.chain import chain_frames, make_point_step

torch.set_num_threads(2)

INTERP = dict(interpret=True, iters_per_call=65536, iters_first=8192)
TPB = 100
DIAG = ("metric", "timeout_left", "depth", "timed_out")


def _golden(name):
    g = load_golden(f"{name}.npz")
    soft = "dists" in g
    return g, (g["dists"] if soft else g["received"]), soft


@pytest.mark.parametrize("name", ["stack_hard_0_m1", "stack_soft_0_m1"])
def test_stack_plain_matches_pallas_with_metric(name):
    g, x, soft = _golden(name)
    bits, metric, iters = stack.stack_machine(get_code(0), torch.as_tensor(x), soft)
    ref_bits, ref_metric = stack_decode_pallas(jax_code(0), x, soft, with_metric=True,
                                               **INTERP)
    assert np.array_equal(bits.numpy(), np.asarray(ref_bits))
    assert np.array_equal(bits.numpy(), g["decoded"])
    ref_metric = np.asarray(ref_metric)
    assert ref_metric.dtype == (np.float32 if soft else np.int32)
    assert np.array_equal((metric if soft else metric.to(torch.int32)).numpy(), ref_metric)
    assert (iters >= get_code(0).num_block_symbols).all()


@pytest.mark.parametrize("name", ["fano_soft_0_m1", "fano_hard_0_m1"])
def test_fano_plain_matches_pallas_with_diag(name):
    _, x, soft = _golden(name)
    bits, diag = fano.fano_machine(get_code(0), torch.as_tensor(x), soft, TPB)
    ref_bits, ref_diag = fano_decode_pallas(jax_code(0), x, soft, timeout_per_bit=TPB,
                                            with_diag=True, **INTERP)
    assert np.array_equal(bits.numpy(), np.asarray(ref_bits))
    for k in DIAG:
        assert np.array_equal(diag[k].numpy(), np.asarray(ref_diag[k])), k


@pytest.mark.parametrize("decoder,snr", [("stack", 4.0), ("fano", 4.0)])
def test_chain_step_matches_pallas(decoder, snr):
    """The modular chain's step on the CPU (plain machine) against the JAX
    package's interpret-mode kernel on the same frames, regenerated from the
    same seed by the chain's own frame generator."""
    code, frames, sigma = get_code(0), 64, float(awgn_sigma(snr))
    step = make_point_step(code, "awgn", decoder, frames=frames, timeout_per_bit=25,
                           device="cpu")
    be, fe, nb = step(torch.Generator().manual_seed(17), sigma)

    bits, dists = chain_frames(code, "awgn", frames, torch.Generator().manual_seed(17), sigma)
    if decoder == "stack":
        dec = stack_decode_pallas(jax_code(0), dists.numpy(), True, **INTERP)
    else:
        dec = fano_decode_pallas(jax_code(0), dists.numpy(), True, timeout_per_bit=25,
                                 **INTERP)
    errs = np.asarray(dec) != bits.numpy()
    assert (int(be), int(fe), nb) == (int(errs.sum()), int(errs.any(1).sum()),
                                      frames * code.block_length)
    assert int(be) > 0


@pytest.mark.parametrize("channel,demapper", [("awgn", "soft"), ("awgn", "hard"),
                                              ("bsc", "soft")])
def test_chain_frames_draw_as_the_stage_ops(channel, demapper):
    """``chain_frames`` draws the bits and the noise from the generator in the
    order of the reference chain's stages."""
    code, frames = get_code(0), 32
    param = float(awgn_sigma(3.0)) if channel == "awgn" else 0.05
    bits, rx = chain_frames(code, channel, frames, torch.Generator().manual_seed(5), param,
                            demapper)
    gen = torch.Generator().manual_seed(5)
    want_bits = torch.randint(0, 2, (frames, code.block_length), generator=gen,
                              dtype=torch.int32)
    syms = encode(code, want_bits)
    if channel == "awgn":
        demap = soft_demap if demapper == "soft" else hard_demap
        want = demap(code.symlen_out, awgn(gen, map_symbols(code, syms), param))
    else:
        want = bsc(gen, syms, param, code.symlen_out)
    assert torch.equal(bits, want_bits) and torch.equal(rx, want)


def test_cuda_entries_reject_cpu_tensors_and_wrong_shapes():
    code = get_code(0)
    entries = (lambda x, soft: stack_cuda.stack_decode_cuda(code, x, soft),
               lambda x, soft: fano_cuda.fano_decode_cuda(code, x, soft))
    for decode in entries:
        with pytest.raises(ValueError, match="CUDA"):
            decode(torch.zeros((2, 42), dtype=torch.int32), False)
        with pytest.raises(ValueError, match="CUDA"):
            decode(torch.zeros((2, 42, 4)), True)
        for x, soft in ((torch.zeros((2, 42)), True), (torch.zeros((2, 42, 4)), False),
                        (torch.zeros((2, 41)), False), (torch.zeros((0, 42)), False)):
            with pytest.raises(ValueError, match="must be"):
                decode(x, soft)
    # a rate-1/5 code's frames pass the width check (the kernels take 1-8
    # coded bits a symbol, as the JAX decoders do) and reach the device check
    r15 = code.replace(name="r15", symlen_out=5, polynomials=(5, 3, 7, 6, 1))
    for decode in (stack_cuda.stack_decode_cuda, fano_cuda.fano_decode_cuda):
        with pytest.raises(ValueError, match="CUDA"):
            decode(r15, torch.zeros((2, 42), dtype=torch.int32), False)
        with pytest.raises(ValueError, match="CUDA"):
            decode(r15, torch.zeros((2, 42, 32)), True)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the CUDA kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_cuda_kernels_match_plain(cuda_device):
    """On a card: kernels 9-10 equal the plain machines exactly (bits,
    metric, iterations, every Fano diagnostic) on hash frames of soft and
    hard codes, some Fano frames timing out; and kernels 8 and 10 do so at
    the edges of their launch plan: B < 32, more frames than resident
    threads, several frames per lane, and frames too long for shared
    memory (node records in device memory)."""
    for ck, channel, point in ((0, "awgn", 3.0), (0, "bsc", 0.05), (5, "awgn", 3.0),
                               ("wspr-k32", "bsc", 0.02)):
        code = get_code(ck)
        param = float(awgn_sigma(point)) if channel == "awgn" else point
        _, syms = dg.frames_cuda(code, torch.arange(1000, device=cuda_device), 3, param,
                                 channel)
        soft = channel == "awgn"
        got = stack_cuda.stack_machine_cuda(code, syms, soft)
        want = stack.stack_machine(code, syms, soft)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        bits, diag = fano_cuda.fano_decode_cuda(code, syms, soft, 50, with_diag=True)
        bits_r, diag_r = fano.fano_machine(code, syms, soft, 50)
        assert torch.equal(bits, bits_r)
        for k in DIAG + ("iters",):
            assert torch.equal(diag[k].to(diag_r[k].dtype), diag_r[k]), k
    long = get_code(0).replace(name="k3-r12-long", block_length=600)
    for code, channel, point, tpb, lanes, fpl in ((get_code(0), "bsc", 0.05, 20, 16384, 3),
                                                  (long, "awgn", 4.0, 5, 64, 2),
                                                  (long, "bsc", 0.03, 5, 64, 2)):
        param = float(awgn_sigma(point)) if channel == "awgn" else point
        soft = channel == "awgn"
        gids = torch.arange(lanes * fpl, device=cuda_device)
        bits, syms = dg.frames_cuda(code, gids, 9, param, channel)
        bits_r, diag_r = fano.fano_machine(code, syms, soft, tpb)
        for n in (lanes * fpl, 5):
            got, diag = fano_cuda.fano_decode_cuda(code, syms[:n], soft, tpb, with_diag=True)
            assert torch.equal(got, bits_r[:n])
            for k in DIAG + ("iters",):
                assert torch.equal(diag[k].to(diag_r[k].dtype), diag_r[k][:n]), k
        own = torch.zeros((3, lanes), dtype=torch.int64, device=cuda_device)
        count_errors(own, gids // fpl, bits_r, bits, diag_r["iters"])
        assert torch.equal(fano_mc.mc_fano(code, lanes, fpl, 9, param, channel,
                                           timeout_per_bit=tpb, device=cuda_device), own)
