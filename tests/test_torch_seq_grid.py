"""PyTorch port, the sequential Monte-Carlo kernels across a mesh
(``parallel/seq_grid.py``) and their lane offset: twins of
tests/test_seq_grid.py on meshes of repeated CPU slots (the kernels'
plain versions), and the port's grid against the JAX package's
``seq_mc_grid`` (interpret mode, 4 virtual devices) for the stack decoder,
and for Fano against the JAX package's XLA decoder on its own frames (its
interpret-mode Fano grid takes 45 s to build here).

Tolerances: exact everywhere.  A sharded run decodes lane0-offset blocks
of one frame-id space, so its counters ARE the serial run's; on BSC the
frames are integer-exact, so they equal the JAX package's too.
"""

import jax
import numpy as np
import pytest
import torch

from convolutional_codes_tpu.models.codebook import get_code as jax_code
from convolutional_codes_tpu.ops import fano as jfano
from convolutional_codes_tpu.ops import mc_datagen as jmcdg
from convolutional_codes_tpu.parallel import seq_grid as jsg
from convolutional_codes_tpu.parallel.mesh import make_mesh as jax_mesh
from convolutional_codes_tpu_torch.models.codebook import get_code
from convolutional_codes_tpu_torch.ops import fano_mc, stack_mc
from convolutional_codes_tpu_torch.ops.channels import awgn_sigma
from convolutional_codes_tpu_torch.parallel.mesh import make_mesh
from convolutional_codes_tpu_torch.parallel.seq_grid import seq_mc_grid

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """One intra-op thread: the AWGN datagen's float32 transcendentals on
    tensors of more than 2048 elements (ROADMAP Q3)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _totals(out):
    return int(out[0].sum()), int(out[1].sum())


def test_fano_grid_matches_serial_two_points():
    code = get_code(0)
    param = float(awgn_sigma(4.0))
    kw = dict(channel="awgn", demapper="soft", timeout_per_bit=20)
    serial = [_totals(fano_mc.mc_fano(code, 64, 2, s, param, device="cpu", **kw))
              for s in (42, 43)]
    mesh = make_mesh({"sweep": 2, "frames": 2}, devices=[CPU] * 4)
    ((be, fe, nb, _),) = seq_mc_grid("fano", code, 64, [(2, [42, 43])], [param, param], mesh,
                                     **kw)
    for r in range(2):
        assert (int(be[r]), int(fe[r])) == serial[r] and nb[r] == 64 * 2 * 40
    assert int(be.sum()) > 0


def test_fano_one_point_all_devices():
    """R = 1: one point's lanes split across the whole mesh."""
    code = get_code(0)
    param = float(awgn_sigma(4.0))
    kw = dict(channel="awgn", demapper="soft", timeout_per_bit=20)
    serial = _totals(fano_mc.mc_fano(code, 64, 2, 42, param, device="cpu", **kw))
    mesh = make_mesh({"sweep": 2, "frames": 2}, devices=[CPU] * 4)
    ((be, fe, nb, _),) = seq_mc_grid("fano", code, 64, [(2, [42])], [param], mesh, **kw)
    assert (int(be[0]), int(fe[0])) == serial and nb[0] == 64 * 2 * 40


def test_stack_grid_matches_serial():
    code = get_code(0)
    serial = _totals(stack_mc.mc_stack(code, 64, 2, 7, 0.05, channel="bsc", device="cpu"))
    mesh = make_mesh({"frames": 8}, devices=[CPU] * 8)
    ((be, fe, nb, _),) = seq_mc_grid("stack", code, 64, [(2, [7])], [0.05], mesh,
                                     channel="bsc")
    assert (int(be[0]), int(fe[0])) == serial and int(be[0]) > 0


def test_points_with_distinct_params():
    """Per-point channel params land on the right slot groups."""
    code = get_code(0)
    p_lo, p_hi = float(awgn_sigma(0.0)), float(awgn_sigma(8.0))
    mesh = make_mesh({"sweep": 2, "frames": 2}, devices=[CPU] * 4)
    ((be, _, _, _),) = seq_mc_grid("fano", code, 32, [(1, [5, 5])], [p_lo, p_hi], mesh,
                                   channel="awgn", timeout_per_bit=30)
    assert int(be[0]) > int(be[1])


def test_stack_bsc_grid_equals_jax():
    """64 lanes x 2 frames a lane, two points on sweep=2 x frames=2: the
    port's grid equals the JAX package's interpret-mode grid exactly."""
    mesh = make_mesh({"sweep": 2, "frames": 2}, devices=[CPU] * 4)
    ((*ours, _),) = seq_mc_grid("stack", get_code(0), 64, [(2, [7, 8])], [0.05, 0.03], mesh,
                                channel="bsc")
    ref = jsg.seq_mc_grid("stack", jax_code(0), 64, 2, [7, 8], [0.05, 0.03],
                          jax_mesh({"sweep": 2, "frames": 2}, devices=jax.devices()[:4]),
                          channel="bsc", block_lanes=8, interpret=True)
    for o, r in zip(ours, ref):
        assert o.tolist() == np.asarray(r).tolist()
    assert int(ours[0].min()) > 0


def test_fano_bsc_grid_equals_jax_decoder():
    """The same grid for Fano: each point equals the JAX package's XLA
    Fano decoder on the JAX package's frames of those seeds and ids."""
    mesh = make_mesh({"sweep": 2, "frames": 2}, devices=[CPU] * 4)
    ((be, fe, _, _),) = seq_mc_grid("fano", get_code(0), 64, [(2, [7, 8])], [0.02, 0.03],
                                    mesh, channel="bsc", timeout_per_bit=20)
    jc = jax_code(0)
    for r, (seed, p) in enumerate([(7, 0.02), (8, 0.03)]):
        bits, syms = jmcdg.frames_host(jc, np.arange(128), seed, p, "bsc")
        err = (np.asarray(jfano.fano_decode_hard(jc, syms, 20)) != bits[:, :40]).sum(axis=1)
        assert (int(be[r]), int(fe[r])) == (int(err.sum()), int((err > 0).sum()))
    assert int(be.min()) > 0


@pytest.mark.parametrize("channel,param", [("bsc", 0.04), ("awgn", float(awgn_sigma(4.0)))])
def test_plain_versions_take_lane0(channel, param):
    """``lane0 = k * Bl`` gives lanes [k * Bl, (k+1) * Bl) of one serial run."""
    code = get_code(0)
    stack = stack_mc.mc_stack_ref(code, 32, 2, 9, param, channel)
    fano = fano_mc.mc_fano_ref(code, 32, 2, 9, param, channel, timeout_per_bit=20)
    for k in (1, 3):
        sl = slice(8 * k, 8 * k + 8)
        assert torch.equal(stack_mc.mc_stack_ref(code, 8, 2, 9, param, channel, lane0=8 * k),
                           stack[:, sl])
        assert torch.equal(fano_mc.mc_fano(code, 8, 2, 9, param, channel, timeout_per_bit=20,
                                           device="cpu", lane0=8 * k), fano[:, sl])
    assert int(stack[0].sum()) > 0


def test_shapes_that_do_not_divide_raise():
    code = get_code(0)
    mesh = make_mesh({"frames": 4}, devices=[CPU] * 4)
    with pytest.raises(ValueError, match="do not divide"):
        seq_mc_grid("stack", code, 64, [(1, [1, 2, 3])], [0.1] * 3, mesh, channel="bsc")
    with pytest.raises(ValueError, match="not divisible"):
        seq_mc_grid("stack", code, 66, [(1, [1])], [0.1], mesh, channel="bsc")
    with pytest.raises(ValueError, match="length mismatch"):
        seq_mc_grid("fano", code, 64, [(1, [1])], [0.1, 0.2], mesh, channel="bsc")
    with pytest.raises(ValueError, match="not a sequential decoder"):
        seq_mc_grid("viterbi", code, 64, [(1, [1])], [0.1], mesh, channel="bsc")
    with pytest.raises(ValueError, match="2\\^31"):
        stack_mc.mc_stack_ref(code, 8, 2 ** 20, 0, 0.1, "bsc", lane0=2 ** 11)
    with pytest.raises(ValueError, match="lane0"):
        fano_mc.mc_fano(code, 8, 1, 0, 0.1, "bsc", device="cpu", lane0=-1)


@pytest.fixture
def grid_device(request):
    """The parametrised device: the CPU, or the first card (skips without
    one: the walk kernels have no CPU mode)."""
    if request.param == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the walk kernels have no CPU mode)")
    return torch.device(request.param, 0) if request.param == "cuda" else CPU


@pytest.mark.parametrize("grid_device", ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)],
                         indirect=True)
@pytest.mark.parametrize("decoder", ["fano", "stack"])
def test_two_slices_equal_two_serial_calls(decoder, grid_device):
    """A cold and a warm slice in one call (on a card: side by side, the
    warm one on the side stream) give, counter for counter, the two
    single-slice calls one after the other, on a mesh of one device
    repeated: two points over sweep=2 x frames=2."""
    code = get_code(0)
    kw = dict(channel="bsc", timeout_per_bit=20) if decoder == "fano" else dict(channel="bsc")
    mesh = make_mesh({"sweep": 2, "frames": 2}, devices=[grid_device] * 4)
    slices = [(1, [5, 6]), (3, [7, 8])]
    both = seq_mc_grid(decoder, code, 64, slices, [0.03, 0.05], mesh, **kw)
    for got, one in zip(both, slices):
        ((be, fe, nb, _),) = seq_mc_grid(decoder, code, 64, [one], [0.03, 0.05], mesh, **kw)
        assert (got.bit_errors.tolist(), got.frame_errors.tolist(), got.bits.tolist()) == (
            be.tolist(), fe.tolist(), nb.tolist())
        assert got.seconds > 0
    assert both[1].bits.tolist() == [64 * 3 * code.block_length] * 2
    assert int(both[1].bit_errors.min()) > 0


@pytest.mark.parametrize("fpl", [1, 3])
def test_both_slices_launch_before_the_read_back(monkeypatch, fpl):
    """``sequential_points`` with the kernel entry and the read-back
    patched: the cold slice's entry call, then the warm slice's, then the
    one read to the host; a plan of one frame a lane makes exactly one
    entry call."""
    from convolutional_codes_tpu_torch.parallel import seq_grid
    from convolutional_codes_tpu_torch.parallel.mesh import one_slot
    from convolutional_codes_tpu_torch.sim.sweep import (
        WARM_SEED_XOR, SweepSpec, _chunk_seed, sequential_points)

    calls, read = [], torch.Tensor.cpu

    def entry(code, lanes, frames_per_lane, seed, param, **kwargs):
        calls.append(("launch", lanes, frames_per_lane, seed))
        return torch.ones((3, lanes), dtype=torch.int64)

    def read_back(self, *args, **kwargs):
        calls.append("read")
        return read(self, *args, **kwargs)

    monkeypatch.setattr(seq_grid, "mc_stack", entry)
    monkeypatch.setattr(torch.Tensor, "cpu", read_back)
    code = get_code(0)
    spec = SweepSpec(code=0, channel="bsc", decoder="stack", seed=4,
                     bits_per_point=fpl * 1024 * code.block_length)
    [(be, fe, nb, wb, ww)] = sequential_points(spec, code, [(2, 0.05, 0.05)], one_slot(CPU))
    seed = _chunk_seed(4, 2, 0)
    want = [("launch", 1024, 1, seed)] + [("launch", 1024, 2, seed ^ WARM_SEED_XOR)] * (fpl > 1)
    assert calls == want + ["read"]
    assert (be, fe, nb) == (1024 * len(want), 1024 * len(want), 1024 * fpl * code.block_length)
    assert wb == 1024 * (fpl - 1) * code.block_length and (ww > 0) == (fpl > 1)
