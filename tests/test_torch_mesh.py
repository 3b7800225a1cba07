"""PyTorch port, the mesh layer (``parallel/mesh.py``, ``parallel/montecarlo.py``):
mesh construction against the JAX package's ``make_mesh``, and the fused
kernel's plain version on meshes of repeated CPU slots against the JAX
package's ``fused_mc_accumulate``/``fused_grid_accumulate`` (interpret
mode, 8 virtual devices).

Tolerances: BSC counters exactly (the same hash streams and per-device
seeds); AWGN modular-chain counters exactly between the port's own grid
and serial runs (the same generators).
"""

import jax
import numpy as np
import pytest
import torch

from convolutional_codes_tpu.models.codebook import get_code as jax_code
from convolutional_codes_tpu.parallel import mesh as jmesh
from convolutional_codes_tpu.parallel import montecarlo as jmc
from convolutional_codes_tpu_torch.models.codebook import get_code
from convolutional_codes_tpu_torch.ops.channels import awgn_sigma
from convolutional_codes_tpu_torch.parallel import montecarlo as mc
from convolutional_codes_tpu_torch.parallel.mesh import frames_axis_size, make_mesh
from convolutional_codes_tpu_torch.sim.chain import make_point_step

torch.set_num_threads(2)
CPU = torch.device("cpu")


@pytest.mark.parametrize("shape", [None, {"frames": 8}, {"sweep": 2, "frames": 4},
                                   {"sweep": 2, "frames": -1}, {"seq": -1},
                                   {"sweep": 4, "frames": 2}])
def test_make_mesh_matches_jax(shape):
    ours = make_mesh(shape, devices=[CPU] * 8)
    ref = jmesh.make_mesh(shape, devices=jax.devices()[:8])
    assert ours.axis_names == tuple(ref.axis_names)
    assert ours.shape == dict(ref.shape)
    assert frames_axis_size(ours) == jmesh.frames_axis_size(ref)
    assert ours.size == 8 and all(d == CPU for d, _ in ours.slots())


def test_make_mesh_errors():
    with pytest.raises(ValueError, match="does not match 8 devices"):
        make_mesh({"sweep": 3, "frames": 2}, devices=[CPU] * 8)
    with pytest.raises(ValueError, match="does not match 8 devices"):
        jmesh.make_mesh({"sweep": 3, "frames": 2}, devices=jax.devices()[:8])
    with pytest.raises(ValueError, match="does not match 4 devices"):
        make_mesh({"frames": 8}, devices=[CPU] * 4)   # nothing shrinks quietly
    with pytest.raises(ValueError, match="all CUDA or all CPU"):
        make_mesh({"frames": 2}, devices=[CPU, torch.device("meta")])
    assert frames_axis_size(None) == 1
    assert frames_axis_size(make_mesh({"seq": 2}, devices=[CPU] * 2)) == 1


def test_default_devices_are_the_cards():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default mesh is on the cards")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh({"frames": 1})


def test_slots_order():
    mesh = make_mesh({"sweep": 2, "frames": 3},
                     devices=[torch.device("cpu", i) for i in range(6)])
    idx = lambda slots: [d.index for d, _ in slots]
    assert idx(mesh.slots()) == [0, 1, 2, 3, 4, 5]
    assert idx(mesh.slots(("frames",))) == [0, 1, 2]
    assert idx(mesh.slots(("sweep",))) == [0, 3]
    assert idx(mesh.slots(("frames", "sweep"))) == [0, 3, 1, 4, 2, 5]


def test_fused_frames_mesh_equals_jax():
    """Kernel 3's plain version on 4 CPU slots: BSC, batch 128, 2 steps;
    the counters equal the JAX package's interpret kernel on 4 virtual
    devices, and four serial runs with the derived seeds."""
    mesh = make_mesh({"frames": 4}, devices=[CPU] * 4)
    ours = mc.fused_mc_accumulate(get_code(0), 2, 2 ** 31 + 5, 0.05, 128, mesh,
                                  channel="bsc", device="cpu")
    ref = jmc.fused_mc_accumulate(jax_code(0), 2, 2 ** 31 + 5, 0.05, 128,
                                  jmesh.make_mesh({"frames": 4}, devices=jax.devices()[:4]),
                                  channel="bsc", interpret=True)
    serial = [mc.fused_mc_accumulate(get_code(0), 2, mc.device_seed(2 ** 31 + 5, d), 0.05,
                                     128, channel="bsc", device="cpu") for d in range(4)]
    assert ours == ref == tuple(int(x) for x in np.sum(serial, axis=0))
    assert ours[2] == 4 * 128 * 40 * 2 and ours[0] > 0


def test_fused_grid_equals_jax():
    mesh = make_mesh({"sweep": 2, "frames": 2}, devices=[CPU] * 4)
    seeds = np.array([[11, 12], [13, 14]], np.int64)
    ours = mc.fused_grid_accumulate(get_code(0), 2, seeds, [0.05, 0.03], 128, mesh,
                                    channel="bsc")
    ref = jmc.fused_grid_accumulate(jax_code(0), 2, seeds.astype(np.int32), [0.05, 0.03],
                                    128, jmesh.make_mesh({"sweep": 2, "frames": 2},
                                                         devices=jax.devices()[:4]),
                                    channel="bsc", interpret=True)
    for o, r in zip(ours, ref):
        assert o.tolist() == np.asarray(r).tolist()
    assert ours[0][0] > ours[0][1] > 0                  # the worse channel errs more


def test_sharded_accumulate_builds_one_step_per_device():
    code = get_code(0)
    devs = [torch.device("cpu", i % 2) for i in range(4)]
    mesh = make_mesh({"frames": 4}, devices=devs)
    built = []

    def build(dev):
        built.append(dev)
        return make_point_step(code, "awgn", "viterbi", frames=64, device=dev)

    step = mc.per_device(build, mesh)
    sigma = float(awgn_sigma(4.0))
    be, fe, nb = mc.frames_accumulate(step, 2, 9, sigma, mesh)
    assert built == [torch.device("cpu", 0), torch.device("cpu", 1)]
    serial = [mc.sharded_accumulate(build(CPU), 2, torch.Generator().manual_seed(
        mc.device_seed(9, d)), sigma) for d in range(4)]
    assert (be, fe, nb) == tuple(int(x) for x in np.sum(serial, axis=0))
    assert nb == 4 * 2 * 64 * 40 and be > 0


def test_sweep_grid_equals_slotwise_runs():
    """Twin of tests/test_sweep.py::test_sweep_grid_two_axis_mesh: points
    over `sweep`, frames over `frames`; each point equals its frames-only
    run with the grid's seeds."""
    code = get_code(0)
    mesh = make_mesh({"sweep": 2, "frames": 4}, devices=[CPU] * 8)
    build = lambda dev: make_point_step(code, "bsc", "viterbi", frames=128, device=dev)
    step = mc.per_device(build, mesh)
    be, fe, nb = mc.sweep_grid_accumulate(step, 2, 0, [0.0125, 0.05], mesh)
    assert be.shape == (2,) and np.all(nb == 128 * 40 * 2 * 4)
    assert be[1] > be[0]                                # worse channel, more errors
    fmesh = make_mesh({"frames": 4}, devices=[CPU] * 4)
    seeds = [[mc.device_seed(0, r * 4 + d) for d in range(4)] for r in range(2)]
    for r, p in enumerate([0.0125, 0.05]):
        one = mc.grid_accumulate_with_keys(step, 2, [seeds[r]], [p], fmesh,
                                           axes=("frames",))
        assert [int(x[0]) for x in one] == [int(be[r]), int(fe[r]), int(nb[r])]
