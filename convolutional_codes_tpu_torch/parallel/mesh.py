"""Device meshes: a named grid of slots, each slot a ``torch.device``.

The framework uses two logical axes for Monte-Carlo sweeps (the JAX
package's ``parallel/mesh.py``):
  * ``frames`` — data parallelism over independent Monte-Carlo frames
    (counters are summed over it),
  * ``sweep``  — parallelism over sweep points, each group of slots
    simulating a different channel quality;
and ``seq`` for time-range sharding of long frames (``parallel/streaming.py``).

One process drives every slot it owns: the mesh layer launches a slot's
work on its device and moves on, so slots on distinct cards overlap, while
slots that repeat one device run one after another on it.  A list that
repeats a device is how one card (or the CPU) holds a multi-slot mesh —
the counterpart of the JAX tests' virtual CPU devices.

Across processes (``parallel/distributed.initialize_from_env``) every
process passes its own local devices, all of one count; the mesh's slots
are the processes' lists in rank order, and each process runs only the
slots whose rank is its own.  Where a slot belongs to another process,
``devices`` holds this process's device of the same local index.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """Slots on named axes: ``devices[i0, i1, ...]`` runs in process
    ``ranks[i0, i1, ...]``; this process is ``rank`` of ``world``."""
    axis_names: Tuple[str, ...]
    devices: np.ndarray        #: object array of torch.device, one axis per name
    ranks: np.ndarray          #: int array of the same shape
    rank: int = 0
    world: int = 1

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def slots(self, axes: Optional[Sequence[str]] = None) -> List[Tuple[torch.device, int]]:
        """(device, rank) of the slots along ``axes`` (default: every axis),
        flattened in the order of ``axes`` (last fastest), every other axis
        at index 0."""
        axes = tuple(self.axis_names if axes is None else axes)
        pos = [self.axis_names.index(a) for a in axes]
        index = tuple(slice(None) if i in pos else 0 for i in range(len(self.axis_names)))
        order = np.argsort(np.argsort(pos))      # the kept axes' order in `axes`
        devs = np.transpose(self.devices[index], order) if pos else self.devices[index]
        ranks = np.transpose(self.ranks[index], order) if pos else self.ranks[index]
        return list(zip(np.ravel(devs).tolist(), np.ravel(ranks).tolist()))

    def sum_over_processes(self, counts: torch.Tensor) -> torch.Tensor:
        """Sum an int64 host tensor of this process's counters over every
        process of the mesh (``all_reduce``); the tensor itself without
        one.  Every process calls it at the same point of the same run."""
        if self.world == 1:
            return counts
        import torch.distributed as dist

        on = ("cuda" if dist.get_backend() == "nccl" else "cpu")
        t = counts.to(on)
        dist.all_reduce(t)
        return t.cpu()


def _process_layout(n: int) -> Tuple[int, int]:
    """(rank, world) of this process, checking that every process passes
    the same number of local devices."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        return 0, 1
    world, rank = dist.get_world_size(), dist.get_rank()
    counts = [None] * world
    dist.all_gather_object(counts, n)
    if len(set(counts)) != 1:
        raise ValueError(f"processes pass different numbers of local devices: {counts}")
    return rank, world


def local_card(rank: int) -> int:
    """The card of process ``rank`` on its node: ``LOCAL_RANK`` where
    torchrun sets it, else the rank modulo the visible cards."""
    return int(os.environ.get("LOCAL_RANK", rank % torch.cuda.device_count()))


def default_devices() -> List[torch.device]:
    """Every visible CUDA device; under ``torch.distributed``, this
    process's card (:func:`local_card`)."""
    import torch.distributed as dist

    if torch.cuda.device_count() == 0:
        raise RuntimeError("make_mesh: no CUDA device is visible; pass devices= "
                           "(e.g. [torch.device('cpu')] * 4) for a CPU mesh")
    if dist.is_available() and dist.is_initialized():
        return [torch.device("cuda", local_card(dist.get_rank()))]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def one_slot(device) -> Mesh:
    """A ``frames`` mesh of the one slot ``device`` in this process alone
    (no collective, even under ``torch.distributed``)."""
    devs = np.empty(1, dtype=object)
    devs[:] = [torch.device(device)]
    return Mesh(("frames",), devs, np.zeros(1, dtype=np.int64))


def make_mesh(shape: Optional[Dict[str, int]] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """Build a named mesh.  Default: all slots on one ``frames`` axis.

    ``shape`` maps axis name → size, e.g. ``{"sweep": 2, "frames": 4}``;
    sizes must multiply to the slot count (one ``-1`` is inferred).
    ``devices``: this process's devices, default :func:`default_devices`;
    a list may repeat a device.  Under ``torch.distributed`` the slots are
    every process's list in rank order.  A mesh's slots are all CUDA or
    all CPU.
    """
    local = [torch.device(d) for d in (default_devices() if devices is None else devices)]
    if not local:
        raise ValueError("make_mesh: no devices")
    if len({d.type for d in local}) != 1 or local[0].type not in ("cuda", "cpu"):
        raise ValueError(f"a mesh's slots are all CUDA or all CPU, got {local}")
    if local[0].type == "cuda":
        local = [torch.device("cuda", d.index if d.index is not None
                              else torch.cuda.current_device()) for d in local]
    rank, world = _process_layout(len(local))
    n = world * len(local)
    if shape is None:
        shape = {"frames": n}
    names = tuple(shape.keys())
    sizes = list(shape.values())
    if sizes.count(-1) == 1:
        known = math.prod(s for s in sizes if s != -1)
        sizes[sizes.index(-1)] = n // known
    if math.prod(sizes) != n:
        raise ValueError(f"mesh shape {dict(zip(names, sizes))} does not "
                         f"match {n} devices")
    devs = np.empty(n, dtype=object)
    devs[:] = local * world
    ranks = np.repeat(np.arange(world), len(local))
    return Mesh(names, devs.reshape(sizes), ranks.reshape(sizes), rank, world)


def frames_axis_size(mesh: Optional[Mesh]) -> int:
    if mesh is None or "frames" not in mesh.axis_names:
        return 1
    return mesh.shape["frames"]
