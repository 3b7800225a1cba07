"""Soft and hard demappers.

Soft (``common/demapper.c:61-85``): the squared Euclidean distances of each
received (I, Q) to every constellation point, divided by ``ndist`` (the
squared distance of points 0 and 1, ``demapper.c:42-45``).  Hard
(``common/hard-demapper.c:66-87``): snap to the nearest point first (ties
to the lowest index), then emit the snapped point's distance vector.
"""

from __future__ import annotations

import torch

from convolutional_codes_tpu.models.constellations import get_constellation, min_sq_distance
from convolutional_codes_tpu_torch.utils.bitops import first_argmin


def _points(num_bits: int, device) -> torch.Tensor:
    return torch.as_tensor(get_constellation(num_bits), device=device)


def _sq_distances(iq: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    d = iq[..., None, :] - points            # [..., 2^m, 2]
    return (d * d).sum(-1)                   # [..., 2^m]


def _normalized(num_bits: int, sq: torch.Tensor) -> torch.Tensor:
    return sq / torch.tensor(min_sq_distance(num_bits), dtype=torch.float32)


def soft_demap(num_bits: int, iq: torch.Tensor) -> torch.Tensor:
    """``[..., T, 2]`` received (I,Q) → ``[..., T, 2^m]`` normalized sq-dists."""
    return _normalized(num_bits, _sq_distances(iq, _points(num_bits, iq.device)))


def hard_decide(num_bits: int, iq: torch.Tensor) -> torch.Tensor:
    """Nearest constellation point index per received (I,Q): ``[..., T]``
    int32, first index on ties."""
    d = _sq_distances(iq, _points(num_bits, iq.device))
    return first_argmin(d, dim=-1).to(torch.int32)


def hard_demap(num_bits: int, iq: torch.Tensor) -> torch.Tensor:
    """Snap-then-distance demapper; same output as :func:`soft_demap`."""
    points = _points(num_bits, iq.device)
    snapped = points[hard_decide(num_bits, iq).to(torch.int64)]
    return _normalized(num_bits, _sq_distances(snapped, points))
