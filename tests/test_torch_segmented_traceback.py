"""PyTorch port, the segment-parallel traceback of TPU kernel 5
(``csrc/longframe.cu``: ``tb_map_kernel``, ``tb_fold_kernel`` and the
segment walk of ``stream_traceback_kernel``).

A plain torch model of the kernels' algebra — every segment's map {end
state -> state before the segment}, the fold of the maps from the last
segment back, and the walk of each segment from its true end state — is
held bit for bit (tolerance 0) against ``ops.viterbi.traceback_carry`` on
seeded random decisions, at segment edges and with both kinds of start
(given start states, and the first state of least final metric), and once
against the JAX package's interpret-mode ``stream_traceback_pallas``.
``traceback_plan``'s choices are pinned at the shapes the port runs.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from convolutional_codes_tpu.models.codebook import get_code as jax_code
from convolutional_codes_tpu.models.trellis import build_trellis
from convolutional_codes_tpu.ops import longframe_pallas as jlp
from convolutional_codes_tpu_torch.models.codebook import get_code
from convolutional_codes_tpu_torch.ops.viterbi import traceback_carry
from convolutional_codes_tpu_torch.ops.viterbi_cuda import (
    SEGMENT_ROWS, TracebackPlan, frame_walk_min_frames, traceback_plan)
from convolutional_codes_tpu_torch.utils.bitops import MASK32, first_argmin

L = 8   # rows per segment of the model (the kernels' edges at a small size)
CODES = {4: "k3-75", 64: "nasa-k7", 256: "k9-r12"}


def _walk(code, rows, cur):
    """The kernels' row step over ``rows`` [n, nwords, B] from states ``cur``
    [B, X], last row first: (bits [n, B, X] int32, states before row 0)."""
    K, half = code.constraint_length, (code.num_states >> 1) - 1
    bits = torch.empty((rows.shape[0],) + tuple(cur.shape), dtype=torch.int32)
    for t in range(rows.shape[0] - 1, -1, -1):
        word = torch.gather(rows[t].T.to(torch.int64) & MASK32, 1, cur >> 5)
        bits[t] = (cur >> (K - 2)).to(torch.int32)
        cur = ((cur & half) << 1) | ((word >> (cur & 31)) & 1)
    return bits, cur


def segmented_traceback(code, dec, start, seg):
    """The segment-parallel traceback: (bits [T, B] int32, carry [B])."""
    T, _, B = dec.shape
    S = code.num_states
    G = -(-T // seg)
    rows = [dec[g * seg: min(T, (g + 1) * seg)] for g in range(G)]
    every = torch.arange(S, dtype=torch.int64).expand(B, S)
    maps = [None] + [_walk(code, rows[g], every)[1] for g in range(1, G)]   # [B, S] each
    ends = [None] * G
    ends[G - 1] = start.to(torch.int64)
    for g in range(G - 1, 0, -1):
        ends[g - 1] = torch.gather(maps[g], 1, ends[g][:, None])[:, 0]
    walks = [_walk(code, rows[g], ends[g][:, None]) for g in range(G)]
    return torch.cat([b[:, :, 0] for b, _ in walks]), walks[0][1][:, 0]


def _decisions(S, T, B, seed):
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 2 ** 32, (T, (S + 31) // 32, B), dtype=np.uint64)
    return torch.as_tensor(words.astype(np.uint32).view(np.int32))


@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("T", [1, L - 1, L, L + 1, 5 * L + 3])
@pytest.mark.parametrize("S", sorted(CODES))
def test_segment_model_equals_traceback_carry(S, T, B):
    code = get_code(CODES[S])
    dec = _decisions(S, T, B, 100 * S + 10 * T + B)
    rng = np.random.default_rng(T + B)
    start = torch.as_tensor(rng.integers(0, S, B))
    bits, carry = segmented_traceback(code, dec, start, L)
    bits_r, carry_r = traceback_carry(code, dec, start)
    assert torch.equal(bits.T, bits_r) and torch.equal(carry, carry_r)
    # argmin mode: the first state of least final metric (ties on purpose)
    fm = torch.as_tensor(rng.integers(0, 3, (S, B)).astype(np.float32))
    bits_a, _ = segmented_traceback(code, dec, first_argmin(fm, dim=0), L)
    assert torch.equal(bits_a.T, traceback_carry(code, dec, first_argmin(fm, dim=0))[0])


def test_segment_model_equals_jax_pallas_interpret():
    code = get_code("nasa-k7")
    T, B = 64, 8
    dec = _decisions(64, T, B, 5)
    start = torch.as_tensor(np.random.default_rng(6).integers(0, 64, B), dtype=torch.int32)
    bits_j, cur_j = jlp.stream_traceback_pallas(build_trellis(jax_code("nasa-k7")),
                                                jnp.asarray(dec.numpy()),
                                                jnp.asarray(start.numpy()), chunk=16,
                                                interpret=True)
    bits, carry = segmented_traceback(code, dec, start, 24)   # 24 divides no chunk
    assert np.array_equal(bits.numpy(), np.asarray(bits_j))
    assert np.array_equal(carry.numpy(), np.asarray(cur_j))


@pytest.mark.parametrize("B,T,S,want", [
    (1, 65536, 64, TracebackPlan("segments", SEGMENT_ROWS)),
    (128, 65536, 64, TracebackPlan("segments", SEGMENT_ROWS)),
    (1024, 16384, 64, TracebackPlan("segments", SEGMENT_ROWS)),
    (262144, 42, 4, TracebackPlan("frame", 42)),            # kernel 2's shape
    (262144, 65536, 64, TracebackPlan("frame", 65536)),
    (4096, 4096, 64, TracebackPlan("frame", 4096)),         # the crossovers
    (4095, 4096, 256, TracebackPlan("segments", SEGMENT_ROWS)),
    (4096, 4096, 4, TracebackPlan("segments", SEGMENT_ROWS)),
    (6143, 4096, 32, TracebackPlan("segments", SEGMENT_ROWS)),
    (6144, 4096, 4, TracebackPlan("frame", 4096)),
    (1024, 4096, 256, TracebackPlan("segments", SEGMENT_ROWS)),
    (128, SEGMENT_ROWS, 256, TracebackPlan("frame", SEGMENT_ROWS)),
    (128, 10 ** 8, 4, TracebackPlan("segments", 1526)),     # 65,535 segments at most
    (128, 10 ** 8, 256, TracebackPlan("frame", 10 ** 8)),   # shared memory too small
])
def test_traceback_plan(B, T, S, want):
    assert traceback_plan(B, T, S) == want
    for s in (2, 4, 32, 64, 256):
        assert traceback_plan(frame_walk_min_frames(s), 65536, s).design == "frame"
        assert traceback_plan(frame_walk_min_frames(s) - 1, 65536, s).design == "segments"
