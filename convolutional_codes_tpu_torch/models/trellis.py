"""Trellis precomputation: parity, expected-symbol tables, butterfly views.

The port's own copy of the JAX package's ``models/trellis.py`` (NumPy
only; ``tests/test_torch_models.py`` holds the two equal).  A
:class:`~convolutional_codes_tpu_torch.models.codebook.Code` is turned into
dense integer tables once on the host; the Viterbi kernels consume pure
array data, and the big-K sequential decoders use closed-form 32-bit
register math where tables would not fit (K=32 WSPR → 2^31 states).

Semantics pinned against the reference:
  * Register layout: newest input bit at the MSB of a right-shifting register
    (``encoder.c:87-89``).  We keep registers in *low* K-bit integers,
    ``r = reference_register >> (64 - K)``, so bit K-1 is the newest input and
    bit 0 the oldest.
  * State = top K-1 register bits *excluding* the newest input:
    ``r = state | input << (K-1)``, ``next_state = r >> 1``
    (``AWGN-channel/viterbi-decoder.c:65-66``).
  * Expected symbol packs output bits MSB-first: polynomial 0 lands at the
    symbol MSB (``encoder.c:92-105``).
  * Parity modes: "true" parity, and "compat" — the reference's effective
    parity where the unmasked shift count makes the routine return 0 whenever
    the XOR of 64-bit register bits {4,12,...,60} of (register & polynomial)
    is 1 (verified; SURVEY.md §2c).  In low-bit space that quirk set becomes
    bits {j - 64 + K : j in {4,12,...,60}} ∩ [0, K).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

from convolutional_codes_tpu_torch.models.codebook import Code, PARITY_COMPAT

# 64-bit positions whose XOR corrupts the reference parity routine's shift
# count (bit 4 of each byte of the folded value): {4, 12, ..., 60}.
_QUIRK_POSITIONS_64 = tuple(range(4, 61, 8))


def quirk_mask_low(constraint_length: int) -> int:
    """The compat-parity quirk mask expressed in low-K-bit register space."""
    mask = 0
    for j in _QUIRK_POSITIONS_64:
        b = j - 64 + constraint_length
        if 0 <= b < constraint_length:
            mask |= 1 << b
    return mask


def parity_u64(x: np.ndarray) -> np.ndarray:
    """True parity of each element (numpy, any unsigned integer dtype)."""
    x = x.astype(np.uint64, copy=True)
    for s in (32, 16, 8, 4, 2, 1):
        x ^= x >> np.uint64(s)
    return (x & np.uint64(1)).astype(np.int64)


def effective_parity_u64(x: np.ndarray, constraint_length: int) -> np.ndarray:
    """Reference-compatible parity of low-K-bit register values.

    Equals ``parity(x)`` unless the XOR of the quirk-set bits of ``x`` is 1,
    in which case it returns 0 — the net effect of the reference's
    ``0x6996 >> val`` with an unmasked shift count (x86 masks the count to
    val & 31; bit 4 of the byte-fold pushes the count past bit 14 of 0x6996,
    whose upper bits are all zero).
    """
    q = parity_u64(np.asarray(x, dtype=np.uint64) & np.uint64(quirk_mask_low(constraint_length)))
    return parity_u64(x) & (1 - q)


def _code_parity(code: Code, x: np.ndarray) -> np.ndarray:
    if code.parity == PARITY_COMPAT:
        return effective_parity_u64(x, code.constraint_length)
    return parity_u64(x)


def expected_symbols(code: Code, states: np.ndarray, inputs: np.ndarray) -> np.ndarray:
    """Expected channel symbol for (state, input) pairs. NumPy, broadcastable.

    Mirrors the shared ``get_transition_metric`` symbol computation
    (``AWGN-channel/viterbi-decoder.c:38-69``) in low-bit register space.
    """
    K = code.constraint_length
    r = (np.asarray(states, dtype=np.uint64)
         | (np.asarray(inputs, dtype=np.uint64) << np.uint64(K - 1)))
    sym = np.zeros(np.broadcast(states, inputs).shape, dtype=np.int64)
    for p in code.polynomials:
        sym = (sym << 1) | _code_parity(code, r & np.uint64(p))
    return sym


def next_states(code: Code, states: np.ndarray, inputs: np.ndarray) -> np.ndarray:
    """``new = (state >> 1) | input << (K-2)`` (viterbi-decoder.c:65-66)."""
    K = code.constraint_length
    s = np.asarray(states, dtype=np.int64)
    i = np.asarray(inputs, dtype=np.int64)
    return (s >> 1) | (i << (K - 2))


@dataclasses.dataclass(frozen=True)
class Trellis:
    """Dense trellis tables for a code with enumerable state space (K <= 16).

    Forward view (encoder / checks):
      next_state[s, i], expected_symbol[s, i]

    Butterfly (reverse) view for vectorized add-compare-select: a new state
    ``ns`` decomposes as ``ns = input * S/2 + j``; its two predecessors are
    ``2j`` and ``2j + 1``.  ``esym_prev[ns, b]`` is the expected symbol of the
    transition (prev=2j+b, input=ns >> (K-2)), so ACS is a pure gather + min
    over the last axis with *no* integer bit math inside the kernel.
    """

    code: Code
    next_state: np.ndarray       # [S, 2] int32
    expected_symbol: np.ndarray  # [S, 2] int32
    prev_state: np.ndarray       # [S, 2] int32
    esym_prev: np.ndarray        # [S, 2] int32
    input_of: np.ndarray         # [S]    int32  (input bit that leads *into* ns)

    @property
    def num_states(self) -> int:
        return self.code.num_states


@functools.lru_cache(maxsize=None)
def _build_trellis_cached(code: Code) -> Trellis:
    K = code.constraint_length
    if K > 16:
        raise ValueError(
            f"dense trellis needs K <= 16 (2^{K - 1} states); use the dynamic "
            "register math in ops for sequential decoders instead"
        )
    S = code.num_states
    s = np.arange(S, dtype=np.int64)[:, None]        # [S, 1]
    i = np.arange(2, dtype=np.int64)[None, :]        # [1, 2]
    nxt = next_states(code, s, i).astype(np.int32)           # [S, 2]
    esym = expected_symbols(code, s, i).astype(np.int32)     # [S, 2]

    ns = np.arange(S, dtype=np.int64)
    input_of = (ns >> (K - 2)).astype(np.int32)              # [S]
    j = ns & ((S >> 1) - 1)
    prev = np.stack([2 * j, 2 * j + 1], axis=1).astype(np.int32)  # [S, 2]
    esym_prev = expected_symbols(
        code, prev.astype(np.int64), input_of[:, None].astype(np.int64)
    ).astype(np.int32)

    # Consistency: following the forward table from prev must land on ns.
    assert np.all(nxt[prev, input_of[:, None]] == ns[:, None])

    return Trellis(code=code, next_state=nxt, expected_symbol=esym,
                   prev_state=prev, esym_prev=esym_prev, input_of=input_of)


def build_trellis(code: Code) -> Trellis:
    return _build_trellis_cached(code)

