"""Code registry: convolutional codes as immutable data.

The port's own copy of the JAX package's ``models/codebook.py`` (pure
Python; ``tests/test_torch_models.py`` holds the two equal).  It mirrors
the behavioral contract of the C reference's codebook
(``common/codebook.c:14-120`` and ``common/include/code.h:9-19``) while
being a pure-data, user-extensible registry instead of static C arrays.

Polynomial convention
---------------------
The reference stores generator polynomials MSB-aligned in a ``uint64`` whose
bit 63 is the *newest* shift-register bit (``encoder.c:87-100``).  We store
each polynomial as a plain Python int of ``constraint_length`` bits with the
newest-input tap at bit ``K-1`` and the oldest at bit 0, i.e. exactly
``reference_poly >> (64 - K)``.  This keeps all trellis math in narrow
integers (32-bit registers up to K=32) instead of uint64.

Parity modes
------------
The reference's shared parity routine is *not* true parity: the byte-fold
value is used unmasked as a shift count, so whenever the XOR of register bits
{4,12,...,60} (of register & polynomial) is 1 the routine returns 0
(verified empirically; see SURVEY.md section 2c).  Published BER curves for
codes 1-4 describe these *effective* nonlinear codes.  Each :class:`Code`
therefore carries ``parity``: ``"true"`` (default for new codes) or
``"compat"`` (bit-exact reproduction of the reference, default for the six
shipped codes so that golden curves match).  For codes 0 and 5 the two modes
are identical.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

PARITY_TRUE = "true"
PARITY_COMPAT = "compat"


@dataclasses.dataclass(frozen=True)
class Code:
    """Immutable description of a convolutional code + decoder tuning.

    Mirrors ``struct code_param`` (reference ``common/include/code.h:9-19``)
    minus the C plumbing (userdata pointer), plus the explicit parity mode.
    """

    name: str
    #: Output bits per input bit (code rate is 1/symlen_out). Reference: symlen_out.
    symlen_out: int
    #: Constraint length K (register length incl. current input bit).
    constraint_length: int
    #: Information bits per block (tail of K-1 zeros is appended automatically).
    block_length: int
    #: Generator polynomials, one per output bit; bit K-1 = newest-input tap.
    polynomials: Tuple[int, ...]
    #: {correct, wrong} per-bit metrics for the hard-decision stack decoder
    #: (reference codebook.c:18-56, tuned for crossover p=0.01).
    bit_metrics: Tuple[int, int] = (1, -1)
    #: {correct, wrong} per-bit metrics for the hard-decision Fano decoder.
    fano_bit_metrics: Tuple[int, int] = (1, -1)
    #: Weight of the normalized squared distance in the soft stack metric
    #: ``1 + w * dist`` (reference stack-decoder.c:274; tuned for 8 dB).
    metric_weight: float = -15.0
    #: Same for the soft Fano metric (reference fano-decoder.c:309).
    fano_metric_weight: float = -200.0
    #: Parity mode: "true" (mathematical parity) or "compat"
    #: (reference-effective parity, see module docstring).
    parity: str = PARITY_TRUE

    def __post_init__(self):
        if self.symlen_out not in (1, 2, 3):
            # The constellation set (BPSK/QPSK/8-QAM) covers 1..3 coded bits
            # per channel symbol, like the reference (constellations.c:8-32).
            # Decoders themselves support any symlen; only the mapped (AWGN)
            # chain needs a constellation.
            if not (1 <= self.symlen_out <= 8):
                raise ValueError(f"symlen_out={self.symlen_out} out of range")
        if len(self.polynomials) != self.symlen_out:
            raise ValueError("need one polynomial per output bit")
        if not (2 <= self.constraint_length <= 32):
            raise ValueError(
                "constraint_length must be in [2, 32] (states kept in int32 "
                f"lanes); got {self.constraint_length}"
            )
        for p in self.polynomials:
            if p <= 0 or p >= (1 << self.constraint_length):
                raise ValueError(f"polynomial {p:#x} does not fit K={self.constraint_length}")
        if self.parity not in (PARITY_TRUE, PARITY_COMPAT):
            raise ValueError(f"parity must be 'true' or 'compat', got {self.parity!r}")

    # Derived quantities -------------------------------------------------
    @property
    def num_states(self) -> int:
        return 1 << (self.constraint_length - 1)

    @property
    def num_block_symbols(self) -> int:
        """Channel symbols per block incl. the K-1 tail (encoder.c:42)."""
        return self.block_length + self.constraint_length - 1

    @property
    def points_per_symbol(self) -> int:
        """Constellation size / number of demapper distances, 2**symlen_out."""
        return 1 << self.symlen_out

    def replace(self, **kw) -> "Code":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Registry. Indices 0-5 mirror the reference codebook exactly
# (codebook.c:14-120); entries beyond that are framework extensions used by
# the scaling configs (BASELINE.json).
# ---------------------------------------------------------------------------

_REGISTRY: Dict[object, Code] = {}


def register_code(key, code: Code, overwrite: bool = False) -> Code:
    """Add a user-defined code to the registry (mirrors the extensibility
    promise of reference Readme.md:19)."""
    if key in _REGISTRY and not overwrite:
        raise KeyError(f"code key {key!r} already registered")
    _REGISTRY[key] = code
    return code


def get_code(key) -> Code:
    """Look up a code by index or name (reference get_code, codebook.c:110-120)."""
    return _REGISTRY[key]


def list_codes() -> Dict[object, Code]:
    return dict(_REGISTRY)


def _register_builtins() -> None:
    # The six shipped codes, bit-identical parameters to codebook.c.
    # Polynomials are reference_poly >> (64 - K); comments give the
    # newest-bit-first binary form used in the reference comments.
    builtin = [
        Code(  # index 0 — default BSC/golden code (codebook.c:14-18)
            name="k3-r12",
            symlen_out=2, constraint_length=3, block_length=40,
            polynomials=(0b101, 0b011),
            bit_metrics=(1, -15), fano_bit_metrics=(1, -20),
            metric_weight=-15.0, fano_metric_weight=-200.0,
            parity=PARITY_COMPAT,  # identical to true parity for K=3
        ),
        Code(  # index 1 (codebook.c:21-25) — parity quirk affects P0
            name="k4-r12",
            symlen_out=2, constraint_length=4, block_length=40,
            polynomials=(0b1011, 0b1110),
            bit_metrics=(1, -25), fano_bit_metrics=(1, -45),
            metric_weight=-15.0, fano_metric_weight=-150.0,
            parity=PARITY_COMPAT,
        ),
        Code(  # index 2 (codebook.c:28-32) — quirk affects P1
            name="k5-r12",
            symlen_out=2, constraint_length=5, block_length=40,
            polynomials=(0b10101, 0b11110),
            bit_metrics=(1, -30), fano_bit_metrics=(1, -48),
            metric_weight=-20.0, fano_metric_weight=-130.0,
            parity=PARITY_COMPAT,
        ),
        Code(  # index 3 (codebook.c:35-39) — quirk affects P0
            name="k6-r12",
            symlen_out=2, constraint_length=6, block_length=40,
            polynomials=(0b101101, 0b111010),
            bit_metrics=(1, -39), fano_bit_metrics=(1, -55),
            metric_weight=-16.0, fano_metric_weight=-110.0,
            parity=PARITY_COMPAT,
        ),
        Code(  # index 4 — WSPR K=32, sequential decoders only (codebook.c:42-46)
            name="wspr-k32",
            symlen_out=2, constraint_length=32, block_length=50,
            polynomials=(0x8ACA0B4F, 0xE23C8627),
            bit_metrics=(1, -27), fano_bit_metrics=(1, -38),
            metric_weight=-7.0, fano_metric_weight=-11.0,
            parity=PARITY_COMPAT,  # quirk affects P1
        ),
        Code(  # index 5 — rate 1/3, 8-point constellation (codebook.c:50-54)
            name="k3-r13",
            symlen_out=3, constraint_length=3, block_length=40,
            polynomials=(0b101, 0b110, 0b001),
            bit_metrics=(1, -9), fano_bit_metrics=(1, -30),
            metric_weight=-7.0, fano_metric_weight=-70.0,
            parity=PARITY_COMPAT,  # identical to true parity for K=3
        ),
    ]
    for i, c in enumerate(builtin):
        register_code(i, c)
        register_code(c.name, c)

    # Framework extensions (no reference counterpart; BASELINE.json configs).
    extensions = [
        Code(  # classic K=3 (7,5) — BASELINE.json config 0 (long BSC frames).
            # Non-catastrophic (gcd(1+D+D^2, 1+D^2) = 1), unlike reference
            # code 0 (101,011) whose generators share the factor (1+D):
            # that code is fine on the reference's 40-bit terminated blocks
            # but smears channel errors indefinitely on unterminated long
            # frames, so it must not be used for streaming configurations.
            name="k3-75",
            symlen_out=2, constraint_length=3, block_length=40,
            polynomials=(0b111, 0b101),
            bit_metrics=(1, -15), fano_bit_metrics=(1, -20),
            metric_weight=-15.0, fano_metric_weight=-200.0,
            parity=PARITY_TRUE,
        ),
        Code(  # NASA standard (171, 133) K=7 — streaming/long-frame config
            name="nasa-k7",
            symlen_out=2, constraint_length=7, block_length=200,
            polynomials=(0o171, 0o133),
            bit_metrics=(1, -30), fano_bit_metrics=(1, -48),
            metric_weight=-16.0, fano_metric_weight=-110.0,
            parity=PARITY_TRUE,
        ),
        Code(  # K=9 (561, 753) — stack-decoder scaling config
            name="k9-r12",
            symlen_out=2, constraint_length=9, block_length=100,
            polynomials=(0o561, 0o753),
            bit_metrics=(1, -30), fano_bit_metrics=(1, -48),
            metric_weight=-16.0, fano_metric_weight=-110.0,
            parity=PARITY_TRUE,
        ),
        Code(  # K=15 long-constraint — Fano scaling config
            name="k15-r12",
            symlen_out=2, constraint_length=15, block_length=200,
            polynomials=(0o42554, 0o77304),
            bit_metrics=(1, -30), fano_bit_metrics=(1, -48),
            metric_weight=-16.0, fano_metric_weight=-110.0,
            parity=PARITY_TRUE,
        ),
        Code(  # K=15 rate-1/4 on Gray 16-QAM — BASELINE.json config 5
            # (Fano + 16-QAM soft demapper); one coded 4-bit symbol per
            # channel symbol, so Eb = Es like the reference mapped chains.
            # Soft weights tuned for 6 dB (the convention the reference uses
            # for its sequential-only code, codebook.c:76-79): the per-symbol
            # metric 1 + w*dist must stay positive in expectation on the
            # correct path, and 16-QAM's ndist = 0.4 makes E[dist|correct] =
            # 2 sigma^2 / 0.4 five times the QPSK value at equal Eb/N0 — the
            # round-3 defaults (-8/-40) sat so deep that every Fano walk
            # below 12 dB exhausted its budget (FER = 1.0) and the stack
            # shed the correct path at 6 dB (BER 0.06 vs 0.001); measured
            # cliffs with -1.5: Fano clean from 6 dB, stack from ~6 dB.
            name="k15-r14-16qam",
            symlen_out=4, constraint_length=15, block_length=200,
            polynomials=(0o42554, 0o77304, 0o56043, 0o61175),
            bit_metrics=(1, -30), fano_bit_metrics=(1, -48),
            metric_weight=-1.5, fano_metric_weight=-1.5,
            parity=PARITY_TRUE,
        ),
    ]
    for c in extensions:
        register_code(c.name, c)


_register_builtins()
