"""PyTorch port, code tables: the port's own copies of the JAX package's
``models/{codebook,trellis,constellations}.py`` stay equal to them.

Every comparison is exact: the registries hold the same codes under the
same keys, the dense trellises are equal integer tables, and the
constellations are equal float32 tables.
"""

import dataclasses

import numpy as np
import pytest

from convolutional_codes_tpu.models import codebook as jcb
from convolutional_codes_tpu.models import constellations as jcon
from convolutional_codes_tpu.models import trellis as jtr
from convolutional_codes_tpu_torch.models import codebook as tcb
from convolutional_codes_tpu_torch.models import constellations as tcon
from convolutional_codes_tpu_torch.models import trellis as ttr

#: every Code field the port reads
FIELDS = ("name", "polynomials", "constraint_length", "block_length",
          "symlen_out", "parity", "metric_weight", "bit_metrics",
          "fano_metric_weight", "fano_bit_metrics")
KEYS = list(jcb.list_codes())


def test_registries_hold_the_same_keys():
    assert list(tcb.list_codes()) == KEYS
    assert [f.name for f in dataclasses.fields(tcb.Code)] == \
        [f.name for f in dataclasses.fields(jcb.Code)]


@pytest.mark.parametrize("key", KEYS, ids=str)
def test_code_fields_equal(key):
    j, t = jcb.get_code(key), tcb.get_code(key)
    assert isinstance(t, tcb.Code)
    for f in FIELDS:
        assert getattr(t, f) == getattr(j, f), f
    derived = ("num_states", "num_block_symbols", "points_per_symbol")
    assert [getattr(t, d) for d in derived] == [getattr(j, d) for d in derived]


@pytest.mark.parametrize("key", [k for k in KEYS if isinstance(k, str)
                                 and jcb.get_code(k).constraint_length <= 16])
def test_trellis_equal(key):
    j = jtr.build_trellis(jcb.get_code(key))
    t = ttr.build_trellis(tcb.get_code(key))
    for f in ("prev_state", "esym_prev", "next_state", "expected_symbol", "input_of"):
        assert np.array_equal(getattr(t, f), getattr(j, f)), f


def test_quirk_mask_equal_for_every_constraint_length():
    assert [ttr.quirk_mask_low(k) for k in range(2, 33)] == \
        [jtr.quirk_mask_low(k) for k in range(2, 33)]


@pytest.mark.parametrize("m", sorted(jcon._TABLES))
def test_constellations_equal(m):
    t, j = tcon.get_constellation(m), jcon.get_constellation(m)
    assert t.dtype == j.dtype == np.float32
    assert np.array_equal(t, j)
    assert tcon.min_sq_distance(m) == jcon.min_sq_distance(m)


def test_constellation_widths_equal():
    assert sorted(tcon._TABLES) == sorted(jcon._TABLES)
