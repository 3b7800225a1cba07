"""PyTorch port, the decode of supplied frames
(``parallel/streaming.long_frame_decode_stream``, kernels 4-5's plain
versions on the CPU): held bit for bit against the benchmark's plain
reference (``benchmark/reference/decode.py``, which imports nothing of the
port) on seeded received K=7 frames, soft and hard; its spans
``decode_layout``, ``decode_acs`` and ``decode_traceback`` and its
counters ``decode_frames``, ``decode_symbols``, ``decode_chain_steps``
and ``decode_pair_steps`` record under a profiler session, and nothing
records without one.

Tolerances: none, bits exactly (the same float32 additions in the same
order, strict-less compares on both sides).
"""

import json
import os
import sys

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from convolutional_codes_tpu_torch.models.codebook import get_code
from convolutional_codes_tpu_torch.parallel.streaming import long_frame_decode_stream
from convolutional_codes_tpu_torch.utils import profiling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from benchmark.reference import decode as ref  # noqa: E402
from benchmark.reference.common import CodeSpec, popcount32, seq_frames  # noqa: E402

CPU = torch.device("cpu")
#: 3 frames of 300 info bits: T = 306, not a power of two; 4 dB as the cell
WL = {"frames": 3, "info_bits": 300, "point": 4.0}
SPANS = ("decode_layout", "decode_acs", "decode_traceback")


def _config() -> dict:
    with open(os.path.join(REPO, "benchmark", "configs", "nasa-k7-rx.json")) as f:
        return json.load(f)


@pytest.fixture(autouse=True)
def _no_counters():
    profiling.reset_counters()
    yield
    profiling.reset_counters()


def _received(seed: int, index: int = 0):
    cfg = _config()
    return ref.received_batch(CodeSpec.from_config(cfg), cfg, WL, seed, index, CPU)


@pytest.mark.parametrize("seed", [5, 2 ** 31 + 11])
def test_soft_decode_equals_the_reference(seed):
    """Every frame's T = 306 decoded bits, the tail's included, equal the
    plain float32 full-frame Viterbi of the same distances."""
    sent, dists = _received(seed)
    assert dists.shape == (3, 306, 4) and dists.dtype == torch.float32
    got = long_frame_decode_stream(get_code("nasa-k7"), dists)
    want = ref.decode(CodeSpec.from_config(_config()), dists)
    assert got.shape == (3, 306) and got.dtype == torch.int32
    assert torch.equal(got.to(torch.int64), want)
    assert ref.frames_off(got, want) == 0
    assert float((got[:, :300] != sent).float().mean()) < 0.2


def test_hard_decode_equals_the_reference():
    """The BSC's saturating metrics: Hamming distances of received symbols
    at p = 0.05, against ``acs_traceback(hard=True)``."""
    cfg = dict(_config(), channel="bsc")
    code = ref.frame_code(CodeSpec.from_config(cfg), WL)
    _, rx = seq_frames(code, cfg, torch.arange(4), 23, 0.05)
    e = torch.arange(code.points_per_symbol)
    bm = popcount32(rx[..., None] ^ e).to(torch.float32)                # [4, T, M]
    got = long_frame_decode_stream(get_code("nasa-k7"), bm, hard=True)
    want = ref.decode(code, bm, hard=True)
    assert got.shape == (4, 306)
    assert torch.equal(got.to(torch.int64), want)


def test_a_frame_differing_in_one_bit_is_off():
    _, dists = _received(9)
    want = ref.decode(CodeSpec.from_config(_config()), dists)
    got = want.clone()
    got[1, 17] ^= 1
    assert ref.frames_off(got, want) == 1
    assert ref.frames_off(got[:2], want) == 2
    assert ref.frames_off(torch.zeros_like(want), want) == 3


def _inside(inner: dict, outer: dict) -> bool:
    return (inner["tid"] == outer["tid"] and outer["ts"] <= inner["ts"]
            and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"])


def test_spans_nest_and_counters_count_each_call(tmp_path):
    """Under an outer session and span, each call opens the three spans in
    order inside the outer one, and adds B, B x T and T."""
    _, dists = _received(3)
    _, more = _received(3, index=1)
    code = get_code("nasa-k7")
    with profiling.trace(str(tmp_path)):
        with profiling.annotate("outer"):
            long_frame_decode_stream(code, dists)
            long_frame_decode_stream(code, more[:2, :200].contiguous())
    (path,) = tmp_path.glob("*.pt.trace.json")
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    (outer,) = [e for e in events if e["name"] == "outer"]
    spans = sorted((e for e in events if e["name"] in SPANS), key=lambda e: e["ts"])
    assert [e["name"] for e in spans] == list(SPANS) * 2
    assert all(_inside(e, outer) for e in spans)
    assert all(a["ts"] + a["dur"] <= b["ts"] for a, b in zip(spans, spans[1:]))
    assert profiling.counters() == {"decode_frames": 3 + 2,
                                    "decode_symbols": 3 * 306 + 2 * 200,
                                    "decode_chain_steps": 306 + 200,
                                    "decode_pair_steps": 153 + 100}


def test_hard_path_counts_under_a_session():
    cfg = dict(_config(), channel="bsc")
    code = ref.frame_code(CodeSpec.from_config(cfg), WL)
    _, rx = seq_frames(code, cfg, torch.arange(2), 4, 0.05)
    bm = popcount32(rx[..., None] ^ torch.arange(4)).to(torch.float32)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        long_frame_decode_stream(get_code("nasa-k7"), bm, hard=True)
    names = [e.name for e in prof.events()]
    assert all(names.count(s) == 1 for s in SPANS)
    assert profiling.counters() == {"decode_frames": 2, "decode_symbols": 2 * 306,
                                    "decode_chain_steps": 306, "decode_pair_steps": 153}


@pytest.mark.parametrize("key,T", [("nasa-k7", 101), ("nasa-k7", 102), ("k3-75", 101),
                                   ("k9-r12", 102)])
def test_pair_steps_count_kernel_4s_exchanges(key, T):
    """``decode_pair_steps`` adds T // 2 a call at S = 64 (kernel 4's
    two-step body), odd T and even, and 0 for a code of 4 or 256 states."""
    code = get_code(key)
    dists = torch.rand((2, T, code.points_per_symbol), generator=torch.Generator().manual_seed(T))
    with profile(activities=[ProfilerActivity.CPU]):
        long_frame_decode_stream(code, dists)
        long_frame_decode_stream(code, dists[:1])
    want = 2 * (T // 2) if code.num_states == 64 else 0
    assert profiling.counters()["decode_pair_steps"] == want
    assert profiling.counters()["decode_chain_steps"] == 2 * T


def test_no_session_records_nothing(monkeypatch):
    """Without a profiler session no span opens (``record_function`` is
    never called) and no counter moves."""
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) without a session")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    _, dists = _received(7)
    out = long_frame_decode_stream(get_code("nasa-k7"), dists)
    assert out.shape == (3, 306)
    assert profiling.counters() == {}
