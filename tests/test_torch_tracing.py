"""PyTorch port, the port's spans and counters (``utils/profiling.py``):
the launches and read-backs of every leg of ``run_sweep`` are spans
(``mc_launch``, ``mc_readback``) inside their ``sweep_point_<p>``, the
preamble and a point's record are ``sweep_plan`` and ``sweep_record``;
``walk_iters`` sums the walks' iteration rows; ``stream_windows`` and
``stream_positions`` count the stream leg's plan; the walk kernels' clock
words stay pending on the device until ``counters()`` reads them; a
point's two slices add their overlap and the cold slice's longest walk.  All of
it records only under a profiler session: without one, nothing opens a
span or moves a counter.  On the CPU the traces hold host activity only.
"""

import contextlib
import json
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from convolutional_codes_tpu_torch.models.codebook import get_code
from convolutional_codes_tpu_torch.ops.fano_mc import mc_fano_ref
from convolutional_codes_tpu_torch.ops.sequential_common import walk_clock
from convolutional_codes_tpu_torch.ops.stack_mc import mc_stack_ref
from convolutional_codes_tpu_torch.parallel import seq_grid
from convolutional_codes_tpu_torch.parallel.mesh import make_mesh
from convolutional_codes_tpu_torch.parallel.seq_grid import seq_mc_grid
from convolutional_codes_tpu_torch.sim.sweep import SweepSpec, run_sweep
from convolutional_codes_tpu_torch.utils import profiling

CPU = torch.device("cpu")

#: one BSC point of each leg of ``run_sweep``, and the spans it opens
LEGS = {
    "fused": (dict(code=0, decoder="viterbi"), {"mc_launch", "mc_readback"}),
    "sequential": (dict(code=0, decoder="stack"), {"mc_launch", "mc_readback"}),
    # T > 256 turns the fused kernel away: the step chain under sharded_accumulate
    "modular": (dict(code=get_code("k3-75").replace(name="k3-75-long", block_length=300),
                     decoder="viterbi"), {"mc_readback"}),
    # long streaming frames: kernel 6's plain version, windows of 32 + 2 x 16
    "stream": (dict(code="nasa-k7", decoder="viterbi", stream_window=32, stream_warmup=16),
               {"mc_launch", "mc_readback"}),
}


def _leg_spec(leg: str, **kw) -> SweepSpec:
    return SweepSpec(channel="bsc", points=[0.002], frames_per_step=64, bits_per_point=2e3,
                     seed=3, **LEGS[leg][0], **kw)


@pytest.fixture(autouse=True)
def _no_counters():
    profiling.reset_counters()
    yield
    profiling.reset_counters()


def _trace_events(trace_dir) -> list:
    """The complete events of the one trace file under ``trace_dir``."""
    (path,) = trace_dir.glob("*.pt.trace.json")
    with open(path) as f:
        return [ev for ev in json.load(f)["traceEvents"] if ev.get("ph") == "X"]


def _inside(inner: dict, outer: dict) -> bool:
    return (inner["tid"] == outer["tid"] and outer["ts"] <= inner["ts"]
            and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"])


@pytest.mark.parametrize("leg", sorted(LEGS))
def test_leg_spans_nest_under_their_point(tmp_path, leg):
    """A traced point of each leg: its launches and read-backs are spans
    inside ``sweep_point_<p>`` on the same host thread."""
    run_sweep(_leg_spec(leg, trace_dir=str(tmp_path)), verbose=False, device="cpu")
    events = _trace_events(tmp_path / "point_0.002")
    (point,) = [e for e in events if e["name"] == "sweep_point_0.002"]
    spans = [e for e in events if e["name"] in ("mc_launch", "mc_readback")]
    assert {e["name"] for e in spans} == LEGS[leg][1]
    assert all(_inside(e, point) for e in spans)


def test_plan_and_record_spans_under_an_outer_session(tmp_path):
    """Under a session around the whole sweep, as the benchmark's traced
    runs open: ``sweep_plan`` ends before the point starts, and the point's
    record follows it."""
    with profiling.trace(str(tmp_path)):
        run_sweep(_leg_spec("fused"), verbose=False, device="cpu")
    events = _trace_events(tmp_path)
    (plan,), (point,), (record,) = ([e for e in events if e["name"] == name]
                                    for name in ("sweep_plan", "sweep_point_0.002",
                                                 "sweep_record"))
    assert plan["ts"] + plan["dur"] <= point["ts"] <= point["ts"] + point["dur"] <= record["ts"]


@pytest.mark.parametrize("leg", sorted(LEGS))
def test_no_session_records_nothing(monkeypatch, leg):
    """Without a profiler session no span opens (``record_function`` is
    never called) and no counter moves; ``annotate`` is one shared no-op."""
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) without a session")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    (rec,) = run_sweep(_leg_spec(leg), verbose=False, device="cpu")
    assert rec.bits >= 2e3
    assert profiling.counters() == {}
    assert profiling.annotate("a") is profiling.annotate("b")
    with walk_clock(CPU) as clock:
        assert clock is None


def test_stream_counters_equal_the_plan():
    """A traced stream point of 9 windows (a cold launch of 1, then 8):
    ``stream_windows`` is lanes x windows and ``stream_positions`` each
    launch's lanes x (windows x window + 2 x warmup), exactly; both
    launches' counters come back in one read (``mc_reads``)."""
    spec = _leg_spec("stream", trace_dir=None)
    spec.bits_per_point = 64 * 32 * 9
    with profile(activities=[ProfilerActivity.CPU]):
        (rec,) = run_sweep(spec, verbose=False, device="cpu")
    assert rec.frames == 64 * 9
    assert profiling.counters() == {"stream_windows": 64 * 9,
                                    "stream_positions": 64 * (1 * 32 + 32) + 64 * (8 * 32 + 32),
                                    "mc_reads": 1}


@pytest.mark.parametrize("decoder", ["stack", "fano"])
def test_walk_iters_equal_the_plain_rows(monkeypatch, decoder):
    """``walk_iters`` is the sum of the iteration rows of the plain walks
    (``mc_stack_ref`` / ``mc_fano_ref``, what the grid launches on the
    CPU), exactly."""
    code = get_code(0)
    ref = {"stack": mc_stack_ref, "fano": mc_fano_ref}[decoder]
    rows = []

    def plain(*args, **kwargs):
        kwargs.pop("device")
        rows.append(ref(*args, **kwargs)[2])
        return torch.stack([torch.zeros_like(rows[-1])] * 2 + [rows[-1]])

    monkeypatch.setattr(seq_grid, f"mc_{decoder}", plain)
    kw = {"timeout_per_bit": 40} if decoder == "fano" else {}
    mesh = make_mesh({"frames": 2}, devices=[CPU] * 2)
    with profile(activities=[ProfilerActivity.CPU]):
        seq_mc_grid(decoder, code, 32, [(2, [12])], [0.02], mesh, channel="bsc", **kw)
    assert len(rows) == 2 and int(sum(r.sum() for r in rows)) >= 32 * 2 * code.num_block_symbols
    assert profiling.counters() == {"walk_iters": int(sum(r.sum() for r in rows))}


def test_pending_counters_resolve_only_in_counters():
    """Device words stay pending through the session: they are read, once,
    when ``counters()`` is called, with what the kernel wrote last."""
    reads = []

    def span_ns(w):
        reads.append(w.clone())
        return w[2] - w[0]

    words = torch.tensor([5, 7, 11])
    profiling.count_later(words, ignored=span_ns)        # no session: dropped
    with profile(activities=[ProfilerActivity.CPU]):
        profiling.count_later(words, launch=span_ns)
        profiling.count("iters", 3)
        words[2] = 20                                    # the kernel ends later
    assert reads == []
    assert profiling.counters() == {"launch": 15, "iters": 3}
    assert len(reads) == 1 and reads[0].tolist() == [5, 7, 20]
    assert profiling.counters() == {"launch": 15, "iters": 3}
    assert len(reads) == 1
    profiling.reset_counters()
    assert profiling.counters() == {}


def test_walk_clock_while_tracing(monkeypatch):
    """A walk launch's clock words start as {~0, 0} (atomicMin, atomicMax);
    the events around the launch give ``walk_launch_ns`` and the words
    ``walk_tail_ns``, both read only in ``counters()``."""
    class Event:   # torch.cuda.Event's interface: record, elapsed_time in ms
        def __init__(self, enable_timing):
            self.at = None

        def record(self):
            self.at = len(recorded)
            recorded.append(self)

        def elapsed_time(self, end):
            return 0.0005 * (end.at - self.at)

    recorded = []
    monkeypatch.setattr(torch.cuda, "Event", Event)
    with profile(activities=[ProfilerActivity.CPU]):
        with walk_clock(CPU) as clock:
            assert clock.tolist() == [-1, 0] and len(recorded) == 1
            clock.copy_(torch.tensor([250, 400]))            # what a kernel writes
        assert len(recorded) == 2
    assert profiling.counters() == {"walk_launch_ns": 500, "walk_tail_ns": 150}


def _slow_entry(code, lanes, frames_per_lane, seed, param, **kwargs):
    """A kernel entry that takes a millisecond a frame a lane."""
    time.sleep(1e-3 * frames_per_lane)
    return torch.zeros((3, lanes), dtype=torch.int64)


@pytest.mark.parametrize("traced", [False, True])
def test_walk_overlap_counters_only_while_tracing(monkeypatch, traced):
    """Two slices a slot add ``walk_cold_ns`` (the first slice's time) and
    ``walk_overlap_ns`` (both in flight) under a session, and nothing
    without one; one slice adds neither.  On the CPU the plain versions run
    inside the call, one slice after the other: no overlap."""
    monkeypatch.setattr(seq_grid, "mc_stack", _slow_entry)
    mesh = make_mesh({"frames": 2}, devices=[CPU] * 2)
    session = profile(activities=[ProfilerActivity.CPU]) if traced else contextlib.nullcontext()
    with session:
        seq_mc_grid("stack", get_code(0), 32, [(2, [12])], [0.02], mesh, channel="bsc")
        assert profiling.counters().keys() == ({"walk_iters"} if traced else set())
        cold, warm = seq_mc_grid("stack", get_code(0), 32, [(2, [12]), (3, [13])], [0.02],
                                 mesh, channel="bsc")
    got = profiling.counters()
    if not traced:
        assert got == {}
        return
    assert got["walk_overlap_ns"] == 0
    # two slots, each at least its 2 ms and at most the cold slice's time
    assert 2 * 2e6 <= got["walk_cold_ns"] <= 2 * cold.seconds * 1e9 + 1
    assert warm.seconds >= 2 * 3e-3


@pytest.mark.parametrize("traced", [False, True])
def test_walk_cold_max_iters_only_while_tracing(monkeypatch, traced):
    """Under a session, each slot of a point with two slices adds the most
    iterations of a lane of its cold slice (one frame a lane: its longest
    walk's), from the plain Fano walks; without a session nothing, and one
    slice adds nothing."""
    rows = []

    def plain(*args, **kwargs):
        kwargs.pop("device")
        rows.append(mc_fano_ref(*args, **kwargs)[2])
        return torch.stack([torch.zeros_like(rows[-1])] * 2 + [rows[-1]])

    monkeypatch.setattr(seq_grid, "mc_fano", plain)
    mesh = make_mesh({"frames": 2}, devices=[CPU] * 2)
    session = profile(activities=[ProfilerActivity.CPU]) if traced else contextlib.nullcontext()
    # a budget of 2 T: walks at p = 0.05 reach it, and the plain walks
    # stay short under the profiler, which records each of their operations
    kw = dict(channel="bsc", timeout_per_bit=2)
    with session:
        seq_mc_grid("fano", get_code(0), 32, [(2, [12])], [0.05], mesh, **kw)
        assert "walk_cold_max_iters" not in profiling.counters()
        rows.clear()
        seq_mc_grid("fano", get_code(0), 32, [(1, [12]), (2, [13])], [0.05], mesh, **kw)
    got = profiling.counters()
    if not traced:
        assert got == {}
        return
    cold = rows[0::2]   # each slot launches its cold slice first
    assert len(rows) == 4 and all(r.numel() == 16 for r in rows)
    assert got["walk_cold_max_iters"] == sum(int(r.max()) for r in cold)
    assert got["walk_cold_max_iters"] > 2 * get_code(0).num_block_symbols


@pytest.mark.cuda
def test_walk_overlap_within_the_cold_launch_on_a_card():
    """On a card the warm slice runs beside the cold one: 0 <= overlap <=
    the cold launch's time, on the sequential cell's shape of code 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the walk kernels have no CPU mode)")
    dev = torch.device("cuda", 0)
    mesh = make_mesh({"frames": 1}, devices=[dev])
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        seq_mc_grid("fano", get_code(0), 8192, [(1, [3]), (2, [4])], [0.05], mesh,
                    channel="bsc", timeout_per_bit=100)
    got = profiling.counters()
    assert 0 <= got["walk_overlap_ns"] <= got["walk_cold_ns"] and got["walk_cold_ns"] > 0
