"""PyTorch port, the Fano walk of ``csrc/fano_mc.cu`` (TPU kernels 8 and 10)
on the CPU: the algebra of its 16-byte node record, its launch plan, and
its wrappers' input checks.

The kernels keep per node only {state | selected << 31, nmetric, m0, m1},
m0/m1 the branch metrics by input bit, unsorted, and derive the rest:
``swap = m0 < m1`` (the comparison that sorted the branches), the decoded
bit ``swap ^ selected``, the selected metric ``m[decoded]`` and the
successor ``(state | decoded << (K-1)) >> 1``; nodes beyond the deepest
visit decode 0.  :func:`record_walk` is that walk, one frame at a time, in
Python ints and ``np.float32`` (each operation rounded as the kernels'
``-fmad=false`` code rounds it).  It is held exactly against the plain
machine ``ops/fano.fano_machine`` (bits, metric, timeout_left, depth,
iterations) and against the C reference's goldens.  The plain machine is a
lockstep loop of a few dozen tensor operations per micro-step on the CPU,
so the goldens whose walks take thousands of steps are held against it
under a smaller SEARCH budget (``tpb`` per bit) and against their decoded
bits at the full one.  :func:`straight_walk` is the kernels' one
straight-line iteration (both reads, every outcome, one committed by
selects), held equal to :func:`record_walk` at every iteration; the
successor's symbols from the state's parities are held equal to the
encoder's, and the records' [node][slot] layout to its banks.
"""

import numpy as np
import pytest
import torch

from conftest import load_golden
from convolutional_codes_tpu_torch.models.codebook import get_code, list_codes
from convolutional_codes_tpu_torch.models.tables import code_tables
from convolutional_codes_tpu_torch.ops import fano, fano_cuda, fano_mc
from convolutional_codes_tpu_torch.ops import mc_datagen as dg
from convolutional_codes_tpu_torch.ops.channels import awgn_sigma

torch.set_num_threads(2)

DELTA = np.float32(fano.FANO_DELTA)
SEL = 1 << 31
DIAG = ("metric", "timeout_left", "depth", "iters")


def branch_metrics_of(code, frame, soft):
    """``(t, state) -> (m0, m1)``: the branch metrics of inputs 0 and 1 from
    ``state`` at node ``t`` of ``frame``, in ``np.float32`` as the kernels
    compute them."""
    tables = code_tables(code)
    polys, qmask = [int(p) for p in tables.polynomials], int(tables.quirk_mask)
    K, symlen = code.constraint_length, code.symlen_out
    weight = np.float32(code.fano_metric_weight)
    correct, wrong = code.fano_bit_metrics

    def esym(reg):
        e = 0
        for poly in polys:
            x = reg & poly
            bit = bin(x).count("1") & 1
            if qmask:
                bit &= 1 - (bin(x & qmask).count("1") & 1)
            e = (e << 1) | bit
        return e

    def metric(t, e):
        if soft:
            return np.float32(1.0) + weight * frame[t, e]
        h = bin(e ^ int(frame[t])).count("1")
        return np.float32(h * wrong + (symlen - h) * correct)

    return lambda t, state: (metric(t, esym(state)), metric(t, esym(state | 1 << (K - 1))))


def decoded_bits(rec, deepest, L):
    """The bits the records decode: swap ^ selected, 0 beyond the deepest
    visit."""
    fv = rec.view(np.float32)
    return [(int(fv[t, 2] < fv[t, 3]) ^ int(rec[t, 0] >> 31)) if t <= deepest else 0
            for t in range(L)]


def run_steps(steps):
    """Drive a walk's generator to its end: its outputs."""
    while True:
        try:
            next(steps)
        except StopIteration as stop:
            return stop.value


def record_steps(code, frame, soft, timeout_per_bit):
    """One frame's Fano walk over node records ``rec [T, 4]`` uint32 (word 0
    state | selected << 31; words 1-3 nmetric, m0, m1 as float32 bits), the
    current node's record also held in locals as the kernels hold it in
    registers, as a tree of branches: a SEARCH, a BACKTRACK, or a failed
    SEARCH and its first BACKTRACK an iteration.  ``frame`` is [T, M]
    float32 distances or [T] received symbols.  Yields (state, selected,
    cur, threshold, budget left) before every iteration and once at the
    end; returns (bits [L], metric, timeout_left, depth, iterations)."""
    K, L, T = code.constraint_length, code.block_length, code.num_block_symbols
    branch_metrics = branch_metrics_of(code, frame, soft)
    rec = np.zeros((T, 4), np.uint32)
    fv = rec.view(np.float32)

    def put(t, w0, nm, m0, m1):
        rec[t, 0], fv[t, 1], fv[t, 2], fv[t, 3] = w0, nm, m0, m1

    state, sel, nm = 0, 0, np.float32(0.0)
    m0, m1 = branch_metrics(0, 0)
    put(0, 0, nm, m0, m1)
    cur = deepest = iters = 0
    timeout, thr, backtrack = timeout_per_bit * T, np.float32(0.0), False
    while True:
        yield state, sel, cur, thr, timeout
        iters += 1
        if not backtrack:
            if timeout == 0:
                break
            timeout -= 1
            dec = int(m0 < m1) ^ sel
            ms = nm + (m1 if dec else m0)
            if ms >= thr:
                if nm < thr + DELTA:
                    k = int(np.floor((ms - thr) / DELTA))
                    if ms >= thr + np.float32(k + 1) * DELTA:
                        k += 1
                    if ms < thr + np.float32(k) * DELTA:
                        k -= 1
                    thr = thr + np.float32(max(k, 0)) * DELTA
                if cur + 1 == T:
                    break
                state = (state | dec << (K - 1)) >> 1
                cur += 1
                deepest = max(deepest, cur)
                sel, nm = 0, ms
                m0, m1 = branch_metrics(cur, state)
                put(cur, state, nm, m0, m1)
                continue
            backtrack = True
        if cur > 0 and fv[cur - 1, 1] >= thr:
            cur -= 1
            w0 = int(rec[cur, 0])
            state, sel, nm, m0, m1 = w0 & ~SEL, w0 >> 31, fv[cur, 1], fv[cur, 2], fv[cur, 3]
            if sel == 0:
                sel = 1
                rec[cur, 0] = state | SEL
                backtrack = False
        else:
            thr = thr - DELTA
            if sel:
                sel = 0
                rec[cur, 0] = state
            backtrack = False
    yield state, sel, cur, thr, timeout
    return decoded_bits(rec, deepest, L), nm, timeout, cur, iters


def record_walk(code, frame, soft, timeout_per_bit):
    """:func:`record_steps`' outputs."""
    return run_steps(record_steps(code, frame, soft, timeout_per_bit))


def tighten(ms, thr):
    """The kernels' closed-form tightening: k0 = floor((ms - thr) / DELTA)
    and its two corrections, the three thresholds they can reach computed
    side by side."""
    k0 = int(np.floor((ms - thr) / DELTA))
    t_lo, t_k0, t_hi = (thr + np.float32(k0 - 1) * DELTA, thr + np.float32(k0) * DELTA,
                        thr + np.float32(k0 + 1) * DELTA)
    up = ms >= t_hi
    down = ms < (t_hi if up else t_k0)
    k = k0 + int(up) - int(down)
    t_k = (t_k0 if down else t_hi) if up else (t_lo if down else t_k0)
    return t_k if k > 0 else thr + np.float32(0) * DELTA


def straight_steps(code, frame, soft, timeout_per_bit):
    """The same walk as the kernels' one straight-line iteration: every
    iteration reads the successor's branch metrics and the previous node's
    record (the one 16-byte word ``rec[prev]``), computes each outcome's
    values and the tightened threshold, commits one outcome by selects and
    stores the whole record of the node it then stands on (unchanged where
    the outcome left it so).  Yields and returns as :func:`record_steps`."""
    K, L, T = code.constraint_length, code.block_length, code.num_block_symbols
    branch_metrics = branch_metrics_of(code, frame, soft)
    rec = np.zeros((T, 4), np.uint32)
    fv = rec.view(np.float32)
    state, sel, nm = 0, 0, np.float32(0.0)
    m0, m1 = branch_metrics(0, 0)
    rec[0, 0], fv[0, 1:] = 0, (nm, m0, m1)
    cur = deepest = iters = 0
    timeout, thr, backtrack, done = timeout_per_bit * T, np.float32(0.0), False, False
    while not done:
        yield state, sel, cur, thr, timeout
        # both reads first
        dec = int(m0 < m1) ^ sel
        nxt = (state | dec << (K - 1)) >> 1
        n0, n1 = branch_metrics(min(cur + 1, T - 1), nxt)
        prev = max(cur - 1, 0)
        p = rec[prev].copy()
        pv = p.view(np.float32)
        ms, pm = nm + (m1 if dec else m0), pv[1]
        # the outcome
        search = not backtrack
        spent = search and timeout == 0
        passed = search and not spent and ms >= thr
        last = passed and cur + 1 == T
        fwd = passed and not last
        bt = not spent and not passed
        back = bt and cur > 0 and pm >= thr
        relax = bt and not back
        tightened = tighten(ms, thr)
        thr = tightened if passed and nm < thr + DELTA else thr
        # commit by selects
        iters += 1
        timeout -= int(search and not spent)
        done = spent or last
        thr = thr - DELTA if relax else thr
        state = nxt if fwd else (int(p[0]) & ~SEL) if back else state
        sel = 0 if fwd or relax else 1 if back else sel
        nm = ms if fwd else pm if back else nm
        m0 = n0 if fwd else pv[2] if back else m0
        m1 = n1 if fwd else pv[3] if back else m1
        cur = cur + 1 if fwd else prev if back else cur
        deepest = max(deepest, cur)
        backtrack = back and bool(p[0] >> 31)
        rec[cur, 0], fv[cur, 1:] = state | sel << 31, (nm, m0, m1)
    yield state, sel, cur, thr, timeout
    return decoded_bits(rec, deepest, L), nm, timeout, cur, iters


def straight_walk(code, frame, soft, timeout_per_bit):
    """:func:`straight_steps`' outputs."""
    return run_steps(straight_steps(code, frame, soft, timeout_per_bit))


def assert_straight_equals_record(code, frame, soft, timeout_per_bit):
    """The straight-line walk equals the tree of branches at every
    iteration (state, selected, cur, threshold, budget left) and at the
    end; returns the outputs and the iterations where the walk relaxed at
    node 0."""
    a = record_steps(code, frame, soft, timeout_per_bit)
    b = straight_steps(code, frame, soft, timeout_per_bit)
    i = root_relax = 0
    prev = None
    while True:
        try:
            x = next(a)
        except StopIteration as stop:
            want = stop.value
            break
        y = next(b)
        assert x[:3] == y[:3] and x[4] == y[4] and np.float32(x[3]) == np.float32(y[3]), (i, x, y)
        if prev is not None and prev[2] == 0 == x[2] and x[3] < prev[3]:
            root_relax += 1
        prev, i = x, i + 1
    with pytest.raises(StopIteration) as stop:
        next(b)
    got = stop.value.value
    assert got[0] == want[0] and np.float32(got[1]) == np.float32(want[1]), i
    assert list(got[2:]) == list(want[2:]), i
    return got, root_relax


def assert_walks_equal_machine(code, syms, soft, tpb):
    """The record walk on every frame equals the plain machine's outputs."""
    bits, diag = fano.fano_machine(code, torch.as_tensor(syms), soft, tpb)
    for b in range(syms.shape[0]):
        got = record_walk(code, syms[b], soft, tpb)
        assert got[0] == bits[b].tolist(), b
        want = [diag[k][b].item() for k in DIAG]
        assert np.float32(got[1]) == np.float32(want[0]) and list(got[2:]) == want[1:], b
    return diag


#: the goldens the plain machine's tests decode (their walks end within
#: ~22,000 SEARCH steps), with the budget per bit the machine is held to
#: here: the full one where the slowest walk is short
SHORT_GOLDENS = [(f"fano_hard_{i}_m1", fano.FANO_TIMEOUT) for i in (0, 1, 2, 3, 5)] + [
    ("fano_hard_4_m1", 4), ("fano_soft_4_m1", 4), ("fano_soft_5_m1", 6)]


def _golden(name):
    g = load_golden(f"{name}.npz")
    code = get_code(0 if "fma" in name else int(name.split("_")[2]))
    soft = "dists" in g
    return g, code, (g["dists"] if soft else g["received"]), soft


@pytest.mark.parametrize("name,tpb", SHORT_GOLDENS)
def test_record_walk_on_goldens(name, tpb):
    g, code, x, soft = _golden(name)
    for b in range(x.shape[0]):
        assert record_walk(code, x[b], soft, fano.FANO_TIMEOUT)[0] == g["decoded"][b].tolist()
    assert_walks_equal_machine(code, x, soft, tpb)


def test_record_walk_on_fma_regression():
    """The frame whose walk takes 509,290 steps and whose bits change when a
    product is fused into its add: bit-exact at the full budget, and equal
    to the plain machine, diagnostics included, under a budget of 5."""
    g, code, x, soft = _golden("fano_fma_regression")
    assert record_walk(code, x[0], soft, fano.FANO_TIMEOUT)[0] == g["decoded"][0].tolist()
    diag = assert_walks_equal_machine(code, x, soft, 5)
    assert bool(diag["timed_out"].all())


@pytest.mark.parametrize("ck,channel,point,tpb", [
    (0, "awgn", 2.0, 4), (0, "bsc", 0.06, 30), (5, "awgn", 3.0, 6), (5, "bsc", 0.04, 3),
    ("wspr-k32", "awgn", 4.0, 3), ("wspr-k32", "bsc", 0.02, 15)], ids=str)
def test_record_walk_on_hash_frames(ck, channel, point, tpb):
    code = get_code(ck)
    param = float(awgn_sigma(point)) if channel == "awgn" else point
    _, syms = dg.frames_host(code, np.arange(16), 7, param, channel)
    diag = assert_walks_equal_machine(code, syms.numpy(), channel == "awgn", tpb)
    if tpb < 10:   # the small budgets are there to exhaust some walks
        assert bool(diag["timed_out"].any())


@pytest.mark.parametrize("name,tpb", SHORT_GOLDENS)
def test_straight_walk_on_goldens(name, tpb):
    """The straight-line iteration equals the tree of branches at every
    iteration of every golden frame at the full budget, and decodes the
    golden bits; under the budget the plain machine is held to, its
    diagnostics equal the machine's."""
    g, code, x, soft = _golden(name)
    for b in range(x.shape[0]):
        got, _ = assert_straight_equals_record(code, x[b], soft, fano.FANO_TIMEOUT)
        assert got[0] == g["decoded"][b].tolist()
    bits, diag = fano.fano_machine(code, torch.as_tensor(x), soft, tpb)
    for b in range(x.shape[0]):
        got = straight_walk(code, x[b], soft, tpb)
        assert got[0] == bits[b].tolist(), b
        assert np.float32(got[1]) == np.float32(diag["metric"][b].item()), b
        assert list(got[2:]) == [diag[k][b].item() for k in DIAG[1:]], b


@pytest.mark.parametrize("tpb", [fano.FANO_TIMEOUT, 5])
def test_straight_walk_on_fma_regression(tpb):
    """The frame whose bits change when a product is fused into its add:
    the straight-line iteration equals the tree of branches at every one of
    its iterations, at the full budget (the golden bits) and at 5 (a walk
    that exhausts its budget)."""
    g, code, x, soft = _golden("fano_fma_regression")
    got, _ = assert_straight_equals_record(code, x[0], soft, tpb)
    if tpb == fano.FANO_TIMEOUT:
        assert got[0] == g["decoded"][0].tolist()
    else:
        assert got[2] == 0


@pytest.mark.parametrize("ck,channel,point,tpb", [
    (0, "awgn", 2.0, 4), (0, "bsc", 0.06, 30), (5, "awgn", 3.0, 6), (5, "bsc", 0.04, 3),
    ("wspr-k32", "awgn", 4.0, 3), ("wspr-k32", "bsc", 0.02, 15)], ids=str)
def test_straight_walk_on_hash_frames(ck, channel, point, tpb):
    """The kernels' own frames (the coordinate hash), some walks exhausting
    their budget: equal to the tree of branches at every iteration."""
    code = get_code(ck)
    param = float(awgn_sigma(point)) if channel == "awgn" else point
    _, syms = dg.frames_host(code, np.arange(16), 7, param, channel)
    for frame in syms.numpy():
        assert_straight_equals_record(code, frame, channel == "awgn", tpb)


@pytest.mark.parametrize("bit_metrics", [(0, 0), (1, 1), (1, -1)])
def test_straight_walk_on_tie_heavy_hard_frames(bit_metrics):
    """Hard frames over 100 info bits whose branch metrics tie: all zero,
    so every SEARCH compares ms = thr and divides 0 (0, 0); equal at equal
    depth (1, 1); small integers (1, -1).  Equal to the tree of branches at
    every iteration, and to the plain machine at the end."""
    code = get_code(0).replace(name=f"k3-fano-ties-{bit_metrics}", fano_bit_metrics=bit_metrics,
                               block_length=100)
    rng = np.random.default_rng(11)
    rx = rng.integers(0, 4, (8, code.num_block_symbols)).astype(np.int32)
    bits, diag = fano.fano_machine(code, torch.as_tensor(rx), False, 20)
    for b, frame in enumerate(rx):
        got, _ = assert_straight_equals_record(code, frame, False, 20)
        assert got[0] == bits[b].tolist(), b
        assert list(got[2:]) == [diag[k][b].item() for k in DIAG[1:]], b


def test_straight_walk_relaxes_at_node_0():
    """A hard frame whose first received symbol is 11: both branches of
    node 0 lie below the threshold, so the walk relaxes at the root before
    its first move, twice; then random symbols.  Equal to the tree of
    branches at every iteration, and to the plain machine at the end."""
    code = get_code(0)
    rng = np.random.default_rng(5)
    rx = rng.integers(0, 4, (4, code.num_block_symbols)).astype(np.int32)
    rx[:, 0] = 3
    bits, diag = fano.fano_machine(code, torch.as_tensor(rx), False, 30)
    for b, frame in enumerate(rx):
        got, root_relax = assert_straight_equals_record(code, frame, False, 30)
        assert root_relax >= 2, b
        assert got[0] == bits[b].tolist(), b
        assert list(got[2:]) == [diag[k][b].item() for k in DIAG[1:]], b


LONG = get_code(0).replace(name="k3-r12-long", block_length=600)


@pytest.mark.parametrize("code", [c for k, c in list_codes().items() if isinstance(k, str)]
                         + [LONG], ids=lambda c: c.name)
def test_plan(code):
    """Every registered code and a frame too long for shared memory: the
    plan kernels 8 and 10 share, and the device-memory records it asks
    for."""
    T = code.num_block_symbols
    records = fano_mc.RECORD_BYTES * T
    plan = fano_mc.fano_plan(T)
    assert plan.threads % 32 == 0 and 32 <= plan.threads <= fano_mc.MAX_THREADS
    assert plan.smem_bytes <= fano_mc.SMEM_PER_BLOCK
    assert plan.nodes_shared == (32 * records <= fano_mc.SMEM_PER_BLOCK)
    if plan.nodes_shared:   # room for at least one resident block per SM
        assert plan.smem_bytes == plan.threads * records
        assert plan.smem_bytes + fano_mc.SMEM_RESERVED <= fano_mc.SMEM_PER_SM
    else:
        assert plan == fano_mc.FanoPlan(fano_mc.GLOBAL_THREADS, 0, False)
    assert plan.nodes_shared == (code is not LONG)
    scratch = fano_mc.node_scratch(plan, T, 3 * plan.threads, "cpu")
    assert scratch.numel() == (1 if plan.nodes_shared else 3 * plan.threads * 4 * T)


def successor_syms(polys, qmask, K, s1, dec):
    """The kernels' ``successor_syms``: the expected symbols of both branches
    out of the successor ``s1 | dec << (K - 2)`` of a state whose kept bits
    are ``s1``, from the parities of ``s1`` and masks of the two bits that
    enter (polynomial 0 at the MSB, as ``Encoder::rpoly`` reversed)."""
    top = K - 1
    rpoly = list(reversed(polys))
    ps = qs = pd = qd = pb = qb = 0
    for k, r in enumerate(rpoly):
        rq = r & qmask
        ps |= (bin(s1 & r).count("1") & 1) << k
        qs |= (bin(s1 & rq).count("1") & 1) << k
        pd |= (r >> (top - 1) & 1) << k
        qd |= (rq >> (top - 1) & 1) << k
        pb |= (r >> top & 1) << k
        qb |= (rq >> top & 1) << k
    p, q = (ps ^ pd, qs ^ qd) if dec else (ps, qs)
    return p & ~q, (p ^ pb) & ~(q ^ qb)


@pytest.mark.parametrize("code", [c for k, c in list_codes().items() if isinstance(k, str)],
                         ids=lambda c: c.name)
def test_successor_syms_equal_the_encoder(code):
    """Both branches' expected symbols out of a successor, without waiting
    for the decoded bit, equal the encoder's on random states (the quirk
    included, and K = 32)."""
    tables = code_tables(code)
    polys, qmask = [int(p) for p in tables.polynomials], int(tables.quirk_mask)
    K = code.constraint_length
    rng = np.random.default_rng(K)
    for state in list(rng.integers(0, 1 << (K - 1), 200)) + [0, (1 << (K - 1)) - 1]:
        for dec in (0, 1):
            nxt = (int(state) | dec << (K - 1)) >> 1
            want = []
            for bit in (0, 1):
                reg, e = nxt | bit << (K - 1), 0
                for poly in polys:
                    x = reg & poly
                    b = bin(x).count("1") & 1
                    if qmask:
                        b &= 1 - (bin(x & qmask).count("1") & 1)
                    e = (e << 1) | b
                want.append(e)
            assert successor_syms(polys, qmask, K, int(state) >> 1, dec) == tuple(want)


def record_offset(t, slot, stride):
    """Byte offset of node ``t``'s 16-byte record of slot ``slot``: the
    layout [node][slot], ``stride`` records a node (the block's threads in
    shared memory, the grid's slots in device memory)."""
    return 16 * (t * stride + slot)


@pytest.mark.parametrize("code", [c for k, c in list_codes().items() if isinstance(k, str)]
                         + [LONG], ids=lambda c: c.name)
def test_record_layout(code):
    """Every record of a block (shared) or a grid (device memory) has its
    own 16-byte-aligned place inside the plan's memory, and the 32 lanes of
    a warp at 32 different depths read their records in the least
    wavefronts: each quarter warp on 8 distinct 16-byte bank groups."""
    T = code.num_block_symbols
    plan = fano_mc.fano_plan(T)
    blocks = 3
    stride = plan.threads if plan.nodes_shared else blocks * plan.threads
    size = (plan.smem_bytes if plan.nodes_shared
            else 4 * fano_mc.node_scratch(plan, T, stride, "cpu").numel())
    offsets = {record_offset(t, s, stride) for t in range(T) for s in range(stride)}
    assert len(offsets) == T * stride and max(offsets) + 16 <= size
    assert all(o % 16 == 0 for o in offsets)
    rng = np.random.default_rng(T)
    for warp in range(stride // 32):
        depths = rng.choice(T, size=32, replace=T < 32)
        if T >= 32:
            assert len(set(depths)) == 32
        groups = [record_offset(int(t), warp * 32 + lane, stride) // 16 % 8
                  for lane, t in enumerate(depths)]
        for quarter in range(4):
            assert len(set(groups[8 * quarter:8 * quarter + 8])) == 8
        assert all(groups.count(g) == 4 for g in range(8))


@pytest.mark.parametrize("T,shared", [(454, True), (455, False)])
def test_plan_threshold_is_454_nodes(T, shared):
    assert fano_mc.fano_plan(T).nodes_shared == shared


def test_wrappers_reject_cpu_tensors_and_wrong_shapes():
    code = get_code(0)
    decode = fano_cuda.fano_decode_cuda
    with pytest.raises(ValueError, match="CUDA"):
        decode(code, torch.zeros((2, 42), dtype=torch.int32), False)
    with pytest.raises(ValueError, match="CUDA"):
        decode(code, torch.zeros((2, 42, 4)), True)
    for x, soft in ((torch.zeros((2, 42)), True), (torch.zeros((2, 42, 4)), False),
                    (torch.zeros((2, 41)), False), (torch.zeros((0, 42)), False)):
        with pytest.raises(ValueError, match="must be"):
            decode(code, x, soft)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        fano_mc.mc_fano(code, 32, 1, 0, 0.05, "bsc", device="meta")
    with pytest.raises(ValueError, match="2\\^31"):
        fano_mc.mc_fano(code, 1 << 16, 1 << 15, 0, 0.05, "bsc", device="cuda")
    with pytest.raises(ValueError, match="lanes > 0"):
        fano_mc.mc_fano(code, 0, 1, 0, 0.05, "bsc", device="cuda")
