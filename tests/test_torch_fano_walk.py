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
bits at the full one.
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


def record_walk(code, frame, soft, timeout_per_bit):
    """One frame's Fano walk over node records ``rec [T, 4]`` uint32 (word 0
    state | selected << 31; words 1-3 nmetric, m0, m1 as float32 bits), the
    current node's record also held in locals as the kernels hold it in
    registers.  ``frame`` is [T, M] float32 distances or [T] received
    symbols.  Returns (bits [L], metric, timeout_left, depth, iterations)."""
    tables = code_tables(code)
    polys, qmask = [int(p) for p in tables.polynomials], int(tables.quirk_mask)
    K, L, T, symlen = (code.constraint_length, code.block_length, code.num_block_symbols,
                       code.symlen_out)
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

    def branch_metrics(t, state):   # (m0, m1): the branches of inputs 0 and 1
        return metric(t, esym(state)), metric(t, esym(state | 1 << (K - 1)))

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
    bits = [(int(fv[t, 2] < fv[t, 3]) ^ int(rec[t, 0] >> 31)) if t <= deepest else 0
            for t in range(L)]
    return bits, nm, timeout, cur, iters


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
