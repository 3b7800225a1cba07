"""PyTorch port, the stack walk of ``csrc/stack_mc.cu`` (TPU kernels 7 and 9)
on the CPU: its slot layout, its pick of the best and worst slot, its
writes, its launch plan, the banking of kernel 7's counters and the count
of the pick's operations in chip_smoke.py's bound.

The kernels keep a walk's 64 slots as words: a metric per slot, a node
word per slot (next-symbol index and encoder state, ``nii << (K-1) |
state`` where they fit one word, else two words), and the path's L info
bits in 32-bit words per slot.  An iteration picks best = the first max and
worst = the first min of the live metrics from the first max and min kept
for each of 8 groups of 8 slots with their slots; a write rescans the
groups it touched with a tree of strict compares (:func:`block_max_min`,
held to the serial scan on tie-heavy metrics);
extends best, the input-1 duplicate written first;
and at capacity replaces worst, where best == worst keeps only the input-0
write.  :func:`slot_walk` is that walk, one frame at a time, in Python ints
and float32 values (each add rounded as the kernels' ``-fmad=false``
code rounds it), with the groups' pick taken at every iteration and held
equal to a serial scan.
It is held exactly against the plain machine ``ops/stack.stack_machine``
(bits, metric, iterations) and against the C reference's goldens.
"""

import glob
import importlib.util
import os
import random

import numpy as np
import pytest
import torch

from conftest import GOLDENS as GOLDEN_DIR, load_golden
from convolutional_codes_tpu_torch.models.codebook import get_code
from convolutional_codes_tpu_torch.models.tables import code_tables
from convolutional_codes_tpu_torch.ops import mc_datagen as dg
from convolutional_codes_tpu_torch.ops import stack, stack_mc
from convolutional_codes_tpu_torch.ops.channels import awgn_sigma
from convolutional_codes_tpu_torch.ops.sequential_common import SMEM_PER_BLOCK, SMEM_PER_SM

torch.set_num_threads(2)

DEPTH, GROUP = stack.STACK_DEPTH, 8


def metric_table(code, frame, soft):
    """[T][2^m] branch metrics of one frame as Python floats holding float32
    values: soft ``1 + fl(w * d)``, hard ``h * wrong + (symlen - h) * correct``."""
    if soft:
        d = np.asarray(frame, np.float32)
        return (np.float32(1.0) + np.float32(code.metric_weight) * d).tolist()
    correct, wrong = code.bit_metrics
    M, symlen = code.points_per_symbol, code.symlen_out
    h = [[bin(e ^ int(r)).count("1") for e in range(M)] for r in frame]
    return [[float(x * wrong + (symlen - x) * correct) for x in row] for row in h]


def f32_add(a, b):
    """a + b rounded to float32 (the double sum of two float32 values rounds
    to the same float32 as the float32 add)."""
    return float(np.float32(a + b))


def serial_max_min(met, lo, hi):
    """The first max and the first min of met[lo:hi] by a serial scan with
    strict compares: the picks the plain machine makes."""
    b = c = lo
    for s in range(lo + 1, hi):
        if met[s] > met[b]:
            b = s
        if met[s] < met[c]:
            c = s
    return b, c


def block_max_min(met, lo, hi):
    """The kernels' scan of slots [lo, hi), lo a multiple of 8: blocks of 8
    slots, a tree of strict compares in each (slots past hi at -inf for the
    max, +inf for the min), a block taking over only if strictly better."""
    b = c = lo
    mb, mw = -np.inf, np.inf
    for base in range(lo, hi, GROUP):
        vb = [met[s] if s < hi else -np.inf for s in range(base, base + GROUP)]
        vc = [met[s] if s < hi else np.inf for s in range(base, base + GROUP)]
        ib, ic = list(range(base, base + GROUP)), list(range(base, base + GROUP))
        step = 1
        while step < GROUP:
            for k in range(0, GROUP, 2 * step):
                if vb[k + step] > vb[k]:
                    vb[k], ib[k] = vb[k + step], ib[k + step]
                if vc[k + step] < vc[k]:
                    vc[k], ic[k] = vc[k + step], ic[k + step]
            step *= 2
        if vb[0] > mb:
            mb, b = vb[0], ib[0]
        if vc[0] < mw:
            mw, c = vc[0], ic[0]
    return b, c


def slot_walk(code, frame, soft, stats=None):
    """One frame's walk over the kernels' slot words.  Returns (bits [L],
    metric, iterations); ``stats`` (a dict) counts the iterations at
    capacity and those in the alias corner."""
    tables = code_tables(code)
    polys, qmask = [int(p) for p in tables.polynomials], int(tables.quirk_mask)
    K, L, T = code.constraint_length, code.block_length, code.num_block_symbols
    plan = stack_mc.code_plan(code)
    top, nw = K - 1, -(-L // 32)
    mask = (1 << top) - 1
    metrics = metric_table(code, frame, soft)

    def esym(reg):
        e = 0
        for poly in polys:
            x = reg & poly
            bit = bin(x).count("1") & 1
            if qmask:
                bit &= 1 - (bin(x & qmask).count("1") & 1)
            e = (e << 1) | bit
        return e

    e_in = esym(1 << top)
    met = [0.0] * DEPTH
    words = [0] * (DEPTH * (1 if plan.pack else 2))
    bits = [0] * (DEPTH * nw)
    gbest, gworst = [0] * (DEPTH // GROUP), [0] * (DEPTH // GROUP)
    gmax, gmin = [0.0] * (DEPTH // GROUP), [0.0] * (DEPTH // GROUP)

    def node(s):
        if plan.pack:
            assert words[s] < 1 << 32
            return words[s] >> top, words[s] & mask
        return words[s], words[DEPTH + s]

    def set_node(s, t, state):
        if plan.pack:
            words[s] = t << top | state
        else:
            words[s], words[DEPTH + s] = t, state

    def group_pick(nstack):   # the groups' kept values, later groups only if strictly better
        gb = gc = 0
        for g in range(1, -(-nstack // GROUP)):
            if gmax[g] > gmax[gb]:
                gb = g
            if gmin[g] < gmin[gc]:
                gc = g
        return gbest[gb], gworst[gc]

    def rescan(g, nstack):
        gbest[g], gworst[g] = block_max_min(met, g * GROUP, min(g * GROUP + GROUP, nstack))
        gmax[g], gmin[g] = met[gbest[g]], met[gworst[g]]

    nstack, widx, iters = 1, 1, 0
    set_node(0, 0, 0)
    while True:
        iters += 1
        best, worst = serial_max_min(met, 0, nstack)
        assert group_pick(nstack) == (best, worst), iters
        t, state = node(best)
        if t == widx:
            if widx == T:
                break
            widx += 1
        mb = met[best]
        e0 = esym(state)   # true parity is linear: e1 = e0 ^ e_in
        e1 = esym(state | 1 << top) if qmask else e0 ^ e_in
        tm0, tm1 = metrics[t][e0], metrics[t][e1]
        at_cap = nstack >= DEPTH
        dup = worst if at_cap else nstack
        if stats is not None:
            stats["cap"] += at_cap
            stats["alias"] += dup == best
        if dup != best:
            for k in range(nw):
                bits[k * DEPTH + dup] = bits[k * DEPTH + best] | (
                    1 << (t & 31) if k == t >> 5 else 0)
            set_node(dup, t + 1, (state | 1 << top) >> 1)
            met[dup] = f32_add(mb, tm1)
        set_node(best, t + 1, state >> 1)
        met[best] = f32_add(mb, tm0)
        if not at_cap:
            nstack += 1
        rescan(best // GROUP, nstack)
        if dup // GROUP != best // GROUP:
            rescan(dup // GROUP, nstack)
    out = [bits[(t >> 5) * DEPTH + best] >> (t & 31) & 1 for t in range(L)]
    return out, met[best], iters


@pytest.mark.parametrize("levels", [2, 5, 1000])
def test_block_scan_picks_the_serial_scans_slots(levels):
    """The tree of strict compares over blocks of 8 (each group's rescan, and
    the same tree over the groups' kept values) picks the serial scan's
    slots on 64 metrics drawn from
    ``levels`` values (ties everywhere at 2), for every live count and for
    every group."""
    rng = np.random.default_rng(levels)
    for _ in range(300):
        met = rng.integers(-levels, levels, DEPTH).astype(np.float32).tolist()
        for hi in range(1, DEPTH + 1):
            assert block_max_min(met, 0, hi) == serial_max_min(met, 0, hi)
            lo = (hi - 1) // GROUP * GROUP
            assert block_max_min(met, lo, hi) == serial_max_min(met, lo, hi)


def assert_walks_equal_machine(code, syms, soft, stats=None):
    """The slot walk on every frame equals the plain machine's outputs."""
    bits, metric, iters = stack.stack_machine(code, torch.as_tensor(syms), soft)
    for b in range(syms.shape[0]):
        got = slot_walk(code, syms[b], soft, stats)
        assert got[0] == bits[b].tolist(), b
        assert np.float32(got[1]) == metric[b].item() and got[2] == int(iters[b]), b
    return bits


GOLDENS = sorted(os.path.basename(p)[:-4]
                 for p in glob.glob(os.path.join(GOLDEN_DIR, "stack_*.npz")))


@pytest.mark.parametrize("name", GOLDENS)
def test_slot_walk_on_goldens(name):
    g = load_golden(f"{name}.npz")
    code = get_code(int(name.split("_")[2]))
    soft = "dists" in g
    x = g["dists"] if soft else g["received"]
    bits = assert_walks_equal_machine(code, x, soft)
    assert np.array_equal(bits.numpy(), g["decoded"])


def test_goldens_are_all_there():
    assert len(GOLDENS) == 24


@pytest.mark.parametrize("bit_metrics", [(0, 0), (1, 1), (1, -1)])
def test_slot_walk_on_tie_heavy_hard_frames(bit_metrics):
    """Hard frames over 100 info bits whose live metrics tie: all equal at
    every step (0, 0), equal at equal depth (1, 1), or small integers
    (1, -1).  The walks reach capacity, and with all metrics equal the
    alias corner (best == worst)."""
    code = get_code(0).replace(name=f"k3-ties-{bit_metrics}", bit_metrics=bit_metrics,
                               block_length=100)
    rng = np.random.default_rng(11)
    rx = rng.integers(0, 4, (12, code.num_block_symbols)).astype(np.int32)
    stats = {"cap": 0, "alias": 0}
    assert_walks_equal_machine(code, rx, False, stats)
    assert stats["cap"] > 0
    assert (stats["alias"] > 0) == (bit_metrics == (0, 0))


@pytest.mark.parametrize("ck,channel,point", [
    (0, "awgn", 3.0), (0, "bsc", 0.06), ("k9-r12", "awgn", 2.0),
    ("wspr-k32", "awgn", 4.0), ("wspr-k32", "bsc", 0.03)], ids=str)
def test_slot_walk_on_hash_frames(ck, channel, point):
    """Kernel 7's own frames (the coordinate hash), on a packed and an
    unpacked (K = 32) node word."""
    code = get_code(ck)
    param = float(awgn_sigma(point)) if channel == "awgn" else point
    _, syms = dg.frames_host(code, np.arange(8), 7, param, channel)
    assert_walks_equal_machine(code, syms.numpy(), channel == "awgn")


#: (code, T, K, packed node word, path-bit words a slot, path bits shared,
#: threads per block, walks per SM)
PLANS = [(0, 42, 3, True, 2, True, 32, 192), ("k9-r12", 108, 9, True, 4, True, 32, 128),
         ("k15-r14-16qam", 214, 15, True, 7, True, 32, 96),
         ("wspr-k32", 81, 32, False, 2, True, 32, 160)]


@pytest.mark.parametrize("ck,T,K,pack,nw,shared,threads,walks", PLANS, ids=str)
def test_plan(ck, T, K, pack, nw, shared, threads, walks):
    code = get_code(ck)
    assert (code.num_block_symbols, code.constraint_length) == (T, K)
    plan = stack_mc.code_plan(code)
    assert (plan.pack, plan.bits_shared, plan.threads) == (pack, shared, threads)
    assert plan.pack == ((K - 1) + T.bit_length() <= 32)
    per_slot = 4 * (stack_mc.ON_CHIP_WORDS + DEPTH * (1 if pack else 2) + DEPTH * nw)
    assert stack_mc.bit_words(T, K) == DEPTH * nw
    assert plan.smem_bytes == threads * per_slot <= SMEM_PER_BLOCK
    assert stack_mc.resident_slots(threads, per_slot) == walks
    assert stack_mc.walk_scratch(plan, code, 3 * threads, "cpu").numel() == 1


def test_plan_puts_long_frames_in_device_memory():
    """Past 32 walks' path bits a block, the bits go to device memory and
    the node words stay on chip."""
    long = get_code(0).replace(name="k3-r12-long", block_length=900)
    plan = stack_mc.code_plan(long)
    assert not plan.bits_shared and plan.pack
    assert plan.smem_bytes == plan.threads * 4 * (stack_mc.ON_CHIP_WORDS + DEPTH)
    assert plan.smem_bytes + 1024 <= SMEM_PER_SM
    scratch = stack_mc.walk_scratch(plan, long, 5 * plan.threads, "cpu")
    assert scratch.numel() == 5 * plan.threads * DEPTH * 29
    edge = max(T for T in range(42, 2000) if stack_mc.stack_plan(T, 3).bits_shared)
    assert 32 * 4 * (stack_mc.ON_CHIP_WORDS + DEPTH + stack_mc.bit_words(edge, 3)) \
        <= SMEM_PER_BLOCK < 32 * 4 * (stack_mc.ON_CHIP_WORDS + DEPTH
                                      + stack_mc.bit_words(edge + 32, 3))


def test_counters_do_not_depend_on_banking_order():
    """Kernel 7 adds each ended frame's errors to lane gid // fpl with
    integer atomics in whatever order frames end: the plain machine's
    per-frame results banked in a shuffled order give the plain version's
    [3, lanes]."""
    code, lanes, fpl, seed, p = get_code(0), 24, 3, 5, 0.06
    gids = torch.arange(lanes * fpl)
    bits, syms = dg.frames_host(code, gids, seed, p, "bsc")
    dec, _, iters = stack.stack_machine(code, syms, False)
    err = (dec != bits[:, :code.block_length]).sum(dim=1)
    order = list(range(lanes * fpl))
    random.Random(3).shuffle(order)
    out = torch.zeros((3, lanes), dtype=torch.int64)
    for f in order:
        row = f // fpl
        if err[f]:
            out[0, row] += err[f]
            out[1, row] += 1
        out[2, row] += iters[f]
    want = stack_mc.mc_stack_ref(code, lanes, fpl, seed, p, "bsc")
    assert torch.equal(out, want) and int(want[0].sum()) > 0


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(__file__), os.pardir, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_pick_bound_is_the_least_over_frames():
    """chip_smoke's count of the pick's operations (``stack_pick_ops``, the
    bound of kernels 7 and 9): per walk the sum over its iterations of a
    tree over the live groups and a rescan of one group's live slots, and
    on kernel 7's per-lane sums of ``fpl`` walks never more than the walks'
    own counts, equal where they all walk as long."""
    cs = _chip_smoke()
    o = cs.STACK_OPS

    def walk(n_iters):
        return sum(o["pick_group"] * -(-min(i, DEPTH) // GROUP) + o["pick"]
                   + o["pick_slot"] * min(i, GROUP) for i in range(1, n_iters + 1))

    walks = [1, 2, 7, 8, 9, 63, 64, 65, 300, 4087]
    assert cs.stack_pick_ops(torch.tensor(walks), 1) == sum(map(walk, walks))
    assert walk(64 + 10) - walk(64) == 10 * (o["pick_group"] * 8 + o["pick"] + o["pick_slot"] * 8)
    rng = np.random.default_rng(4)
    for fpl in (2, 3, 16):
        per_frame = rng.integers(1, 400, (32, fpl))
        lanes = torch.tensor(per_frame.sum(1))
        exact = sum(walk(int(n)) for n in per_frame.ravel())
        assert cs.stack_pick_ops(lanes, fpl) <= exact
        even = torch.full((32,), 70 * fpl)
        assert cs.stack_pick_ops(even, fpl) == pytest.approx(32 * fpl * walk(70), rel=1e-12)
