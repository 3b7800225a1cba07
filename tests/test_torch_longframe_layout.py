"""PyTorch port, the layouts of the long-frame Monte-Carlo kernel (TPU
kernel 6, ``csrc/longframe_mc.cu``), modelled in plain torch at a small
size and held exactly (tolerance 0) against the plain chain's pieces:

* the decision scratch: only the words of rows t >= W stored, for S < 32
  ``P = 32 / S`` rows packed per word aligned to multiples of P
  (``window_chunk``, ``window_tail_row``), and the traceback's read of it
  (``tb_walk``) — its bits equal ``ops.viterbi.traceback_carry``'s;
* the payload's info bits stored 32 per word aligned to multiples of 32
  (``store_info_bit``) and the traceback's error count by popcount over
  whole words under the payload's mask, with its one-word-ahead loads
  (``tb_flush``) — equal to a plain count of mismatches;
* the thread groups of S >= 128 (``group_acs_step``, ``group_row``, the
  group argmin; ``threads_per_lane``): every state's ACS from the two predecessor threads'
  metrics, the decision words assembled across the threads that share
  them, and the (metric, state) argmin — equal to ``ops.viterbi.acs_scan``
  and ``first_argmin``, ties included;
* the BSC flip as an integer compare of the draw against
  ``flip_threshold`` — equal to the plain chain's float compare.

``mc_longframe_viterbi_ref`` and its tests (test_torch_fused_longframe.py)
are the chain's reference; this file pins what the kernel does differently.
"""

import numpy as np
import pytest
import torch

from convolutional_codes_tpu_torch.models.codebook import Code, get_code
from convolutional_codes_tpu_torch.models.tables import code_tables
from convolutional_codes_tpu_torch.ops.fused_longframe import (
    decision_scratch_shape, flip_threshold, info_scratch_shape, threads_per_lane)
from convolutional_codes_tpu_torch.ops.viterbi import (
    HARD_METRIC_SAT, acs_scan, traceback_carry)
from convolutional_codes_tpu_torch.utils.bitops import MASK32, first_argmin

CODES = {4: "k3-75", 8: "k4-r12", 16: "k5-r12", 64: "nasa-k7", 256: "k9-r12"}
#: no shipped code has 128 states: octal (247, 371), K = 8
K8 = Code(name="k8-r12", symlen_out=2, constraint_length=8, block_length=40,
          polynomials=(0b10100111, 0b11111001))
W, WN = 38, 37         # Tw = 113, payload rows 38 .. 74: no power of two divides W or Tw
LANES = 5


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """One intra-op thread, as test_torch_fused_longframe.py (ROADMAP Q3)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _code(S):
    code = K8 if S == 128 else get_code(CODES[S])
    assert code.num_states == S
    return code


def _decisions(S, T, B, seed):
    """Random packed decisions as acs_scan writes them: bits >= S are 0."""
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 2 ** 32, (T, (S + 31) // 32, B), dtype=np.uint64)
    if S < 32:
        words &= (1 << S) - 1
    return torch.as_tensor(words.astype(np.uint32).view(np.int32)).to(torch.int64) & MASK32


def _store(S, dec):
    """The forward pass's stores of dec [Tw, NW, lanes]: every row of an
    item that holds a row t >= W."""
    items, nw, lanes = decision_scratch_shape(S, WN, W, LANES)
    P = 32 // S if S < 32 else 1
    scratch = torch.zeros((items, nw, lanes), dtype=torch.int64)
    for t in range(W // P * P, dec.shape[0]):
        scratch[t // P - W // P] |= dec[t] << ((t % P) * S)
    return scratch


def _store_info(truth):
    """store_info_bit: the info bits [Tw, lanes] of the words that hold a
    payload row."""
    info = torch.zeros(info_scratch_shape(WN, W, LANES), dtype=torch.int64)
    for t in range(W // 32 * 32, truth.shape[0]):
        if t // 32 - W // 32 < info.shape[0]:
            info[t // 32 - W // 32] |= truth[t].to(torch.int64) << (t & 31)
    return info


def _popcount(x):
    return torch.tensor([bin(int(v)).count("1") for v in x])


def _walk(code, scratch, cur, info=None):
    """tb_walk from states cur [lanes] over rows Tw-1 .. W: (bits of rows
    W .. Tw-1 [Tw - W, lanes], payload errors against the stored info
    bits, or None)."""
    S, K, half = code.num_states, code.constraint_length, (code.num_states >> 1) - 1
    P = 32 // S if S < 32 else 1
    Tw = WN + 2 * W
    bits = torch.empty((Tw - W, LANES), dtype=torch.int32)
    err = torch.zeros(LANES, dtype=torch.int64)
    dacc = torch.zeros(LANES, dtype=torch.int64)
    if info is not None:
        jt = (W + WN - 1) // 32 - W // 32
        icur, inext = info[jt], info[jt - 1] if jt >= 1 else torch.zeros(LANES, dtype=torch.int64)
    for t in range(Tw - 1, W - 1, -1):
        word = torch.gather(scratch[t // P - W // P].T, 1, (cur >> 5)[:, None])[:, 0]
        d = (word >> ((t % P) * S + (cur & 31))) & 1
        ob = cur >> (K - 2)
        bits[t - W] = ob.to(torch.int32)
        if info is not None and t < W + WN:
            dacc |= ob << (t & 31)
            if t & 31 == 0 or t == W:   # tb_flush
                j = t >> 5
                lo, hi = max(W, 32 * j) - 32 * j, min(W + WN, 32 * j + 32) - 32 * j
                pmask = ((1 << hi) - 1) & ~((1 << lo) - 1)
                err += _popcount((dacc ^ icur) & pmask)
                dacc = torch.zeros_like(dacc)
                icur = inext
                jn = j - 2 - W // 32
                inext = info[jn] if jn >= 0 else torch.zeros(LANES, dtype=torch.int64)
        cur = ((cur & half) << 1) | d
    return bits, (err if info is not None else None)


def test_decision_scratch_shape():
    assert decision_scratch_shape(4, 1920, 128, 131072) == (256, 1, 131072)   # config 0
    assert decision_scratch_shape(64, 1920, 128, 65536) == (2048, 2, 65536)   # config 2
    assert decision_scratch_shape(2, 1920, 128, 7) == (128, 1, 7)
    assert decision_scratch_shape(32, 1920, 128, 7) == (2048, 1, 7)
    assert decision_scratch_shape(256, 1920, 128, 7) == (2048, 8, 7)
    assert decision_scratch_shape(4, WN, W, LANES) == (11, 1, LANES)   # rows 32 .. 119
    assert info_scratch_shape(1920, 128, 9) == (60, 9)
    assert info_scratch_shape(WN, W, 9) == (2, 9)                       # rows 32 .. 95


@pytest.mark.parametrize("S", [4, 8, 16, 64])
def test_packed_scratch_traceback_equals_plain(S):
    code = _code(S)
    Tw = WN + 2 * W
    dec = _decisions(S, Tw, LANES, S)
    start = torch.as_tensor(np.random.default_rng(S).integers(0, S, LANES))
    bits, _ = _walk(code, _store(S, dec), start.clone())
    bits_r, _ = traceback_carry(code, dec[W:].to(torch.int32), start)
    assert torch.equal(bits, bits_r.T)


@pytest.mark.parametrize("S", [4, 64])
def test_stored_info_bits_count_equals_plain(S):
    code = _code(S)
    Tw = WN + 2 * W
    dec = _decisions(S, Tw, LANES, 7 + S)
    rng = np.random.default_rng(S)
    start = torch.as_tensor(rng.integers(0, S, LANES))
    bits, _ = _walk(code, _store(S, dec), start.clone())
    truth = torch.as_tensor(rng.integers(0, 2, (Tw, LANES)))   # the stream's info bits
    truth[W:W + WN] = bits[:WN].to(torch.int64)
    flips = torch.as_tensor(rng.random((WN, LANES)) < 0.3)
    truth[W:W + WN][flips] ^= 1
    _, err = _walk(code, _store(S, dec), start.clone(), _store_info(truth))
    assert torch.equal(err, (bits[:WN].to(torch.int64) != truth[W:W + WN]).sum(0))
    assert int(err.sum()) > 0


def _group_step(code, m, bm, G, hard):
    """One ACS step laid out as the group kernel: thread r of G holds states
    r SPT + k; returns (new metrics [S, B], decision words [NW, B])."""
    S, B = m.shape
    SPT = S // G
    tables = code_tables(code)
    e0, e1 = tables.esym_prev[:, 0], tables.esym_prev[:, 1]
    new = torch.empty_like(m)
    thread_bits = []
    for r in range(G):
        q = 2 * (r % (G // 2))                          # predecessor threads q, q + 1
        pr = torch.cat([m[q * SPT:(q + 1) * SPT], m[(q + 1) * SPT:(q + 2) * SPT]])
        ns = torch.arange(r * SPT, (r + 1) * SPT)
        c0, c1 = pr[0::2] + bm[e0[ns]], pr[1::2] + bm[e1[ns]]
        if hard:
            c0, c1 = c0.clamp_max(HARD_METRIC_SAT), c1.clamp_max(HARD_METRIC_SAT)
        d = c1 < c0
        new[ns] = torch.where(d, c1, c0)
        w = (d.to(torch.int64) << torch.arange(SPT)[:, None]).sum(0)
        thread_bits.append(w << ((r * SPT) & 31))
    share = 32 // SPT                                   # OR across the word's threads
    words = [sum(thread_bits[r0:r0 + share]) for r0 in range(0, G, share)]
    return new, torch.stack(words)


def _group_argmin(m, G):
    """Within each thread first-strict-less, then the xor butterfly."""
    S, B = m.shape
    SPT = S // G
    best = [m[r * SPT:(r + 1) * SPT].amin(0) for r in range(G)]
    cur = [r * SPT + first_argmin(m[r * SPT:(r + 1) * SPT], dim=0) for r in range(G)]
    off = 1
    while off < G:
        nb, nc = [], []
        for r in range(G):
            ob, oc = best[r ^ off], cur[r ^ off]
            take = (ob < best[r]) | ((ob == best[r]) & (oc < cur[r]))
            nb.append(torch.where(take, ob, best[r]))
            nc.append(torch.where(take, oc, cur[r]))
        best, cur, off = nb, nc, off * 2
    assert all(torch.equal(c, cur[0]) for c in cur)
    return cur[0]


@pytest.mark.parametrize("hard", [False, True])
@pytest.mark.parametrize("S", [128, 256])
def test_group_acs_and_argmin_equal_plain(S, hard):
    code = _code(S)
    G = threads_per_lane(S)
    M, B, steps = code.points_per_symbol, 16, 6
    rng = np.random.default_rng(S + hard)
    m = torch.zeros((S, B))
    m_r = m.clone()
    for _ in range(steps):
        if hard:   # integer metrics: ties everywhere
            bm = torch.as_tensor(rng.integers(0, 3, (M, B)).astype(np.float32))
        else:
            bm = torch.as_tensor(rng.uniform(0, 4, (M, B)).astype(np.float32))
        m, words = _group_step(code, m, bm, G, hard)
        m_r, dec_r = acs_scan(code, bm[None], m_r, hard)
        assert torch.equal(m, m_r)
        assert torch.equal(words, dec_r[0].to(torch.int64) & MASK32)
    assert torch.equal(_group_argmin(m, G), first_argmin(m_r, dim=0))


@pytest.mark.parametrize("S,G", [(2, 1), (4, 1), (32, 1), (64, 1), (128, 4), (256, 8)])
def test_threads_per_lane(S, G):
    """One thread a lane up to S = 64, then 32 states a thread (the
    kernel's launch_longframe and cc_mc_longframe's check)."""
    assert threads_per_lane(S) == G


@pytest.mark.parametrize("param", [0.0125, 0.03, 0.05, 0.5, 1e-9, 1.0])
def test_flip_threshold_equals_uniform_compare(param):
    """The kernel's BSC flip, ``(bits >> 1) < flip_threshold(p)``, is the
    plain chain's ``coord_uniform(..) < p`` on every draw (near the
    threshold too)."""
    b0 = flip_threshold(param)
    rng = np.random.default_rng(1)
    half = np.concatenate([rng.integers(0, 2 ** 31, 4096),
                           np.clip(np.arange(b0 - 300, b0 + 300), 0, 2 ** 31 - 1)])
    bits = torch.as_tensor(half * 2 + rng.integers(0, 2, half.shape))   # any low bit
    u = (bits >> 1).to(torch.float32) * torch.tensor(2.0 ** -31) + torch.tensor(2.0 ** -32)
    assert torch.equal((bits >> 1) < b0, u < torch.tensor(param, dtype=torch.float32))
