"""PyTorch port, the layouts of the Viterbi ACS kernels, modelled in plain
torch at a small size and held exactly (tolerance 0) against the plain
versions and the JAX package's interpret-mode kernels:

* TPU kernel 4 (and kernel 1, which launches it), ``csrc/longframe.cu``
  ``stream_acs_kernel``, as the kernel does it (``stream_acs_lanes``): one
  thread a butterfly j of a frame's H = S/2, new states j and j + H; the
  decisions by two ballots a warp (64/S frames a warp below S = 64, their
  bits cut out of the warp's ballot; S/64 warps a frame above, a word each);
  the new metrics to their readers by two shuffles from S = 8 to 32 (each
  lane sends first its first, then its second new state if even, the other
  order if odd; ``shuffle_sources``), by four below, through shared memory
  from S = 128.  At S = 64 with M = 2-16 the two-step body
  (``stream_acs_pairs``): two trellis steps per exchange of four shuffles
  (``pair_lanes``), raw ballots turned into words on the way out
  (``pair_words``), and one radix-2 step where a chunk's steps are odd.
  Equal, bit for bit, to ``stream_acs_ref`` and to ``stream_acs_pallas``;
* TPU kernel 3, ``csrc/fused_chain.cu`` ``mc_chain_kernel``: the expected
  symbol from the packed 64-bit register table (``pack_esym_table``), the BSC
  flip as an integer compare against ``flip_threshold``, decisions packed
  32/S rows a word for S < 32, the info bits stored 32 a word, and the
  traceback that counts errors a word at a time.  Equal to
  ``mc_chain_viterbi_ref``'s counters and to the pinned interpret-mode BSC
  counters (``fused_interp_counters.npz``).
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from convolutional_codes_tpu.models.codebook import get_code as jax_code
from convolutional_codes_tpu.models.trellis import build_trellis
from convolutional_codes_tpu.ops import longframe_pallas as jlp
from convolutional_codes_tpu_torch.models.codebook import Code, get_code
from convolutional_codes_tpu_torch.models.tables import code_tables
from convolutional_codes_tpu_torch.ops import fused_chain as fc
from convolutional_codes_tpu_torch.ops import longframe_cuda as lc
from convolutional_codes_tpu_torch.ops.fused_chain import flip_threshold
from convolutional_codes_tpu_torch.ops.viterbi import BIG_METRIC, HARD_METRIC_SAT
from convolutional_codes_tpu_torch.utils.bitops import MASK32, first_argmin

#: no shipped code has 128 states: octal (247, 371), K = 8
K8 = Code(name="k8-r12", symlen_out=2, constraint_length=8, block_length=40,
          polynomials=(0b10100111, 0b11111001))
CODES = {4: "k3-75", 8: "k4-r12", 16: "k5-r12", 32: "k6-r12", 64: "nasa-k7", 256: "k9-r12"}


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


# ---------------------------------------------------------------- kernel 4
def shuffle_sources(H):
    """The kernel's two-shuffle exchange (S = 8 to 64, H = S/2 threads a
    frame): (src1, src2, lo, odd) per thread j.  Thread j reads m[2j] and m[2j+1]; for 2j < H they
    are the first new states of lanes 2j and 2j+1, else the second new
    states of lanes 2j-H and 2j-H+1."""
    j = torch.arange(H)
    lo, odd = 2 * j < H, (j & 1).bool()
    src1 = torch.where(lo, 2 * j, (2 * j + 1) & (H - 1))
    src2 = torch.where(lo, 2 * j + 1, (2 * j) & (H - 1))
    return src1, src2, lo, odd


#: lanes whose V holds their high state l + 32 (bit 1 of the lane set)
PAIR_SWAP = 0xCCCCCCCC


def pair_lanes():
    """The two-step body's lane map (S = 64, M = 2-16): lane l = 16h + k
    holds the metrics of states sv = l or l + 32 (l + 32 where bit 1 of l is
    set) in V and sw = sv ^ 32 in W, and takes ancestors 4k .. 4k+3 in four
    shuffle rounds, rounds 0-1 from V and 2-3 from W.  Returns (sv, sw,
    hi, order, src): ``order[r]`` the ancestor (0-3) lane l receives in
    round r, ``src[r]`` its source lane."""
    lane = torch.arange(32)
    k = lane & 15
    hi = k >= 8
    sv = torch.where((lane & 2) != 0, lane + 32, lane)
    order = [torch.where(hi, (r + 2) & 3, torch.full_like(lane, r)) for r in range(4)]
    src = [4 * (k & 7) + order[r] for r in range(4)]
    return sv, sv ^ 32, hi, order, src


def _spread16(x):
    """The low 16 bits of x to the even bits of a word."""
    x = x & 0xFFFF
    for shift, mask in ((8, 0x00FF00FF), (4, 0x0F0F0F0F), (2, 0x33333333), (1, 0x55555555)):
        x = (x | (x << shift)) & mask
    return x


def pair_words(a, b, intermediate):
    """The copy-out's words 0 and 1 of a row from its two raw ballots:
    (X, Y) of the intermediate step, interleaved (word h, bit 2k: state 2k +
    32h, lane 16h + k's X; bit 2k+1: state 2k + 32h + 1, its Y), or (V, W)
    of a final step (word 0, bit l: V of lane l unless bit 1 of l is set,
    then W)."""
    if intermediate:
        return [_spread16(a >> 16 * h) | (_spread16(b >> 16 * h) << 1) for h in (0, 1)]
    keep = 0xFFFFFFFF ^ PAIR_SWAP
    return [(a & keep) | (b & PAIR_SWAP), (b & keep) | (a & PAIR_SWAP)]


def _ballot(pred):
    """[32, B] bools -> [B] int64 words, lane l at bit l."""
    return (pred.to(torch.int64) << torch.arange(32)[:, None]).sum(0)


def stream_acs_pairs(code, d, init, hard, chunk):
    """Model of ``stream_acs_kernel`` at S = 64 and M = 2-16: chunks of
    ``chunk`` steps; in each, two trellis steps per exchange (pair_lanes),
    then, where the chunk's steps are odd, one radix-2 step from the same
    V/W layout; raw ballots staged a row and turned into words by
    pair_words.  Lanes 8-15 of a half take X's ancestors in rounds 2-3 and
    Y's in rounds 0-1, and select them so.  Returns (fm [64, B], dec [T, 2,
    B] int64)."""
    T, M, B = d.shape
    sv, sw, hi, order, src = pair_lanes()
    tables = code_tables(code)
    e0, e1 = tables.esym_prev[:, 0], tables.esym_prev[:, 1]
    lane = torch.arange(32)
    sx = 2 * (lane & 15) + 32 * (lane >> 4)           # X; Y = X + 1
    hi_ = hi[:, None]

    def acs(m0, m1, row, s):
        c0, c1 = m0 + row[e0[s]], m1 + row[e1[s]]
        if hard:
            c0, c1 = c0.clamp_max(HARD_METRIC_SAT), c1.clamp_max(HARD_METRIC_SAT)
        dd = c1 < c0
        return torch.where(dd, c1, c0), dd

    V, W = init[sv], init[sw]                          # [32, B]
    dec = torch.zeros((T, 2, B), dtype=torch.int64)
    for t0 in range(0, T, chunk):
        steps = min(chunk, T - t0)
        for p in range(steps // 2):
            t = t0 + 2 * p
            R = [(V if r < 2 else W)[src[r]] for r in range(4)]
            X, dX = acs(torch.where(hi_, R[2], R[0]), torch.where(hi_, R[3], R[1]), d[t], sx)
            Y, dY = acs(torch.where(hi_, R[0], R[2]), torch.where(hi_, R[1], R[3]), d[t],
                        sx + 1)
            V, dV = acs(X, Y, d[t + 1], sv)
            W, dW = acs(X, Y, d[t + 1], sw)
            for row, (a, b), inter in ((t, (dX, dY), True), (t + 1, (dV, dW), False)):
                dec[row] = torch.stack(pair_words(_ballot(a), _ballot(b), inter))
        if steps & 1:
            # radix-2: lane j takes m[2j], m[2j+1] in two shuffles, each
            # lane sending V or W by the parity of bit 0 ^ bit 1
            t, j = t0 + steps - 1, lane
            lo2 = (2 * j < 32)[:, None]
            src1 = torch.where(lo2[:, 0], 2 * j, (2 * j + 1) & 31)
            src2 = torch.where(lo2[:, 0], 2 * j + 1, (2 * j) & 31)
            swap = (((lane ^ (lane >> 1)) & 1) != 0)[:, None]
            r1 = torch.where(swap, W, V)[src1]
            r2 = torch.where(swap, V, W)[src2]
            m0, m1 = torch.where(lo2, r1, r2), torch.where(lo2, r2, r1)
            V, dV = acs(m0, m1, d[t], sv)
            W, dW = acs(m0, m1, d[t], sw)
            dec[t] = torch.stack(pair_words(_ballot(dV), _ballot(dW), False))
    fm = torch.zeros((64, B))
    fm[sv], fm[sw] = V, W
    return fm, dec


def pair_chunk(M):
    """``AcsChunk<64, M>::CH``: steps staged a chunk."""
    return max(1, 8 * 32 // M)


def stream_acs_lanes(code, d_tmb, init, hard):
    """Model of ``stream_acs_kernel``: at S = 64 and M = 2-16 the two-step
    body (``stream_acs_pairs``); otherwise per thread j of each frame the
    metrics m0 = m[2j], m1 = m[2j+1], one butterfly a step, the ballots of
    the warp cut into the ``[T, nwords, B]`` words, the exchange by two
    shuffles (S = 8 to 64), four (S < 8) or shared memory.  Returns (fm [S,
    B], dec)."""
    S = code.num_states
    H = S // 2
    if S == 64 and code.points_per_symbol <= 16:
        fm, dec = stream_acs_pairs(code, d_tmb, init, hard, pair_chunk(code.points_per_symbol))
        return fm, torch.where(dec >= 2 ** 31, dec - 2 ** 32, dec).to(torch.int32)
    FPB, NW = max(1, 32 // H), (S + 31) // 32
    T, M, B = d_tmb.shape
    Bp = -(-B // FPB) * FPB                          # whole blocks, padded frames zero
    d = torch.zeros((T, M, Bp))
    d[:, :, :B] = d_tmb
    m = torch.zeros((S, Bp))
    m[:, :B] = init
    tables = code_tables(code)
    e0, e1 = tables.esym_prev[:, 0], tables.esym_prev[:, 1]
    j = torch.arange(H)
    m0, m1 = m[2 * j], m[2 * j + 1]                  # [H, Bp]
    src1, src2, lo, odd = shuffle_sources(H) if 4 <= H <= 32 else (None,) * 4
    s0, s1 = (2 * j) % H, (2 * j + 1) % H              # four shuffles: source lanes
    lane = (torch.arange(Bp) % FPB)[None, :] * H + j[:, None]    # lane in the warp
    dec = torch.zeros((T, NW, Bp), dtype=torch.int64)
    for t in range(T):
        c0a, c1a = m0 + d[t][e0[j]], m1 + d[t][e1[j]]
        c0b, c1b = m0 + d[t][e0[j + H]], m1 + d[t][e1[j + H]]
        if hard:
            c0a, c1a, c0b, c1b = (c.clamp_max(HARD_METRIC_SAT) for c in (c0a, c1a, c0b, c1b))
        da, db = c1a < c0a, c1b < c0b
        na, nb = torch.where(da, c1a, c0a), torch.where(db, c1b, c0b)
        if H < 32:
            # the warp's ballots over its FPB frames, frame f's bits cut out
            blk = torch.arange(Bp) // FPB
            for ballot, shift in ((da, 0), (db, H)):
                raw = torch.zeros(Bp // FPB, dtype=torch.int64).index_add_(
                    0, blk, (ballot.to(torch.int64) << lane).sum(0))
                f = torch.arange(Bp) % FPB
                dec[t, 0] |= ((raw[blk] >> (f * H)) & ((1 << H) - 1)) << shift
        else:
            # warp k holds states 32k.. (word k) and H + 32k.. (word H/32 + k)
            for k in range(H // 32):
                rows = slice(32 * k, 32 * k + 32)
                bit = torch.arange(32)[:, None]
                dec[t, k] = (da[rows].to(torch.int64) << bit).sum(0)
                dec[t, H // 32 + k] = (db[rows].to(torch.int64) << bit).sum(0)
        if 4 <= H <= 32:
            send1 = torch.where(odd[:, None], nb, na)
            send2 = torch.where(odd[:, None], na, nb)
            r1, r2 = send1[src1], send2[src2]
            m0 = torch.where(lo[:, None], r1, r2)
            m1 = torch.where(lo[:, None], r2, r1)
        elif H < 4:
            m0 = torch.where((2 * j < H)[:, None], na[s0], nb[s0])
            m1 = torch.where((2 * j + 1 < H)[:, None], na[s1], nb[s1])
        else:
            mx = torch.cat([na, nb])                 # shared memory, [S, Bp]
            m0, m1 = mx[2 * j], mx[2 * j + 1]
    fm = torch.cat([na, nb])
    dec = torch.where(dec >= 2 ** 31, dec - 2 ** 32, dec).to(torch.int32)
    return fm[:, :B], dec[:, :, :B]


def _stream_inputs(code, T, B, hard, seed):
    rng = np.random.default_rng(seed)
    S, M = code.num_states, code.points_per_symbol
    if hard:   # integer Hamming metrics from the pinned start: ties everywhere
        d = rng.integers(0, code.symlen_out + 1, (T, M, B)).astype(np.float32)
        init = np.full((S, B), float(HARD_METRIC_SAT), np.float32)
        init[0] = 0.0
    else:
        d = rng.uniform(0.0, 8.0, (T, M, B)).astype(np.float32)
        init = rng.uniform(0.0, 8.0, (S, B)).astype(np.float32)
    return d, init


@pytest.mark.parametrize("S", [4, 8, 16, 32, 64, 128, 256])
@pytest.mark.parametrize("hard,T", [(False, 37), (True, 38)])
def test_stream_acs_lanes_equal_plain(S, hard, T):
    """Soft from random start metrics at an odd T, tie-heavy hard from the
    pinned start; B = 5 leaves a partial block below S = 64."""
    code = _code(S)
    d, init = _stream_inputs(code, T, 5, hard, S + hard)
    fm, dec = stream_acs_lanes(code, torch.as_tensor(d), torch.as_tensor(init), hard)
    fm_r, dec_r = lc.stream_acs_ref(code, torch.as_tensor(d), torch.as_tensor(init), hard)
    assert torch.equal(fm, fm_r)
    assert torch.equal(dec, dec_r)


@pytest.mark.parametrize("key,hard", [("nasa-k7", False), ("nasa-k7", True), ("k3-75", True)])
def test_stream_acs_lanes_equal_pallas(key, hard):
    """The model against the JAX package's interpret-mode stream_acs_pallas
    (as test_torch_longframe.py runs it): S = 64, one frame a warp, soft and
    tie-heavy hard, and S = 4, sixteen frames a warp."""
    code = get_code(key)
    B, T = 4, 33
    d, init = _stream_inputs(code, T, B, hard, 5)
    if not hard:
        init = np.full((code.num_states, B), BIG_METRIC, np.float32)
        init[0] = 0.0
    fm_j, dec_j = jlp.stream_acs_pallas(build_trellis(jax_code(key)), jnp.asarray(d),
                                        jnp.asarray(init), hard, chunk=T, interpret=True)
    fm, dec = stream_acs_lanes(code, torch.as_tensor(d), torch.as_tensor(init), hard)
    assert np.array_equal(fm.numpy(), np.asarray(fm_j))
    assert np.array_equal(dec.numpy(), np.asarray(dec_j))


@pytest.mark.parametrize("S", [8, 16, 32, 64])
def test_shuffle_sources_deliver_predecessors(S):
    """Each thread's two shuffles (lanes taken mod H, as a shuffle of width
    H does) bring it new states 2j and 2j+1 of S, from the lanes that hold
    them, in the order those lanes send."""
    H = S // 2
    src1, src2, lo, odd = shuffle_sources(H)
    holds = lambda lane, first: lane if first else lane + H       # first: na
    for j in range(H):
        s1, s2 = int(src1[j]) % H, int(src2[j]) % H
        got1 = holds(s1, not bool(odd[s1]))          # an even lane sends na first
        got2 = holds(s2, bool(odd[s2]))
        want = (2 * j % S, (2 * j + 1) % S)
        assert (got1, got2) == (want if lo[j] else want[::-1])


#: K = 7 codes of M = 2, 8 and 16 points (rates 1/1, 1/3, 1/4), beside
#: nasa-k7's 4: one instance of the two-step body each
K7_BY_M = {2: Code(name="k7-r11", symlen_out=1, constraint_length=7, block_length=40,
                   polynomials=(0o171,)),
           4: get_code("nasa-k7"),
           8: Code(name="k7-r13", symlen_out=3, constraint_length=7, block_length=40,
                   polynomials=(0o133, 0o171, 0o165)),
           16: Code(name="k7-r14", symlen_out=4, constraint_length=7, block_length=40,
                    polynomials=(0o117, 0o127, 0o155, 0o171))}


@pytest.mark.parametrize("M", [2, 4, 8, 16])
@pytest.mark.parametrize("hard", [False, True])
@pytest.mark.parametrize("odd", [False, True])
def test_pair_lanes_equal_plain(M, hard, odd):
    """The two-step body against the plain ACS over two whole chunks and a
    last one of 3 or 4 steps (one radix-2 step where the steps are odd):
    soft from random start metrics, tie-heavy hard from the pinned start."""
    code = K7_BY_M[M]
    assert (code.num_states, code.points_per_symbol) == (64, M)
    T = 2 * pair_chunk(M) + 3 + (not odd)
    d, init = _stream_inputs(code, T, 3, hard, 7 * M + hard)
    fm, dec = stream_acs_lanes(code, torch.as_tensor(d), torch.as_tensor(init), hard)
    fm_r, dec_r = lc.stream_acs_ref(code, torch.as_tensor(d), torch.as_tensor(init), hard)
    assert torch.equal(fm, fm_r)
    assert torch.equal(dec, dec_r)


def test_pair_rounds_deliver_ancestors():
    """Each round brings lane 16h + k one of ancestors 4k .. 4k+3 (all four
    over the rounds, lanes 8-15 of a half in the order 2, 3, 0, 1), from
    the lane and register (V in rounds 0-1, W in 2-3) that hold it, and no
    source lane is asked for two states in one round."""
    sv, sw, hi, order, src = pair_lanes()
    for r in range(4):
        held = (sv if r < 2 else sw)[src[r]]          # what each source sends
        for lane in range(32):
            k = lane & 15
            assert int(held[lane]) == 4 * k + int(order[r][lane])
        asked = {}
        for lane in range(32):
            asked.setdefault(int(src[r][lane]), set()).add(int(held[lane]))
        assert all(len(states) == 1 for states in asked.values())
    for lane in range(32):
        got = [int(order[r][lane]) for r in range(4)]
        assert got == ([2, 3, 0, 1] if lane & 8 else [0, 1, 2, 3])
    assert torch.equal(hi, (torch.arange(32) & 8) != 0)
    assert sum(1 << i for i in range(32) if sv[i] >= 32) == PAIR_SWAP
    assert sorted(torch.cat([sv, sw]).tolist()) == list(range(64))


def test_pair_words_interleave_intermediate_ballots():
    """An intermediate row's words: bit 2k of word h is state 2k + 32h, lane
    16h + k's X, bit 2k+1 state 2k + 32h + 1, its Y; a final row's bit l of
    word 0 is state l, in V unless bit 1 of l is set."""
    rng = np.random.default_rng(3)
    sv = pair_lanes()[0]
    for _ in range(8):
        a, b = (int(x) for x in rng.integers(0, 2 ** 32, 2))
        dA = [(a >> l) & 1 for l in range(32)]
        dB = [(b >> l) & 1 for l in range(32)]
        state = {}
        for lane in range(32):
            k, h = lane & 15, lane >> 4
            state[2 * k + 32 * h], state[2 * k + 32 * h + 1] = dA[lane], dB[lane]
        want = [sum(state[32 * w + i] << i for i in range(32)) for w in (0, 1)]
        assert pair_words(a, b, True) == want
        state = {}
        for lane in range(32):
            state[int(sv[lane])], state[int(sv[lane]) ^ 32] = dA[lane], dB[lane]
        want = [sum(state[32 * w + i] << i for i in range(32)) for w in (0, 1)]
        assert pair_words(a, b, False) == want


# ---------------------------------------------------------------- kernel 3
def pack_esym_table(code):
    """acs.cuh's pack_esym_table: (the expected symbol of every K-bit
    register, symlen bits each, packed into one int, and whether
    2^K symlen <= 64)."""
    K, SL = code.constraint_length, code.symlen_out
    if (1 << K) * SL > 64:
        return 0, False
    tables = code_tables(code)
    tab = 0
    for reg in range(1 << K):
        esym = 0
        for poly in tables.polynomials[:SL]:
            x = reg & poly
            bit = bin(x).count("1") & 1
            if tables.quirk_mask:
                bit &= 1 - (bin(x & tables.quirk_mask).count("1") & 1)
            esym = (esym << 1) | bit
        tab |= esym << (reg * SL)
    return tab, True


def _esym_of(code, reg):
    """fused_chain.cuh's esym_of: from the packed table where it applies,
    else by popcount with the compat quirk."""
    M, SL = code.points_per_symbol, code.symlen_out
    tab, packed = pack_esym_table(code)
    if packed:
        # the kernel's (tab >> (reg SL)) & (M - 1), on the table as 64 bits
        lut = torch.tensor([(tab >> (r * SL)) & (M - 1)
                            for r in range(1 << code.constraint_length)])
        return lut[reg]
    tables = code_tables(code)
    esym = torch.zeros_like(reg)
    for poly in tables.polynomials[:SL]:
        x = reg & poly
        bit = _popcount(x) & 1
        if tables.quirk_mask:
            bit &= 1 - (_popcount(x & tables.quirk_mask) & 1)
        esym = (esym << 1) | bit
    return esym


def _popcount(x):
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & MASK32) >> 24


def mc_chain_bsc_model(code, batch, nsteps, seed, param, block_lanes):
    """Model of ``mc_chain_kernel`` on the BSC, all lanes at once: the
    expected symbol of ``_esym_of``, the flip as ``(bits >> 1) <
    flip_threshold(p)``, one ACS step a row (``acs_scan``), decisions packed
    P = 32/S rows a word for S < 32, info bits stored 32 a word, and the
    traceback that reads a packed word once per P rows, shifts each row's
    decoded bit into a word from the top row down and counts errors a
    32-row word at a time by popcount.  Returns (bit errors, frame errors)."""
    S, K, T, L = code.num_states, code.constraint_length, code.num_block_symbols, \
        code.block_length
    M, SL = code.points_per_symbol, code.symlen_out
    Bt = min(block_lanes, batch)
    lane = torch.arange(batch, dtype=torch.int64)
    hbase = fc._hbase(int(seed), lane // Bt)
    j = lane % Bt
    below = flip_threshold(param)
    P, NW, half = (32 // S if S < 32 else 1), (S + 31) // 32, (S >> 1) - 1
    e_idx = torch.arange(M, dtype=torch.int64)[:, None]
    errs = torch.zeros(batch, dtype=torch.int64)
    ferrs = torch.zeros(batch, dtype=torch.int64)
    for step in range(nsteps):
        sbase = (hbase + ((step * 0x85EBCA6B) & MASK32)) & MASK32
        m = torch.full((S, batch), float(HARD_METRIC_SAT))
        m[0] = 0.0
        reg = torch.zeros(batch, dtype=torch.int64)
        dec, info = {}, {}
        acc = iacc = torch.zeros(batch, dtype=torch.int64)
        for t in range(T):
            idx = t * Bt + j
            bit = fc._interp_bits(idx, sbase, 0) & 1 if t < L else torch.zeros_like(idx)
            reg = (reg >> 1) | (bit << (K - 1))
            fmask = torch.zeros_like(reg)
            for k in range(SL):
                draw = fc._interp_bits(k * T * Bt + idx, sbase, 1) >> 1
                fmask |= (draw < below).to(torch.int64) << k
            rx = _esym_of(code, reg) ^ fmask
            bm = _popcount(rx[None, :] ^ e_idx).to(torch.float32)       # [M, B]
            m, d = lc.stream_acs_ref(code, bm[None], m, True)
            d = d[0].to(torch.int64) & MASK32                            # [NW, B]
            if P > 1:
                acc = acc | (d[0] << ((t % P) * S))
                if t % P == P - 1 or t == T - 1:
                    dec[t // P], acc = acc, torch.zeros_like(acc)
            else:
                dec[t] = d
            iacc = iacc | (bit << (t & 31))
            if t & 31 == 31 or t == T - 1:
                info[t >> 5], iacc = iacc, torch.zeros_like(iacc)
        cur = first_argmin(m, dim=0)
        err = torch.zeros(batch, dtype=torch.int64)
        dacc = torch.zeros(batch, dtype=torch.int64)
        for t in range(T - 1, -1, -1):
            if P > 1:
                if t % P == P - 1 or t == T - 1:
                    word = dec[t // P]
                survivor = (word >> ((t % P) * S + cur)) & 1
            else:
                word = torch.gather(dec[t], 0, (cur >> 5)[None])[0]
                survivor = (word >> (cur & 31)) & 1
            dacc = ((dacc << 1) & MASK32) | (cur >> (K - 2))   # row t ends in bit t mod 32
            if t & 31 == 0:
                rows = L - t
                mask = MASK32 if rows >= 32 else ((1 << rows) - 1 if rows > 0 else 0)
                err += _popcount((dacc ^ info[t >> 5]) & mask)
                dacc = torch.zeros_like(dacc)
            cur = ((cur & half) << 1) | survivor
        errs += err
        ferrs += (err > 0).to(torch.int64)
    return errs.to(torch.int32), ferrs.to(torch.int32)


@pytest.mark.parametrize("key,param", [(0, 0.0125), (1, 0.05)])
def test_chain_model_reproduces_pinned_bsc_counters(key, param):
    """The pinned interpret-mode BSC counters (code 1: the compat quirk,
    through the register table)."""
    code = get_code(key)
    gold = np.load(os.path.join(os.path.dirname(__file__), "goldens",
                                "fused_interp_counters.npz"))
    e, f = mc_chain_bsc_model(code, 128, 2, 11, param, 128)
    name = f"{code.name}_bsc_soft"
    assert np.array_equal(e.numpy(), gold[name + "_e"])
    assert np.array_equal(f.numpy(), gold[name + "_f"])
    assert int(e.sum()) > 0


@pytest.mark.parametrize("key,packed", [(0, True), (1, True), (5, True), ("k6-r12", False),
                                        ("nasa-k7", False)])
def test_chain_model_equals_plain_bsc(key, packed):
    """Against mc_chain_viterbi_ref: codes 0, 1 (quirk) and 5 (M = 8)
    through the register table; K = 6 (S = 32: one word a row; 2^6 x 2 =
    128 table bits) and nasa-k7 (S = 64: two words a row) by popcount."""
    code = get_code(key)
    assert pack_esym_table(code)[1] == packed
    e, f = mc_chain_bsc_model(code, 96, 2, 5, 0.04, 32)
    e_r, f_r = fc.mc_chain_viterbi_ref(code, 96, 2, 5, 0.04, "bsc", block_lanes=32)
    assert torch.equal(e, e_r) and torch.equal(f, f_r)
    assert int(e.sum()) > 0


@pytest.mark.parametrize("param", [0.0125, 0.05, 0.5])
def test_chain_flip_threshold_equals_interp_uniform(param):
    """The kernel's flip ``(bits >> 1) < flip_threshold(p)`` is the plain
    chain's ``_interp_uniform(..) < p`` on the chain's own draws."""
    idx = torch.arange(1 << 14, dtype=torch.int64)
    base = torch.tensor(0x1234567)
    u = fc._interp_uniform(idx, base, 1)
    bits = fc._interp_bits(idx, base, 1)
    assert torch.equal((bits >> 1) < flip_threshold(param),
                       u < torch.tensor(param, dtype=torch.float32))
