"""The Fano walk of one frame in plain Python, and a worker's share of
frames: imported by the reference's worker processes, so it imports
neither torch nor anything of the benchmark's heavier modules (see
``benchmark/reference/fano.py`` for the walk's rules)."""

from __future__ import annotations

import math
import struct
from typing import List, Sequence, Tuple

DELTA = 17.0


def round_f32(x: float) -> float:
    return struct.unpack("f", struct.pack("f", x))[0]


def round_bf16(x: float) -> float:
    """Round to bfloat16, nearest even, as torch's float32 -> bfloat16."""
    (u,) = struct.unpack("I", struct.pack("f", x))
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return struct.unpack("f", struct.pack("I", u))[0]


def walk(K: int, polys: Sequence[int], qmask: int, tm: List[List[float]], T: int,
         budget: int, rounding: str) -> Tuple[List[int], int]:
    """Fano-decode one frame from its metric table ``tm[t][esym]``; returns
    (decoded bits of the T nodes, iterations).  ``rounding``: "exact"
    (every sum is exact in float32: small integer metrics), "f32" or
    "bf16"."""
    rnd = {"exact": None, "f32": round_f32, "bf16": round_bf16}[rounding]
    top = K - 1

    def branches(state: int, t: int):
        """(succ, metric, decoded bit) of the better then the worse branch."""
        row = tm[t]
        out = []
        for inp in (0, 1):
            r = state | (inp << top)
            sym = 0
            for p in polys:
                x = r & p
                b = x.bit_count() & 1
                if qmask and (x & qmask).bit_count() & 1:
                    b = 0
                sym = (sym << 1) | b
            out.append((r >> 1, row[sym]))
        (n0, m0), (n1, m1) = out
        if m0 < m1:
            return n1, n0, m1, m0, 1
        return n0, n1, m0, m1, 0

    nstate = [0] * T
    nmetric = [0.0] * T
    succ0, succ1 = [0] * T, [0] * T
    tm0, tm1 = [0.0] * T, [0.0] * T
    selected, decoded = [0] * T, [0] * T
    succ0[0], succ1[0], tm0[0], tm1[0], decoded[0] = branches(0, 0)
    cur, thr, timeout, backtrack, iters = 0, 0.0, budget, False, 0
    while True:
        iters += 1
        if not backtrack:
            if timeout == 0:
                break
            timeout -= 1
            sel = selected[cur]
            m_cur = nmetric[cur]
            ms = m_cur + (tm1[cur] if sel else tm0[cur])
            if rnd:
                ms = rnd(ms)
            if ms >= thr:
                if m_cur < thr + DELTA:
                    k = math.floor((ms - thr) / DELTA)
                    while ms >= thr + (k + 1) * DELTA:
                        k += 1
                    while k > 0 and ms < thr + k * DELTA:
                        k -= 1
                    if k > 0:
                        thr = thr + k * DELTA
                        if rnd:
                            thr = rnd(thr)
                if cur + 1 == T:
                    break
                nxt = succ1[cur] if sel else succ0[cur]
                cur += 1
                nstate[cur], nmetric[cur] = nxt, ms
                succ0[cur], succ1[cur], tm0[cur], tm1[cur], decoded[cur] = branches(nxt, cur)
                selected[cur] = 0
                continue
            backtrack = True
        if cur > 0 and nmetric[cur - 1] >= thr:
            cur -= 1
            if selected[cur] == 0:
                decoded[cur] ^= 1
                selected[cur] = 1
                backtrack = False
        else:
            thr = thr - DELTA
            if rnd:
                thr = rnd(thr)
            if selected[cur]:
                decoded[cur] ^= 1
                selected[cur] = 0
            backtrack = False
    return decoded, iters


def walk_many(args) -> List[Tuple[int, int, int]]:
    """(bit errors, frame error, iterations) of several frames: a worker's share."""
    K, polys, qmask, L, T, budget, rounding, frames = args
    out = []
    for bits, tm in frames:
        dec, iters = walk(K, polys, qmask, tm, T, budget, rounding)
        err = sum(d != b for d, b in zip(dec[:L], bits))
        out.append((err, int(err > 0), iters))
    return out
