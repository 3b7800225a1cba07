"""Plain reference of a long-frame launch: per-lane bit and window errors of
overlap-save Viterbi decodes of unbounded coded streams.

A launch runs ``steps`` windows in each of ``lanes`` lanes.  Lane ``b``'s
stream draws from the counter hash keyed by (seed, lane ``b``, stream
position, salt): the info bit of position ``p`` from salt 0, and on AWGN
the Box-Muller pair from salts 1 and 2 at ``p``; on the BSC coded bit
``k`` flips where the uniform from salt ``1 + k`` at ``p`` is below the
crossover.  Positions are 32-bit, so those before 0 wrap.  Window ``j``
covers the ``window + 2 * warmup`` positions from ``j * window - warmup``
on, the encoder register holding the ``K - 1`` info bits before them.
Each window is decoded on its own: every state starts at metric 0, the
ACS runs over all its symbols with the demapper's distances (AWGN) or
the Hamming distances saturated at 0xFF00 (BSC) as branch metrics and
strict-less compares (ties keep the even predecessor), the traceback
starts from the first state of least end metric, and only the
``window`` payload rows after the left halo are error-counted.

A point is planned as ``run_sweep``'s stream leg plans it: its lanes are
the workload's ``frames_per_step``, its windows enough for
``bits_per_point`` at ``lanes * window`` bits a window, in chunks of at
most 2^30 bits (a point that fits one chunk runs an eighth first), each a
launch of fresh streams from window 0 with its chunk's seed.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from benchmark.reference.common import (
    CodeSpec, Launch, box_muller, butterfly, channel_param, chunk_seed, constellation,
    coord_bits, distances, popcount32, register_symbols, snap, to_uniform)

HARD_METRIC_SAT = 0xFF00
CHUNK_BITS = 1 << 30
#: (lane, window) pairs decoded at once: bounds the decisions and the
#: stream segments in memory (about 23 GiB at the cell's window on a card,
#: where each step's operations are then long enough to hide their launch)
BLOCK = 131072


def launches(code: CodeSpec, wl: dict, seed: int) -> List[Launch]:
    """The launches of the point seeded ``seed``: (seed, lanes, windows)."""
    lanes, window = int(wl["frames_per_step"]), int(wl["window"])
    nsteps = max(1, -(-int(wl["bits_per_point"]) // (lanes * window)))
    chunk = max(1, CHUNK_BITS // (lanes * window))
    out, left, ci = [], nsteps, 0
    while left > 0:
        n = min(chunk, left)
        if ci == 0 and n == nsteps and n > 1:
            n = max(1, n // 8)
        out.append(Launch(chunk_seed(seed, ci), lanes, n))
        left -= n
        ci += 1
    return out


def launch_bits(wl: dict, plan: Sequence[Launch]) -> int:
    return sum(la.lanes * la.steps * int(wl["window"]) for la in plan)


def stream_segment(code: CodeSpec, cfg: dict, lane: torch.Tensor, start: torch.Tensor,
                   length: int, seed: int, param: float, dtype=torch.float32):
    """Info bits [N, length] int64 and branch metrics [length, M, N] (in
    ``dtype``) of the ``length`` positions from ``start`` [N] of the
    streams of ``lane`` [N]."""
    K, M = code.constraint_length, code.points_per_symbol
    seed = int(seed) & 0x7FFFFFFF
    dev = lane.device
    pos = start[:, None] + torch.arange(-(K - 1), length, dtype=torch.int64, device=dev)
    g = lane.to(torch.int64)[:, None]
    bits = coord_bits(g, pos, seed, 0) & 1                      # [N, length + K - 1]
    reg = torch.zeros((lane.shape[0], length), dtype=torch.int64, device=dev)
    for age in range(K):   # age 0: the newest bit, at register bit K - 1
        reg = reg | (bits[:, K - 1 - age: K - 1 - age + length] << (K - 1 - age))
    esym = register_symbols(code, reg)                          # [N, length]
    pos = pos[:, K - 1:]
    param_t = torch.tensor(float(param), dtype=torch.float32).to(dtype)
    e = torch.arange(M, dtype=torch.int64, device=dev)
    if cfg["channel"] == "awgn":
        points, inv_nd = constellation(cfg, dev)
        nc, ns = box_muller(to_uniform(coord_bits(g, pos, seed, 1), dtype),
                            to_uniform(coord_bits(g, pos, seed, 2), dtype))
        pts = points.to(dtype)
        d = distances(points, inv_nd, pts[esym, 0] + param_t * nc,
                      pts[esym, 1] + param_t * ns)              # [M, N, length]
        if cfg["demapper"] == "hard":
            d = distances(points, inv_nd, *snap(points, d))
        bm = d.permute(2, 0, 1)
    else:
        fmask = torch.zeros_like(esym)
        for k in range(code.symlen_out):
            flip = to_uniform(coord_bits(g, pos, seed, 1 + k), dtype) < param_t
            fmask = fmask | (flip.to(torch.int64) << k)
        rx = (esym ^ fmask).T                                   # [length, N]
        bm = popcount32(rx[:, None, :] ^ e[None, :, None]).to(torch.float32).to(dtype)
    return bits[:, K - 1:], bm.contiguous()


def window_errors(code: CodeSpec, bm: torch.Tensor, bits: torch.Tensor, warmup: int,
                  window: int, hard: bool) -> torch.Tensor:
    """Payload bit errors [N] of the windows whose branch metrics are
    ``bm`` [Tw, M, N] and info bits ``bits`` [N, Tw]."""
    Tw, _, N = bm.shape
    S, K = code.num_states, code.constraint_length
    half = S >> 1
    dev = bm.device
    _, esym = butterfly(code, dev)
    # new state hi * S/2 + j leaves state 2j + p: candidates [hi, j, p, N]
    esym = esym.view(2, half, 2)
    metrics = torch.zeros((S, N), dtype=bm.dtype, device=dev)
    # the decisions of the rows the traceback reads, 8 states a byte
    nbytes = -(-S // 8)
    dec = torch.empty((Tw - warmup, nbytes, N), dtype=torch.uint8, device=dev)
    pad = torch.zeros((nbytes * 8 - S, N), dtype=torch.bool, device=dev)
    shift = torch.arange(8, dtype=torch.uint8, device=dev)[None, :, None]
    for t in range(Tw):
        cand = metrics.view(1, half, 2, N) + bm[t][esym]
        if hard:
            cand.clamp_max_(HARD_METRIC_SAT)
        c0, c1 = cand[:, :, 0], cand[:, :, 1]
        d = (c1 < c0).view(S, N)
        metrics = torch.minimum(c0, c1).view(S, N)   # equal on ties: the even one's value
        if t >= warmup:
            dd = torch.cat([d, pad]) if len(pad) else d
            torch.sum(dd.view(nbytes, 8, N).to(torch.uint8) << shift, 1, dtype=torch.uint8,
                      out=dec[t - warmup])
    idx = torch.arange(S, device=dev)[:, None]
    cur = torch.where(metrics == metrics.amin(0, keepdim=True), idx, S).amin(0)
    errs = torch.zeros(N, dtype=torch.int64, device=dev)
    for t in range(Tw - 1, warmup - 1, -1):
        byte = dec[t - warmup].gather(0, (cur >> 3)[None])[0].to(torch.int64)
        if t < warmup + window:
            errs += ((cur >> (K - 2)) != bits[:, t]).to(torch.int64)
        cur = ((cur & (half - 1)) << 1) | ((byte >> (cur & 7)) & 1)
    return errs


def lane_counters(code: CodeSpec, cfg: dict, point: float, launch: Launch,
                  lanes: torch.Tensor, window: int, warmup: int, device,
                  dtype=torch.float32) -> torch.Tensor:
    """Per-lane (bit errors, window errors) [2, len(lanes)] int64 of
    ``lanes`` over every window of ``launch``; the channel, the demapper
    and the metrics in ``dtype``.  Decoded in blocks of :data:`BLOCK`
    (lane, window) pairs."""
    lanes = lanes.to(torch.int64).to(device)
    n, Tw = launch.steps, window + 2 * warmup
    hard = cfg["channel"] == "bsc"
    param = channel_param(cfg, point)
    # pair q: lane lanes[q % len], window q // len
    pair_lane = lanes.repeat(n)
    pair_win = torch.arange(n, dtype=torch.int64, device=device).repeat_interleave(len(lanes))
    out = torch.zeros((2, len(lanes)), dtype=torch.int64, device=device)
    for q0 in range(0, len(pair_lane), BLOCK):
        ln, wi = pair_lane[q0:q0 + BLOCK], pair_win[q0:q0 + BLOCK]
        bits, bm = stream_segment(code, cfg, ln, wi * window - warmup, Tw, launch.seed,
                                  param, dtype)
        errs = window_errors(code, bm, bits, warmup, window, hard)
        slot = torch.arange(q0, q0 + len(ln), device=device) % len(lanes)
        out[0].index_add_(0, slot, errs)
        out[1].index_add_(0, slot, (errs > 0).to(torch.int64))
    return out.cpu()
