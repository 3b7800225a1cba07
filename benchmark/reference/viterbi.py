"""Plain reference of a fused-chain launch: per-lane bit and frame errors.

A launch runs ``steps`` frames in each of ``lanes`` lanes.  Frame ``step``
of lane ``b`` draws from the counter hash keyed by the lane's tile ``b //
Bt`` (``Bt = min(1024, lanes)``) and the flat index ``t * Bt + b % Bt`` of
symbol ``t``: info bits from salt 0, and on AWGN the Box-Muller pair from
salt 2 at that index and at ``T * Bt`` past it; on the BSC coded bit ``k``
flips where the uniform from salt 1 at ``k * T * Bt`` past it is below the
crossover.  The block is decoded by a full-block Viterbi: state 0 starts at
0 and the others at +inf (0xFF00 hard), strict-less compares (the smaller
predecessor wins ties), hard metrics saturate at 0xFF00, and the traceback
starts from the first least end metric.
"""

from __future__ import annotations

import torch

from benchmark.reference.common import (
    MASK32, CodeSpec, Launch, box_muller, butterfly, channel_param, constellation,
    distances, encode, fused_launches, popcount32, snap, tile_base, tile_bits, to_uniform)

HARD_METRIC_SAT = 0xFF00
BIG_METRIC = 1e30


def acs_traceback(code: CodeSpec, bm: torch.Tensor, hard: bool) -> torch.Tensor:
    """Viterbi over branch metrics ``bm`` [T, M, B] in their dtype; returns
    the decoded input bits [T, B]."""
    T, _, B = bm.shape
    S, K = code.num_states, code.constraint_length
    prev, esym = butterfly(code, bm.device)
    metrics = torch.full((S, B), float(HARD_METRIC_SAT) if hard else BIG_METRIC,
                         dtype=bm.dtype, device=bm.device)
    metrics[0] = 0.0
    decisions = torch.empty((T, S, B), dtype=torch.bool, device=bm.device)
    for t in range(T):
        cand0 = metrics[prev[:, 0]] + bm[t][esym[:, 0]]
        cand1 = metrics[prev[:, 1]] + bm[t][esym[:, 1]]
        if hard:
            cand0 = cand0.clamp_max(HARD_METRIC_SAT)
            cand1 = cand1.clamp_max(HARD_METRIC_SAT)
        decisions[t] = cand1 < cand0
        metrics = torch.where(decisions[t], cand1, cand0)
    idx = torch.arange(S, device=bm.device)[:, None]
    cur = torch.where(metrics == metrics.amin(0, keepdim=True), idx, S).amin(0)
    bits = torch.empty((T, B), dtype=torch.int64, device=bm.device)
    for t in range(T - 1, -1, -1):
        b = decisions[t].gather(0, cur[None])[0].to(torch.int64)
        bits[t] = cur >> (K - 2)
        cur = ((cur & ((S >> 1) - 1)) << 1) | b
    return bits


def launches(code: CodeSpec, wl: dict, seed: int):
    return fused_launches(code, int(wl["frames_per_step"]), int(wl["bits_per_point"]), seed)


def lane_counters(code: CodeSpec, cfg: dict, point: float, launch: Launch,
                  lanes: torch.Tensor, timeout_per_bit: int, device,
                  dtype=torch.float32) -> torch.Tensor:
    """Per-lane (bit errors, frame errors) [2, len(lanes)] int64 of the
    sampled ``lanes`` of one launch (every lane is run, as the tiles share
    their draws' bases; ``timeout_per_bit`` is the walks' and unused); the
    channel, the demapper and the metrics in ``dtype``."""
    T, L, M = code.num_block_symbols, code.block_length, code.points_per_symbol
    B = launch.lanes
    Bt = min(1024, B)
    hard = cfg["channel"] == "bsc"
    param = torch.tensor(channel_param(cfg, point), dtype=torch.float32).to(dtype)
    lane = torch.arange(B, dtype=torch.int64, device=device)
    base = tile_base(launch.seed, lane // Bt)
    t_idx = torch.arange(T, dtype=torch.int64, device=device)[:, None]
    flat = t_idx * Bt + (lane % Bt)[None, :]                    # [T, B]
    e = torch.arange(M, dtype=torch.int64, device=device)[None, :, None]
    if not hard:
        points, inv_nd = constellation(cfg, device)
    out = torch.zeros((2, B), dtype=torch.int64, device=device)
    for step in range(launch.steps):
        sbase = (base + ((step * 0x85EBCA6B) & MASK32)) & MASK32
        bits = tile_bits(flat[:L], sbase, 0) & 1                # [L, B]
        syms = encode(code, bits.T).T                           # [T, B]
        if hard:
            fmask = torch.zeros_like(syms)
            for k in range(code.symlen_out):
                u = to_uniform(tile_bits(k * T * Bt + flat, sbase, 1), dtype)
                fmask = fmask | ((u < param).to(torch.int64) << k)
            bm = popcount32((syms ^ fmask)[:, None, :] ^ e).to(torch.float32)
        else:
            u0 = to_uniform(tile_bits(flat, sbase, 2), dtype)
            u1 = to_uniform(tile_bits(T * Bt + flat, sbase, 2), dtype)
            nc, ns = box_muller(u0, u1)
            pts = points.to(dtype)
            d = distances(points, inv_nd, pts[syms, 0] + param * nc, pts[syms, 1] + param * ns)
            if cfg["demapper"] == "hard":
                d = distances(points, inv_nd, *snap(points, d))
            bm = d.permute(1, 0, 2).to(dtype)                   # [T, M, B]
        dec = acs_traceback(code, bm.contiguous(), hard)
        mism = dec[:L] != bits
        out[0] += mism.sum(0)
        out[1] += mism.any(0).to(torch.int64)
    return out[:, lanes.to(device)].cpu()
