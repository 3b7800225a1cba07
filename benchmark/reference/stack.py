"""Plain reference of a stack Monte-Carlo launch: per-lane bit errors,
frame errors and walk iterations of sampled lanes.

The walk is the C reference's stack (ZJ) decoder (``stack-decoder.c``) as
the port's plain machine counts it:
  * 64 paths at most; below capacity a new path is appended, at capacity
    the first least-metric path is replaced;
  * each iteration extends the first best live path by both inputs, the
    duplicate (input 1) written first, the original taking input 0;
  * a path consumes one received symbol an extension; when the best path
    has consumed every symbol received so far the next one is accepted in
    the same iteration, and when it has consumed the whole block it is
    emitted;
  * at capacity with best and worst the same slot, one input-0 extension.
Every frame of a batch advances one iteration at a time (a lockstep
machine); the stack never runs out of budget, so its slowest frame is short.
"""

from __future__ import annotations

import torch

from benchmark.reference.common import (
    CodeSpec, Launch, channel_param, lane_frames, seq_launches, register_symbols, seq_frames,
    transition_metrics)

STACK_DEPTH = 64
CHECK_EVERY = 8


def run_lockstep(micro_step, done: torch.Tensor) -> None:
    """Run ``micro_step`` until every frame is done, testing every
    CHECK_EVERY steps; on a card the steps are replayed as a CUDA graph."""
    if bool(done.all()):
        return
    if done.device.type != "cuda":
        while True:
            for _ in range(CHECK_EVERY):
                micro_step()
            if bool(done.all()):
                return
    side = torch.cuda.Stream(done.device)
    side.wait_stream(torch.cuda.current_stream(done.device))
    with torch.cuda.stream(side):
        for _ in range(CHECK_EVERY):
            micro_step()
    torch.cuda.current_stream(done.device).wait_stream(side)
    if bool(done.all()):
        return
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(CHECK_EVERY):
            micro_step()
    while True:
        graph.replay()
        if bool(done.all()):
            return


def stack_decode(code: CodeSpec, tm: torch.Tensor):
    """Decode frames from their metric tables ``tm`` [B, T, M] (the metrics'
    dtype is the machine's); returns (bits [B, L], iterations [B])."""
    B, T, D, K = tm.shape[0], code.num_block_symbols, STACK_DEPTH, code.constraint_length
    dev, dt = tm.device, tm.dtype
    big = torch.finfo(dt).max
    ar = torch.arange(B, device=dev)
    slot = torch.arange(D, device=dev)[None, :]
    one = torch.ones(B, dtype=torch.uint8, device=dev)
    nii = torch.zeros((B, D), dtype=torch.int64, device=dev)
    state = torch.zeros((B, D), dtype=torch.int64, device=dev)
    metric = torch.zeros((B, D), dtype=dt, device=dev)
    bits = torch.zeros((B, D, T), dtype=torch.uint8, device=dev)
    nstack = torch.ones(B, dtype=torch.int64, device=dev)
    widx = torch.ones(B, dtype=torch.int64, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    iters = torch.zeros(B, dtype=torch.int64, device=dev)

    def first_where(pred):
        return torch.where(pred, slot, D).amin(dim=1)

    def best_of(live):
        mbest = torch.where(live, metric, -big).amax(dim=1, keepdim=True)
        return first_where(live & (metric == mbest))

    def micro_step():
        iters.add_((~done).to(torch.int64))
        live = slot < nstack[:, None]
        cur = best_of(live)
        cur_nii = nii[ar, cur]
        caught = cur_nii == widx
        finished = caught & (widx == T)
        advance = caught & (widx < T) & ~done
        widx.copy_(torch.where(advance, widx + 1, widx))
        done.bitwise_or_(finished)
        ext = (~caught | advance) & ~done
        s, m = state[ar, cur], metric[ar, cur]
        t = cur_nii.clamp(0, T - 1)
        r0, r1 = s, s | (1 << (K - 1))
        row = tm[ar, t]
        tm0 = row.gather(1, register_symbols(code, r0)[:, None])[:, 0]
        tm1 = row.gather(1, register_symbols(code, r1)[:, None])[:, 0]
        at_cap = nstack >= D
        mworst = torch.where(live, metric, big).amin(dim=1, keepdim=True)
        worst = first_where(live & (metric == mworst))
        new = torch.where(at_cap, worst, nstack)
        newonly = ext & (new != cur)
        row1 = bits[ar, cur]
        row1[ar, t] = one
        bits[ar, new] = torch.where(newonly[:, None], row1, bits[ar, new])
        nii[ar, new] = torch.where(newonly, cur_nii + 1, nii[ar, new])
        state[ar, new] = torch.where(newonly, r1 >> 1, state[ar, new])
        metric[ar, new] = torch.where(newonly, m + tm1, metric[ar, new])
        nii[ar, cur] = torch.where(ext, cur_nii + 1, nii[ar, cur])
        state[ar, cur] = torch.where(ext, r0 >> 1, state[ar, cur])
        metric[ar, cur] = torch.where(ext, m + tm0, metric[ar, cur])
        nstack.copy_(torch.where(ext & ~at_cap, nstack + 1, nstack))

    run_lockstep(micro_step, done)
    cur = best_of(slot < nstack[:, None])
    return bits[ar, cur, :code.block_length].to(torch.int64), iters


def launches(code: CodeSpec, wl: dict, seed: int):
    return seq_launches(code, int(wl["bits_per_point"]), seed)


def lane_counters(code: CodeSpec, cfg: dict, point: float, launch: Launch,
                  lanes: torch.Tensor, timeout_per_bit: int, device,
                  dtype=torch.float32, workers: int = 0) -> torch.Tensor:
    """Per-lane (bit errors, frame errors, iterations) [3, len(lanes)] int64
    of the sampled ``lanes`` of one launch (``timeout_per_bit`` and
    ``workers`` are the Fano reference's and unused here)."""
    gids = lane_frames(launch, lanes.to(device))
    bits, rx = seq_frames(code, cfg, gids.reshape(-1), launch.seed,
                          channel_param(cfg, point), dtype)
    tm = transition_metrics(code, cfg, rx, code.metric_weight, code.bit_metrics, dtype)
    dec, iters = stack_decode(code, tm.contiguous())
    err = (dec != bits).sum(dim=1)
    per = torch.stack([err, (err > 0).to(torch.int64), iters]).reshape(3, *gids.shape)
    return per.sum(dim=2).cpu()
