"""Plain reference of a Fano Monte-Carlo launch: per-lane bit errors, frame
errors and walk iterations of sampled lanes.

The walk is the C reference's Fano decoder (``fano-decoder.c``), one frame
at a time in plain Python, as the port's plain machine counts it:
  * one path with a running threshold, step DELTA = 17, and a budget of
    ``timeout_per_bit * T`` SEARCH steps (BACKTRACK steps cost none);
  * a node's two branches sorted best first by a strict ``<`` (a tie keeps
    input 0); the decoded bit flips whenever the other branch is taken;
  * forward when the selected successor's metric reaches the threshold,
    tightening the threshold by DELTA while it stays at or below the metric
    when the node is first reached; else back up while the predecessor
    reaches the threshold, else relax it by DELTA and retry;
  * at the budget's end the best-so-far bits are emitted, nodes beyond the
    deepest visit keep 0.
An iteration is one SEARCH step with, where it fails, the first BACKTRACK
step chained into it; every further BACKTRACK step is an iteration of its
own.

A frame that runs to its budget takes close to a million iterations, so a
lockstep machine over a batch would take as long as its slowest frame; here
each frame walks alone, and the frames are spread over worker processes.
Metrics are float32 values held in Python floats; every sum is rounded to
float32 (or to the control's bfloat16), the threshold's steps are exact.
"""

from __future__ import annotations

import os
from concurrent.futures import ProcessPoolExecutor
from multiprocessing import get_context

import torch

from benchmark.reference.common import (
    CodeSpec, Launch, channel_param, lane_frames, seq_launches, seq_frames, transition_metrics)
from benchmark.reference.fano_walk import walk_many


def launches(code: CodeSpec, wl: dict, seed: int):
    return seq_launches(code, int(wl["bits_per_point"]), seed)


def lane_counters(code: CodeSpec, cfg: dict, point: float, launch: Launch,
                  lanes: torch.Tensor, timeout_per_bit: int, device,
                  dtype=torch.float32, workers: int = 0) -> torch.Tensor:
    """Per-lane (bit errors, frame errors, iterations) [3, len(lanes)] int64
    of the sampled ``lanes`` of one launch.  The frames and their metric
    tables are made on ``device``; the walks run on ``workers`` processes
    (0: one per 32 frames, at most as many as the host has cores)."""
    T, L = code.num_block_symbols, code.block_length
    gids = lane_frames(launch, lanes.to(device))                 # [n, steps]
    bits, rx = seq_frames(code, cfg, gids.reshape(-1), launch.seed,
                          channel_param(cfg, point), dtype)
    tm = transition_metrics(code, cfg, rx, code.fano_metric_weight,
                            code.fano_bit_metrics, dtype).float()
    soft = cfg["channel"] == "awgn"
    rounding = "bf16" if dtype == torch.bfloat16 else ("f32" if soft else "exact")
    frames = list(zip(bits.cpu().tolist(), tm.cpu().tolist()))
    budget = int(timeout_per_bit) * T
    head = (code.constraint_length, code.polynomials, code.quirk_mask, L, T, budget, rounding)
    # a worker process costs about a second to start: one per 32 frames
    workers = workers or max(1, min(os.cpu_count() or 1, len(frames) // 32))
    shares = [frames[i::workers] for i in range(workers)]
    if workers == 1 or len(frames) < 2:
        results = [walk_many(head + (frames,))]
    else:
        with ProcessPoolExecutor(workers, mp_context=get_context("spawn")) as pool:
            results = list(pool.map(walk_many, [head + (s,) for s in shares if s]))
    per_frame = [None] * len(frames)
    for i, res in enumerate(r for r in results):
        for j, c in enumerate(res):
            per_frame[i + j * workers] = c
    out = torch.tensor(per_frame, dtype=torch.int64).T.reshape(3, gids.shape[0], gids.shape[1])
    return out.sum(dim=2)
