"""Long-frame Viterbi: the exact decode of supplied frames of any length,
the time-range sharded decode over a ``seq`` mesh axis, and the long-frame
Monte-Carlo accumulation on one device or a mesh.

The reference's decoders are data-driven: they consume supplied distance
vectors through ``decoder_input`` (``AWGN-channel/include/decoder.h:17-26``)
in blocks of at most ~200 bits.  :func:`long_frame_decode_stream` decodes
frames of any length exactly — the same bits as the monolithic decode,
:func:`monolithic_reference_decode` — through the streaming kernels of
:mod:`ops.longframe_cuda` on a CUDA tensor, or their plain versions on a
CPU tensor.  While a profiler session records, its three stages are
spans and each call adds to three counters (its docstring names them).

:func:`streaming_viterbi_decode` partitions the symbol stream into time
blocks across a ``seq`` mesh axis — the overlap-save scheme of parallel
block-based Viterbi decoding (the JAX package's ``parallel/streaming.py``):

  * each slot receives its block plus a ``warmup``-symbol halo on both
    sides from its neighbours (``.to()`` between the slots of a process,
    ``torch.distributed`` point-to-point between processes),
  * the left halo warms the path metrics up from a uniform start, so by
    the block's first real symbol they have converged to the monolithic
    decoder's metrics (up to a constant),
  * the right halo extends the trellis so the traceback has converged back
    onto the survivor path by the time it re-enters the block,
  * the first block instead starts exactly pinned to state 0 (its left
    halo's branch metrics force the all-zero warm-up path), and the last
    block starts its traceback at the true frame end.

With ``warmup`` of ten constraint lengths or more the result equals the
monolithic decode with overwhelming probability; boundary effects decay
exponentially in the warm-up length.

:func:`streaming_mc_accumulate` is the Monte-Carlo side: one fused
long-frame kernel call (``ops/fused_longframe.py``), or one per slot of a
mesh, each on its own time range of the same hash-addressed streams;
:func:`stream_mc_counts`, ``run_sweep``'s stream leg, enqueues the same
launches and reduces their counters on the card into a
``parallel/montecarlo.Tally``, which the leg reads once a point.  While a
profiler session records (``utils/profiling.py``), each launch is the span
``mc_launch`` and adds the counters ``stream_windows`` (lanes x windows
decoded) and ``stream_positions`` (distinct stream positions generated:
lanes x (windows x window + 2 x warmup)), and the counters' reduction and
reads to the host are ``mc_readback``.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.distributed as dist

from convolutional_codes_tpu_torch.models.codebook import Code
from convolutional_codes_tpu_torch.ops.fused_longframe import mc_longframe_viterbi
from convolutional_codes_tpu_torch.parallel.mesh import Mesh, make_mesh
from convolutional_codes_tpu_torch.parallel.montecarlo import Tally
from convolutional_codes_tpu_torch.ops.longframe_cuda import (
    pair_steps, stream_acs_cuda, stream_traceback_cuda)
from convolutional_codes_tpu_torch.ops.viterbi import (
    BIG_METRIC, HARD_METRIC_SAT, acs_forward, initial_metrics, traceback_from)
from convolutional_codes_tpu_torch.utils.bitops import first_argmin
from convolutional_codes_tpu_torch.utils.profiling import annotate, count


def long_frame_decode_stream(code: Code, dists, hard: bool = False) -> torch.Tensor:
    """Exact decode of ``[B, T, M]`` distance streams (any T): returns
    ``[B, T]`` int32 decoded bits, the K-1 tail bits included.  ``hard``
    selects the BSC's 0xFF00-saturating metrics.

    Start metrics pin state 0 (the encoder's start state); the traceback
    starts from the first state of least final metric — the reference's
    global-min rule (``viterbi-decoder.c:71-90``, which does not force end
    state 0 despite tail termination).

    While a profiler session records, the layout, kernel 4 and the
    traceback are the spans ``decode_layout``, ``decode_acs`` and
    ``decode_traceback``, and the call adds B, B x T and T to the counters
    ``decode_frames``, ``decode_symbols`` and ``decode_chain_steps``, and
    kernel 4's two-step exchanges (``longframe_cuda.pair_steps``: T // 2
    at S = 64, else 0) to ``decode_pair_steps``.
    """
    with annotate("decode_layout"):
        d_tmb = torch.as_tensor(dists).to(torch.float32).permute(1, 2, 0).contiguous()
        T, S, B = d_tmb.shape[0], code.num_states, d_tmb.shape[2]
        init = torch.full((S, B), float(HARD_METRIC_SAT) if hard else BIG_METRIC,
                          dtype=torch.float32, device=d_tmb.device)
        init[0] = 0.0
    count("decode_frames", B)
    count("decode_symbols", B * T)
    count("decode_chain_steps", T)
    count("decode_pair_steps", pair_steps(code, T))
    with annotate("decode_acs"):
        fm, dec = stream_acs_cuda(code, d_tmb, init, hard)
    with annotate("decode_traceback"):
        bits, _ = stream_traceback_cuda(code, dec, first_argmin(fm, dim=0).to(torch.int32))
        return bits.T.contiguous()


def monolithic_reference_decode(code: Code, dists) -> torch.Tensor:
    """Single-pass plain soft decode of ``[B, T, M]`` streams from the
    state-0-pinned start (ground truth for the streaming paths)."""
    dists = torch.as_tensor(dists).to(torch.float32)
    init = initial_metrics(code, dists.shape[0], False, dists.device)
    final_metrics, decisions = acs_forward(code, dists, False, init)
    return traceback_from(code, decisions, first_argmin(final_metrics, dim=-1))


#: Large-but-finite soft metric for "impossible" warm-up branches: a finite
#: value keeps every state's metric ordered while it dominates any real path
#: cost (the JAX package's ``_PIN``).
_PIN = 1e9


def _pin_first_block_halo(dists_halo: torch.Tensor) -> torch.Tensor:
    """Branch metrics that force the all-zero path: distance 0 for symbol 0,
    ``_PIN`` otherwise.  After K-1 such steps the metric vector equals the
    state-0-pinned start metrics up to paths costing ``_PIN`` or more."""
    out = torch.full_like(dists_halo, _PIN)
    out[..., 0] = 0.0
    return out


def _comm_device(dev: torch.device) -> torch.device:
    """Where a tensor goes through ``torch.distributed``: the host for gloo
    (it moves no CUDA tensor point to point), the current card for NCCL."""
    return torch.device("cpu") if dist.get_backend() == "gloo" else torch.device(
        "cuda", torch.cuda.current_device())


def _exchange_halos(blocks, slots, rank: int, B: int, W: int, M: int):
    """The JAX package's ``ppermute`` ring (streaming.py:106-115) over the
    slots of a ``seq`` axis: slot i gets the last W symbols of slot i-1 (its
    left halo; slot 0 pins its own instead) and the first W of slot i+1 (its
    right halo; the last slot has none).  ``blocks`` holds this process's
    slots' ``[B, Tl, M]`` blocks by slot index; ``slots`` is every slot's
    (device, rank).  Between two slots of this process an edge moves with
    ``.to()``, between processes by ``torch.distributed`` point-to-point
    (one ``batch_isend_irecv`` of every transfer this process takes part in,
    posted in the same order on every process).  Returns ({slot: left halo},
    {slot: right halo}) for this process's slots."""
    left, right, ops, landed = {}, {}, [], []
    for j in range(len(slots) - 1):
        # (source slot, destination slot, the edge's symbols, where it lands)
        for tag, (src, dst, cut, into) in enumerate(
                ((j, j + 1, slice(-W, None), left), (j + 1, j, slice(0, W), right)),
                start=2 * j):
            (src_dev, src_rank), (dst_dev, dst_rank) = slots[src], slots[dst]
            if src_rank == rank and dst_rank == rank:
                into[dst] = blocks[src][:, cut].to(dst_dev)
            elif src_rank == rank:
                edge = blocks[src][:, cut].contiguous().to(_comm_device(src_dev))
                ops.append(dist.P2POp(dist.isend, edge, dst_rank, tag=tag))
            elif dst_rank == rank:
                buf = torch.empty((B, W, M), dtype=torch.float32, device=_comm_device(dst_dev))
                ops.append(dist.P2POp(dist.irecv, buf, src_rank, tag=tag))
                landed.append((into, dst, buf, dst_dev))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    for into, dst, buf, dev in landed:
        into[dst] = buf.to(dev)
    return left, right


def _gather_blocks(outs, slots, rank: int, Tl: int, B: int, out_dev) -> list:
    """Every slot's ``[Tl, B]`` decoded bits on every process: each slot's
    bits are broadcast from the process that decoded them."""
    full = []
    for i, (dev, owner) in enumerate(slots):
        buf = (outs[i].to(_comm_device(dev)) if owner == rank else
               torch.empty((Tl, B), dtype=torch.int32, device=_comm_device(dev)))
        dist.broadcast(buf, src=owner)
        full.append(buf.to(out_dev))
    return full


def streaming_viterbi_decode(code: Code, dists, mesh: Mesh, warmup: int = 128,
                             seq_axis: str = "seq") -> torch.Tensor:
    """Decode long soft-demapped frames sharded over time blocks.

    ``dists``: ``[B, T, M]`` distance streams, T divisible by the size D of
    ``mesh``'s ``seq_axis`` and ``warmup`` at most T / D.  Slot ``i`` of
    the axis (every other axis at index 0) decodes symbols ``[i * T/D,
    (i+1) * T/D)`` on its device with the streaming kernels 4 and 5
    (``stream_acs_cuda``/``stream_traceback_cuda``; their plain versions on
    a CPU slot), as the JAX package's "pallas" backend does: a forward pass
    over ``[left halo | block]`` from uniform metrics, a second over the
    right halo, the right halo's traceback from its least end metric, whose
    carry state starts the block's traceback; the last slot instead starts
    at its block's end.  Returns ``[B, T]`` int32 decoded bits (the K-1
    tail bits included) on ``dists``'s device.

    Across processes every process passes the same ``dists`` and reads
    from it only its own slots' blocks; the halos cross between processes
    by point-to-point sends (:func:`_exchange_halos`), and every process
    returns the whole ``[B, T]`` bits, as one process does.
    """
    d_all = torch.as_tensor(dists).to(torch.float32)
    D = mesh.shape[seq_axis]
    B, T, M = d_all.shape
    if T % D:
        raise ValueError(f"frame length {T} not divisible by seq axis {D}")
    Tl, W = T // D, warmup
    if not 0 < W <= Tl:
        raise ValueError(f"warmup {W} must be in [1, {Tl}] (the block length)")
    if mesh.world > 1:
        if not (dist.is_available() and dist.is_initialized()):
            raise RuntimeError(f"the mesh spans {mesh.world} processes, but torch.distributed "
                               "is not initialized (parallel.distributed.initialize_from_env)")
    slots = mesh.slots((seq_axis,))
    blocks = {i: d_all[:, i * Tl:(i + 1) * Tl].to(dev)
              for i, (dev, rank) in enumerate(slots) if rank == mesh.rank}
    lefts, rights = _exchange_halos(blocks, slots, mesh.rank, B, W, M)
    outs = {}
    for i, local in blocks.items():
        dev, last = local.device, i == D - 1
        left = _pin_first_block_halo(local[:, :W]) if i == 0 else lefts[i]
        parts = [left, local] + ([] if last else [rights[i]])
        d_tmb = torch.cat(parts, dim=1).permute(1, 2, 0).contiguous()
        init = torch.zeros((code.num_states, B), dtype=torch.float32, device=dev)
        mid_m, dec_a = stream_acs_cuda(code, d_tmb[:W + Tl], init, False)
        if last:
            start = first_argmin(mid_m, dim=0).to(torch.int32)
        else:
            end_m, dec_b = stream_acs_cuda(code, d_tmb[W + Tl:], mid_m, False)
            _, start = stream_traceback_cuda(code, dec_b,
                                             first_argmin(end_m, dim=0).to(torch.int32))
        bits_tb, _ = stream_traceback_cuda(code, dec_a, start)
        outs[i] = bits_tb[W:]                     # [Tl, B]
    if mesh.world > 1:
        full = _gather_blocks(outs, slots, mesh.rank, Tl, B, d_all.device)
    else:
        full = [outs[i].to(d_all.device) for i in range(D)]
    return torch.cat(full, dim=0).T.contiguous()


def _mc_launch(code: Code, lanes: int, windows: int, seed, param, channel: str,
               demapper: str, window: int, warmup: int, win0: int, device):
    """One :func:`mc_longframe_viterbi` launch of ``windows`` windows from
    ``win0``, in the span ``mc_launch``, counted while tracing."""
    with annotate("mc_launch"):
        out = mc_longframe_viterbi(code, lanes, windows, int(seed) & 0x7FFFFFFF, param,
                                   channel, demapper, window, warmup, win0, device)
    count("stream_windows", lanes * windows)
    count("stream_positions", lanes * (windows * window + 2 * warmup) if windows else 0)
    return out


def _time_ranges(windows: int, mesh: Mesh) -> List[Tuple[torch.device, int, int]]:
    """(device, first window, windows) of this process's slots of ``mesh``
    that decode any window: slot ``k`` (in axis order) of D takes ``windows
    // D`` windows, the first ``windows % D`` slots one more, each range
    starting where the slot before it ends."""
    base, extra = divmod(windows, mesh.size)
    win0 = [k * base + min(k, extra) for k in range(mesh.size + 1)]
    return [(dev, win0[k], win0[k + 1] - win0[k]) for k, (dev, rank) in enumerate(mesh.slots())
            if rank == mesh.rank and win0[k + 1] > win0[k]]


def streaming_mc_accumulate(code: Code, lanes: int, windows: int, seed, param,
                            channel: str = "awgn", demapper: str = "soft",
                            window: int = 1920, warmup: int = 128, mesh: Mesh = None,
                            device="cuda") -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Long-frame Monte-Carlo: ``lanes`` coded streams, ``windows`` windows
    each, seeded with ``seed & 0x7FFFFFFF``.  Returns (bit_errors [lanes],
    window_errors [lanes], simulated info bits ``lanes * windows *
    window``).

    Without a mesh: one :func:`mc_longframe_viterbi` call on ``device``
    from window 0, whose int32 counters it returns.  With a mesh of D
    slots: each slot (in axis order) decodes a distinct TIME RANGE of the
    same streams, ``windows // D`` windows, the first ``windows % D``
    slots one more, each range starting where the slot before it ends (a
    slot with no window launches nothing).  The kernel's windows are
    independent overlap-save decodes of hash-addressed stream positions,
    so a slot regenerates its halos itself, no state moves between slots,
    and the summed counters equal the one-device run's exactly; they come
    back as int64 CPU tensors.
    """
    if mesh is None:
        be, we = _mc_launch(code, lanes, windows, seed, param, channel, demapper, window,
                            warmup, 0, device)
        return be, we, lanes * windows * window
    outs = [_mc_launch(code, lanes, n, seed, param, channel, demapper, window, warmup, w0, dev)
            for dev, w0, n in _time_ranges(windows, mesh)]
    with annotate("mc_readback"):
        counts = torch.zeros((2, lanes), dtype=torch.int64)
        for be, we in outs:   # the host reduction
            counts += torch.stack([be, we]).cpu()
        counts = mesh.sum_over_processes(counts)
    return counts[0], counts[1], lanes * windows * window


def stream_mc_counts(tally: Tally, code: Code, lanes: int, windows: int, seed, param,
                     channel: str = "awgn", demapper: str = "soft", window: int = 1920,
                     warmup: int = 128, mesh: Mesh = None, device="cuda") -> None:
    """The launches of :func:`streaming_mc_accumulate`, enqueued into
    ``tally``'s point 0 (read with ``tally.read(mesh)``): the bit and window
    errors and the info bits of ``lanes`` fresh streams' windows 0 ..
    ``windows - 1``."""
    ranges = [(device, 0, windows)] if mesh is None else _time_ranges(windows, mesh)
    for dev, w0, n in ranges:
        be, we = _mc_launch(code, lanes, n, seed, param, channel, demapper, window, warmup,
                            w0, dev)
        tally.add(0, be, we, lanes * n * window)


def dryrun_streaming(n_devices: int, devices=None) -> None:
    """Tiny end-to-end streaming run over an ``n_devices``-slot ``seq``
    mesh of ``devices`` (default: every visible card): a noiseless decode
    that must return the sent bits, and the sharded Monte-Carlo leg."""
    from convolutional_codes_tpu_torch.models.codebook import get_code
    from convolutional_codes_tpu_torch.ops.encoder import encode_stream

    code = get_code("nasa-k7")
    mesh = make_mesh({"seq": n_devices}, devices=devices)
    dev = mesh.slots()[0][0]
    W = 16
    L = n_devices * 64 - (code.constraint_length - 1)
    gen = torch.Generator().manual_seed(0)
    bits = torch.randint(0, 2, (2, L), generator=gen, dtype=torch.int32)
    syms = encode_stream(code, bits, terminate=True).to(torch.int64)
    M = code.points_per_symbol
    dists = 1.0 - torch.nn.functional.one_hot(syms, M).to(torch.float32)  # 0 at the sent symbol
    out = streaming_viterbi_decode(code, dists.to(dev), mesh, warmup=W)
    if not torch.equal(out[:, :L].cpu(), bits):
        raise RuntimeError("streaming dry run: the noiseless decode lost bits")

    be, we, nb = streaming_mc_accumulate(code, 8, n_devices, 3, 0.35, window=64, warmup=32,
                                         mesh=mesh)
    if nb != 8 * n_devices * 64 or be.shape != (8,):
        raise RuntimeError(f"streaming dry run: {nb} bits, counters {tuple(be.shape)}")
