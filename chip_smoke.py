#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``convolutional_codes_tpu_torch``) on one GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --wide-longframe DIR   # only kernel 6 at S = 128, 256, from DIR
    python3 chip_smoke.py --kernel-times DIR [REF]  # only kernels 1, 3, 4, 6-10, from DIR

Phases, each of which raises on failure:
  1. environment: the card's name and power limit, torch, CUDA, nvcc, Triton;
  2. build: compile the CUDA kernels from ``convolutional_codes_tpu_torch/csrc``
     (one nvcc per source, side by side), and print the ``-Xptxas -v``
     report of the Fano kernels (no spills; kernel 10 with a 0-byte stack
     frame; beside each instance its step loop's instructions from the
     SASS, those every iteration issues, which phase 5's Fano bounds use,
     and the reconvergence barriers in it), of the
     stack kernels (no spills; kernel 9 with a 0-byte stack
     frame, kernel 7's pinned), of the fused chain and of the long-frame kernels (no spills
     for S <= 64; kernels 3 and 6's resident warps per SM for each
     instance); read the SASS (``cuobjdump -sass``) of kernel 3's code-0
     instance (instructions per symbol: this build's issue time, printed
     in phase 5 beside the bound) and of kernel 4's nasa-k7 instance
     (instructions a trellis step);
  3. kernels against their plain PyTorch versions on the card: the Viterbi
     ACS and traceback kernels on the Viterbi goldens and on random inputs
     (bit-exact), the fused Monte-Carlo kernel on the BSC golden counters
     and against its plain version (BSC exact, also at 2^20 lanes on codes
     0, 1 and 5; AWGN at most 1% of lanes different — log/sqrt/sin/cos
     differ in the last ulp), and its sincosf against the pair sinf, cosf
     on 2^24 of its Box-Muller angles (bit-exact); the stack and
     Fano decoders of supplied frames on every stack/Fano golden
     (bit-exact); the stack and Fano Monte-Carlo kernels per lane against
     their plain versions (exact on the kernels' own frames, the plain
     datagen's frames equal to them on BSC and the lanes that differ on
     them counted on AWGN), and the decoders of supplied frames on the same
     frames, all of them, the first 1000 and the first 5, against the plain
     machines (bits, metric, iterations, every Fano diagnostic exact); the
     Fano kernels at the edges of their launch plan (more frames than
     resident threads; frames too long for shared memory), exact; the stack
     kernels at the edges of their launch plan (more frames than resident
     walks, a T past the shared layout whose path bits go to device memory,
     lanes not a multiple of a block, several frames a lane, 5 and 1000
     lanes) and on the compat-rewired k9-r12 and k15-r14-16qam, exact; the
     Fano kernels on the same compat codes, exact; the stack and Fano
     Monte-Carlo kernels with a lane offset (lane0 = 4096 at 4096 lanes)
     against their plain versions with the same offset and against the
     matching lanes of one launch of twice the lanes, exact; the
     streaming
     ACS and traceback wrappers against their plain versions (bit-exact, soft and
     tie-heavy hard, odd T, S = 4 .. 256, a two-segment traceback through the
     carry); the
     long-frame Monte-Carlo kernel against its plain version and against a
     decode of the same stream by the streaming kernels (BSC exact, AWGN at
     most 1% of lanes different), also at 1021 lanes and on a 128-state
     code (thread groups of 4); the traceback kernels on both designs (one walk per frame,
     segments) at the segment edges, B = 1 and the plan's crossover, in
     both modes, bit-exact; kernel 3 with ``fast_demap`` (the linear
     demapper) against its plain version at 2^16 lanes, soft and snap, on
     codes 0 and 5; and random user codes (RANDOM_CODE_PLAN: K 3-9,
     symlen 2-4, both parity modes, and a big-K code) through every kernel
     whose limits admit them, against the C oracle (``utils/native.py``,
     built with gcc; its stack decode in a child process) or the plain
     versions, the codes printed;
  4. the main paths, each with every launch counter reset before and read
     after: (a) the CLI's code-0 AWGN and BSC Viterbi sweeps (fused kernel)
     and the modular chain (ACS + traceback kernels); (b) the CLI's code-0
     AWGN stack sweep and the sweep's stack point function at the recorded
     BSC spec; (c) the same for Fano; (d) long frames: BASELINE configs 0
     and 2 through ``streaming_mc_accumulate`` and the exact decode of
     supplied K=7 frames through ``long_frame_decode_stream``; (e)
     supplied-frame stack/Fano: the modular chain's code-0 AWGN 8 dB stack
     and Fano steps at 131,072 frames, and one BSC point of each whose
     counters must equal the plain machine's on the same frames; (f) the
     mesh: meshes whose slots repeat the card (``parallel/``), every leg
     against its serial runs exactly (``seq_mc_grid`` for stack and Fano,
     the fused kernel on a frames mesh and a sweep x frames grid, the
     seq-sharded long-frame Monte-Carlo and decode, grid and frames-only
     sweeps), the time-block decode on two processes with one slot of the
     card each over gloo (the halo exchange across processes), and the
     mesh layer's cost on one card (``measure_scaling``).  After the
     paths, outside their counters, one point of the Viterbi path runs
     without and with ``--trace``: the Chrome trace must name
     ``mc_chain_kernel`` among its CUDA kernels.
     Every point with a published BER must pass the clustered z-check (|z| <
     4.5), every BSC stack/Fano point must equal its committed record in
     results/ exactly, and the long-frame runs must beat their channels;
  5. throughput at the headline shape (code 0, 8 dB, 2^20 lanes, 16
     in-kernel steps; the exact demapper and ``fast_demap``), the
     sequential kernels at full width (8192 lanes, timeout 10000 per
     bit), the long-frame kernels at configs 0 and 2 and at the
     real-data decode shapes, the decoders of supplied frames at
     the supplied-frame path's shape and two more, and each kernel's time
     beside its plain version's and its bound.  The long-frame kernels are held
     against the plain versions that are timed there, at the main path's
     shapes: the Monte-Carlo kernel at configs 0 (exact) and 2 (at most 1%
     of lanes different), the streaming wrappers bit for bit at both
     decode shapes, the decoders of supplied frames exactly on every frame
     of each batch, which their plain machines are timed on.  Kernel 6 is
     also timed at S = 128 and 256 (config 2's shape, thread groups),
     kernels 7 and 9's rows beside PR 7's times (BEFORE_STACK), their plans
     and a per-frame divergence,
     kernels 2 and 5 on both designs (and segment lengths) where the plan
     switches, each held against the plain version and printed beside its
     time before the redesign.  The Fano kernels also print their launch
     plan, and kernels 9 and 10 are timed again on their slowest frame
     alone (ns per walk iteration).  Kernels 1, 3 and 4 print their times beside those
     before their redesign (BEFORE_MS); kernel 3 its bound (the function's
     operations, LANE_OPS) beside this build's issue time (its SASS count),
     kernel 4 its time at B = 1 (one frame: one warp's dependent chain
     alone, which is what B = 128 runs on each SM) and its SASS
     instructions a step.

``--kernel-times DIR [REF]`` times kernels 1, 3 (and its ``fast_demap``,
where the package under DIR has it), 4 and 6-10 at phase 5's shapes
(kernel 4 also soft and hard at S = 64, and at every S from 4 to 256;
kernel 7 at phase 5's four stack rows with fewer frames a lane; kernel 9
at B = 131,072 on code 0 and k9-r12), each of kernels 1, 4 and 9
held against its plain version, with the package under DIR (e.g. a ``git
archive`` of an older commit unpacked in ``.scratch/``), to compare
designs across commits in one call.  Kernels 7, 8 and 10's outputs are
saved to REF, or held equal to it where it exists (another tree's, same
seeds).

The last line is ``{"ok": true, "device": {...}}``; the line before it
lists every kernel with its launches on the main path, its largest
difference from the plain version, both times and its bound.  Without
CUDA, or without the package beside it, the script exits non-zero and
prints no result.
"""

from __future__ import annotations

import inspect
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDENS = os.path.join(ROOT, "tests", "goldens")
C_CORE_BITS_PER_S = 6.6e6        # reference C core, AWGN soft Viterbi (BASELINE.md)
#: reference C core, code 0 AWGN soft at 0 dB (BASELINE.md:58-59)
C_CORE_SEQ_BITS_PER_S = {"stack": 1.4e5, "fano": 7.1e3}
PUBLISHED_BER_8DB = 1.3756e-4    # results/awgn_channel.m, code 0 at 8 dB
Z_MAX = 4.5
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory
SECTOR_BYTES = 32                # the least a read from device memory moves
#: the times of kernels before their last redesign, at phase 5's shapes
#: (PERF.md, NVIDIA H100 80GB HBM3, 700.00 W), printed beside this run's:
#: kernels 2, 5 and 6, and kernels 1, 3 (ms per MC step; the headline in
#: info bits/s) and 4 (at B = 1, 128 and 1,024: the radix-2 step at 64
#: states before the two-step body, the mean of two ``--kernel-times`` runs)
BEFORE_MS = {"traceback": 0.0624, "stream_traceback": {128: 5.8450, 1024: 1.5035},
             "mc_longframe": (15.955, 35.200), "acs_forward": 0.1061,
             "mc_chain": 0.5826, "headline": 7.198802e10,
             "stream_acs": {1: 3.1166, 128: 3.1226, 1024: 1.3885}}
#: kernels 7 and 9 before their redesign (PR 7's chip run 12, NVIDIA H100
#: 80GB HBM3, 700.00 W): kernel 7's info bits/s at phase 5's rows, its ms
#: at 256 lanes x 1 frame, kernel 9's ms at B = 131,072
BEFORE_STACK = {("k9-r12", 4.0): 8.414728e7, ("k9-r12", 8.0): 1.561747e9,
                (0, 8.0): 2.644958e9, (0, 0.0): 7.785048e7, "mc_stack": 0.1509,
                "stack_decode": {0: 1.481, "k9-r12": 16.590}}
#: lane-instructions per cycle and SM (4 schedulers x 32 lanes) and SMs
LANE_SLOTS_PER_SM, SMS = 128, 132
#: instructions a walk iteration of the Fano step issues, whatever its
#: outcome (``sass_always`` of the step loop; phase 2 reads them from the
#: SASS of this build, fano_step_instr): kernels 8 and 10 with their node
#: records in shared memory, narrow and wide (``_wide``) builds
INSTR_PER_ITER = {}


def require(cond, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def phase(name: str):
    """Context manager printing the wall time of a phase."""
    class _Phase:
        def __enter__(self):
            self.t0 = time.time()
            print(f"== {name}", flush=True)

        def __exit__(self, *exc):
            if exc[0] is None:
                print(f"== {name}: {time.time() - self.t0:.1f} s", flush=True)
    return _Phase()


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def sm_clock_hz() -> float:
    """The card's maximum SM clock, from nvidia-smi."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    return float(out.strip().splitlines()[0]) * 1e6


def cuda_call(fn):
    """``(fn(), device milliseconds of that one call)`` (CUDA events)."""
    import torch
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds of ``fn()`` over ``reps`` calls (CUDA events)."""
    import torch
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def cuda_median_ms(fn, reps: int) -> float:
    """Median device milliseconds of one ``fn()`` over ``reps`` calls (CUDA
    events around each call)."""
    import torch
    marks = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
             for _ in range(reps)]
    for start, end in marks:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return float(np.median([start.elapsed_time(end) for start, end in marks]))


def print_ptxas(log: str, build: str = "fano_mc", steps: dict = None) -> None:
    """The ``-Xptxas -v`` report of the Fano kernels (kernels 8 and 10 for
    each node storage) of ``build``, ``fano_mc`` or its wide build
    ``fano_mc_wide`` (codes of 5-8 coded bits a symbol): registers, stack
    frame and spills, and beside them what ``steps`` (fano_step_instr)
    read of each instance's step loop.  No instance may spill, and kernel
    10's keep a 0-byte stack frame.  Kernel 8's keep exactly 32 bytes in
    ``fano_mc``, the local array of sinf/cosf's reduction of huge arguments
    (its datagen's Box-Muller; never taken, the angle is below 2 pi): a
    frame that grows fails; in the wide build none or those 32 bytes."""
    import re
    require(log, f"no -Xptxas -v report of {build}")
    instances = re.findall(r"Compiling entry function '(\S+)'.*?\n.*?Function properties for "
                           r"\S+\n\s*(.*?)\n.*?(Used \d+ registers)", log, re.S)
    require(len(instances) == 4, f"-Xptxas -v: {len(instances)} Fano kernel instances, want 4")
    for mangled, frame, regs in instances:
        kernel = re.search(r"(fano_mc_kernel|fano_decode_kernel)INS_\d+(\w+?Nodes)E", mangled)
        step = (steps or {}).get((kernel[1], kernel[2]))
        loop = ("" if step is None else
                f"; step loop {step[0]} instructions, {step[1]} issued every iteration, "
                f"{step[2]} reconvergence barriers (BSSY) inside")
        print(f"ptxas {build}: {kernel[1]}<{kernel[2]}>: {regs}, {frame}{loop}")
        require(frame.endswith("0 bytes spill stores, 0 bytes spill loads"),
                f"{build} {kernel[0]} spills: {frame}")
        want = (("32",) if build == "fano_mc" else ("0", "32")) if kernel[1] == "fano_mc_kernel" \
            else ("0",)
        require(any(frame.startswith(f"{w} bytes stack frame") for w in want),
                f"{build} {kernel[0]}: {frame}")


#: kernel 7's stack frame in bytes: the local array of sinf/cosf's reduction
#: of huge arguments in its datagen (never taken: the angle is below 2 pi),
#: 32 bytes as kernel 8's, which nvcc keeps in some of kernel 7's instances
#: and not in others
STACK_MC_FRAME = 32


def print_ptxas_stack(log: str, build: str = "stack_mc") -> None:
    """The ``-Xptxas -v`` report of ``build``, ``stack_mc`` or its wide build
    ``stack_mc_wide``: kernels 7 and 9 for each path-bit storage and node
    word, with registers, stack frame and spills.  No instance may spill;
    kernel 9's keep a 0-byte stack frame and kernel 7's either none or
    exactly STACK_MC_FRAME bytes: a frame that grows fails."""
    import re
    require(log, f"no -Xptxas -v report of {build}")
    instances = re.findall(r"Compiling entry function '(\S+)'.*?\n.*?Function properties for "
                           r"\S+\n\s*(.*?)\n.*?(Used \d+ registers)", log, re.S)
    require(len(instances) == 8, f"-Xptxas -v: {len(instances)} stack instances, want 8")
    for mangled, frame, regs in instances:
        k = re.search(r"(stack_mc_kernel|stack_decode_kernel)INS_\d+(Shared|Global)BitsELb([01])E",
                      mangled)
        require(k, f"unknown stack instance {mangled}")
        print(f"ptxas {build}: {k[1]}<bits {k[2].lower()}, {'packed' if k[3] == '1' else 'two'} "
              f"node words>: {regs}, {frame}")
        require(frame.endswith("0 bytes spill stores, 0 bytes spill loads"),
                f"{build} {k[0]} spills: {frame}")
        allowed = (0, STACK_MC_FRAME) if k[1] == "stack_mc_kernel" else (0,)
        require(any(frame.startswith(f"{b} bytes stack frame") for b in allowed),
                f"{build} {k[0]}: {frame}")


#: registers of one SM, the largest resident warps and blocks of one SM
SM_REGISTERS, SM_WARPS, SM_BLOCKS = 65536, 64, 32


def resident_warps(regs: int, threads: int) -> int:
    """Warps per SM that a kernel of ``regs`` registers a thread fits in
    blocks of ``threads`` (registers are granted 8 a thread at a time)."""
    per_block = -(-regs // 8) * 8 * threads
    blocks = min(SM_REGISTERS // per_block, SM_WARPS * 32 // threads, SM_BLOCKS)
    return blocks * threads // 32


def print_ptxas_longframe(logs: dict) -> None:
    """The ``-Xptxas -v`` report of ``fused_chain.cu`` and
    ``fused_chain_lin.cu`` (kernel 3, an instance per channel mode; the
    second fast_demap's), ``longframe.cu`` (kernels 1, 2, 4, 5:
    stream ACS, traceback walk, segment maps and fold) and of
    ``longframe_mc.cu`` (kernel 6, one thread or a group of G threads a
    lane): registers, stack frame, spills, and for kernels 3 and 6 the
    resident warps per SM in blocks of 128 (and the waves of kernel 6's
    config 2 grid, 65,536 lanes).  No instance for S <= 64 may spill (the
    traceback kernels are templated on nwords = S/32 rounded up: nwords <=
    2).  Kernel 3's stack frame is its decision and info-bit arrays."""
    import re
    spills = []
    for lib in ("fused_chain", "fused_chain_lin", "longframe", "longframe_mc"):
        log = logs.get(lib, "")
        require(log, f"no -Xptxas -v report of {lib}.cu")
        instances = re.findall(r"Compiling entry function '(\S+)'.*?\n.*?Function properties for "
                               r"\S+\n\s*(.*?)\n.*?Used (\d+) registers", log, re.S)
        require(instances, f"-Xptxas -v of {lib}.cu names no kernel")
        for mangled, frame, regs in instances:
            m = re.search(r"\d+([a-z_]+_kernel)(?:I(\w*?)EE|E)", mangled)
            name = m[1]
            args = [int(a) for a in re.findall(r"L[ib](\d+)", m[2] or "")]
            states = 32 * args[0] if name in ("stream_traceback_kernel", "tb_map_kernel") else (
                args[0] if args else 0)
            line = f"ptxas: {name}<{', '.join(map(str, args))}>: {regs} registers, {frame}"
            if lib == "longframe_mc":
                group = args[2] if len(args) > 2 else 1
                warps = resident_warps(int(regs), 128)
                blocks = 65536 * group // 128
                line += (f"; {warps} warps per SM, config 2's {blocks} blocks in "
                         f"{blocks / (warps // 4 * SMS):.2f} waves")
            elif name == "mc_chain_kernel":
                line += f"; {resident_warps(int(regs), 128)} warps per SM"
            print(line)
            if states <= 64 and not frame.endswith("0 bytes spill stores, 0 bytes spill loads"):
                spills.append(f"{lib}.cu {name}<{args}>: {frame}")
    require(not spills, f"instances for S <= 64 spill: {spills}")


def sass_functions(lib) -> dict:
    """``cuobjdump -sass`` of a built library: {mangled kernel name: [(address,
    instruction text)]}, branch targets as addresses."""
    import re
    out = subprocess.run(["/usr/local/cuda/bin/cuobjdump", "-sass", str(lib)],
                         capture_output=True, text=True, timeout=300, check=True).stdout
    funcs, labels = {}, {}
    code, pending = None, []
    for line in out.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            code = funcs.setdefault(m[1], [])
            labels[m[1]] = {}
            continue
        m = re.match(r"\s*(\.L\w+):", line)   # a label: the next instruction's address
        if m:
            pending.append(m[1])
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if m and code is not None:
            labels[next(reversed(labels))].update((name, int(m[1], 16)) for name in pending)
            pending = []
            code.append((int(m[1], 16), m[2]))
    for name, code in funcs.items():   # targets written as labels, `(.L_x_3)
        code[:] = [(addr, re.sub(r"`\((\.L\w+)\)",
                                 lambda mm: hex(labels[name].get(mm[1], -1)), text))
                   for addr, text in code]
    return funcs


def sass_function(funcs: dict, pattern: str) -> tuple:
    """(the match, the code) of the one function whose mangled name matches
    the regular expression ``pattern``."""
    import re
    found = [(m, code) for n, code in funcs.items() for m in [re.search(pattern, n)] if m]
    require(len(found) == 1, f"SASS: {len(found)} functions match {pattern}")
    return found[0]


def sass_op(text: str) -> tuple:
    """(guard, opcode with modifiers, its base, operands) of one instruction."""
    guard = ""
    if text.startswith("@"):
        guard, text = text.split(None, 1)
    op, _, rest = text.partition(" ")
    return guard, op, op.split(".")[0], [o.strip() for o in rest.split(",")] if rest else []


def sass_loops(code: list, opcode: str) -> list:
    """The ranges (lo, hi) of the backward branches whose body holds
    ``opcode`` (a base opcode, or one with modifiers), innermost first."""
    import re
    loops = set()
    for addr, text in code:
        m = re.search(r"\bBRA\b.*?(0x[0-9a-f]+)", text)
        if m and int(m[1], 16) <= addr:
            loops.add((int(m[1], 16), addr))
    return sorted((r for r in loops
                   if any(opcode in (o[1], o[2]) for o in map(sass_op, sass_body(code, *r)))),
                  key=lambda r: r[1] - r[0])


def sass_body(code: list, lo: int, hi: int) -> list:
    return [text for addr, text in code if lo <= addr <= hi]


def sass_always(code: list, lo: int, hi: int) -> int:
    """The instructions of the loop [lo, hi] that every iteration issues:
    those that no forward branch inside the loop can skip (a lower bound of
    what an iteration issues: the skipped regions hold the slow paths of
    sqrtf and sincosf and the work of some iterations only)."""
    import re
    skipped = set()
    for addr, text in code:
        m = re.search(r"\bBRA\b.*?(0x[0-9a-f]+)", text)
        if m and lo <= addr <= hi and addr < int(m[1], 16) <= hi + 16:
            skipped.update(a for a, _ in code if addr < a < int(m[1], 16))
    return sum(lo <= addr <= hi and addr not in skipped for addr, _ in code)


def fano_step_instr(build, lib: str) -> dict:
    """Kernels 8 and 10 of ``lib`` (``fano_mc`` or ``fano_mc_wide``) in
    their SASS: {(kernel, node storage): (instructions of the step loop,
    those every iteration issues (sass_always), BSSY inside the loop)}.
    The step loop is the innermost loop that stores a node record (one
    128-bit store, to shared or to device memory)."""
    import re
    out = {}
    for name, code in sass_functions(build.library_path(lib)).items():
        k = re.search(r"(fano_mc_kernel|fano_decode_kernel)INS_\d+(\w+?Nodes)E", name)
        if not k:
            continue
        loops = sass_loops(code, "STS.128" if k[2] == "SharedNodes" else "STG.E.128")
        require(loops, f"SASS {lib} {k[1]}<{k[2]}>: no loop stores a node record")
        body = sass_body(code, *loops[0])
        out[(k[1], k[2])] = (len(body), sass_always(code, *loops[0]),
                             sum(sass_op(t)[2] == "BSSY" for t in body))
    require(len(out) == 4, f"SASS {lib}: {len(out)} Fano kernel instances, want 4")
    return out


def read_sass(build) -> dict:
    """From the SASS of the built libraries, what this build issues (the
    kernels' bounds count the function's own work, not these): kernel 3's
    instructions per symbol (code 0: S = 4, M = 4, AWGN soft), what its
    forward loop issues every symbol plus what its traceback loop issues
    every row (sass_always); kernel 4's instructions a trellis step
    (nasa-k7: S = 64, M = 4, its unrolled soft step loop)."""
    out = {}
    for key, lib, mode, label in (("mc_chain_instr", "fused_chain", 1, "soft"),
                                  ("mc_chain_fast_demap_instr", "fused_chain_lin", 3,
                                   "soft, fast_demap")):
        _, code = sass_function(sass_functions(build.library_path(lib)),
                                rf"mc_chain_kernelILi4ELi4ELi{mode}E")
        fwd = sass_loops(code, "MUFU.RSQ")[0]              # one sqrtf a symbol
        tb = next(r for r in sass_loops(code, "POPC")       # the error count a word
                  if r[1] < fwd[0] or r[0] > fwd[1])
        body, tbody = sass_body(code, *fwd), sass_body(code, *tb)
        per_iter = sum(sass_op(t)[1] == "MUFU.RSQ" for t in body)
        always, tb_always = sass_always(code, *fwd), sass_always(code, *tb)
        rows = 8   # the traceback walks a packed word (32 / S rows) an iteration
        out[key] = always / per_iter + tb_always / rows
        print(f"SASS mc_chain_kernel<4, 4, {label}>: forward loop {len(body)} instructions "
              f"for {per_iter} symbols ({always} issued every iteration), traceback loop "
              f"{len(tbody)} for {rows} rows ({tb_always} every iteration): "
              f"{out[key]:.1f} instructions every symbol issues")
    _, code = sass_function(sass_functions(build.library_path("longframe")),
                            r"stream_acs_kernelILi64ELi4ELb0EE")
    # the unrolled step loop: the innermost loop with the most ballots,
    # preferring one without the hard mode's saturation (FMNMX)
    loops = sass_loops(code, "VOTE")
    inner = [r for r in loops if not any(o != r and r[0] <= o[0] and o[1] <= r[1] for o in loops)]
    soft = [r for r in inner
            if not any(sass_op(t)[2] == "FMNMX" for t in sass_body(code, *r))] or inner
    lo, hi = max(soft, key=lambda r: sum(sass_op(t)[2] == "VOTE" for t in sass_body(code, *r)))
    body = sass_body(code, lo, hi)
    steps = sum(sass_op(t)[2] == "VOTE" for t in body) // 2   # two ballots a step
    out["stream_acs_instr"] = sass_always(code, lo, hi) / steps
    print(f"SASS stream_acs_kernel<64, 4>: step loop {len(body)} instructions for {steps} "
          f"steps, {out['stream_acs_instr']:.1f} issued every step")
    return out


# ---------------------------------------------------------------- z-check
def z_score(rec, channel: str, row: str, gold: dict):
    """Clustered z of a record against a published row (the check of
    tests/test_ber_statistical.py); None where the published BER is 0."""
    from convolutional_codes_tpu_torch.sim.sweep import awgn_tier_bits, bsc_tier_bits
    grid = gold[channel]["SNR" if channel == "awgn" else "ber_uncoded"]
    idx = min(range(len(grid)), key=lambda j: abs(grid[j] - rec.point))
    p_pub = gold[channel][row][idx]
    if p_pub <= 0:
        return None
    n_pub = (awgn_tier_bits if channel == "awgn" else bsc_tier_bits)(rec.point)
    if rec.bit_errors == 0:
        frame_bits = rec.bits / max(rec.frames, 1)
        return -math.sqrt(p_pub * rec.bits / max(1.0, frame_bits / 4))
    cluster = max(1.0, rec.bit_errors / max(rec.frame_errors, 1))
    var = cluster * ((rec.ber * (1 - rec.ber)) / rec.bits
                     + (p_pub * (1 - p_pub)) / n_pub)
    return (rec.ber - p_pub) / math.sqrt(var) if var else 0.0


# ---------------------------------------------------------------- phases
def check_viterbi_kernels(torch, dev, stats):
    """Kernels 1-2: goldens through the decoders, and exact agreement with
    the plain versions on random soft and tie-heavy hard inputs."""
    from convolutional_codes_tpu_torch import get_code
    from convolutional_codes_tpu_torch.ops import viterbi_cuda as vc
    from convolutional_codes_tpu_torch.ops.viterbi import (
        BIG_METRIC, HARD_METRIC_SAT, viterbi_decode_hard, viterbi_decode_soft)

    for idx in (0, 1, 2, 3, 5):
        code = get_code(idx)
        for mode in (0, 1):
            g = np.load(os.path.join(GOLDENS, f"viterbi_soft_{idx}_m{mode}.npz"))
            out = viterbi_decode_soft(code, torch.as_tensor(g["dists"], device=dev))
            require(np.array_equal(out.cpu().numpy(), g["decoded"]),
                    f"soft Viterbi golden {idx} m{mode}")
            g = np.load(os.path.join(GOLDENS, f"viterbi_hard_{idx}_m{mode}.npz"))
            bits, metric = viterbi_decode_hard(code, torch.as_tensor(g["received"], device=dev))
            require(np.array_equal(bits.cpu().numpy(), g["decoded"]),
                    f"hard Viterbi golden {idx} m{mode}")
            require(np.array_equal(metric.cpu().numpy(), g["metrics"]),
                    f"hard Viterbi golden metric {idx} m{mode}")
    print("viterbi goldens: 20/20 files bit-exact (bits and hard metrics)")

    rng = np.random.default_rng(2024)
    # k3-r12 at the modular main path's batch (16384 frames), S=64 and S=256
    for name, B in (("k3-r12", 16384), ("nasa-k7", 4096), ("k9-r12", 4096)):
        code = get_code(name)
        T, M, S = code.num_block_symbols, code.points_per_symbol, code.num_states
        for hard in (False, True):
            if hard:   # integer Hamming metrics: ties everywhere
                d = rng.integers(0, code.symlen_out + 1, (T, M, B)).astype(np.float32)
            else:
                d = rng.uniform(0.0, 8.0, (T, M, B)).astype(np.float32)
            dists = torch.as_tensor(d, device=dev)
            init = torch.full((S, B), float(HARD_METRIC_SAT) if hard else BIG_METRIC,
                              device=dev)
            init[0] = 0.0
            fm, dec = vc.acs_forward_cuda(code, dists, init, hard)
            fm_r, dec_r = vc.acs_forward_ref(code, dists, init, hard)
            err = float((fm - fm_r).abs().max())
            require(err == 0.0 and torch.equal(dec, dec_r),
                    f"ACS kernel vs plain {name} hard={hard}: max err {err}, "
                    f"{int((dec != dec_r).sum())} decision words differ")
            bits, best = vc.traceback_cuda(code, dec, fm)
            bits_r, best_r = vc.traceback_ref(code, dec, fm)
            require(torch.equal(bits, bits_r) and torch.equal(best, best_r),
                    f"traceback kernel vs plain {name} hard={hard}")
            stats["acs_forward"] = max(stats["acs_forward"], err)
            stats["traceback"] = max(stats["traceback"],
                                     float((bits - bits_r).abs().max()))
        print(f"viterbi kernels vs plain {name} (S={S}, B={B}): soft and hard "
              "bit-exact (tolerance 0)")


def check_fused_kernel(torch, dev, stats):
    """Kernel 3: BSC goldens exactly, kernel against plain exactly on BSC,
    and at most 1% of lanes different on AWGN; its sincosf bit for bit
    against the pair sinf, cosf on its own angles."""
    from convolutional_codes_tpu_torch import get_code
    from convolutional_codes_tpu_torch.ops.channels import awgn_sigma
    from convolutional_codes_tpu_torch.ops.fused_chain import (
        mc_chain_viterbi, mc_chain_viterbi_ref, sincos_mismatches)

    gold = np.load(os.path.join(GOLDENS, "fused_interp_counters.npz"))
    s6, s4 = float(awgn_sigma(6.0)), float(awgn_sigma(4.0))
    golden_cases = [(0, "bsc", "soft", 0.0125), (1, "bsc", "soft", 0.05),
                    (0, "awgn", "soft", s6), (0, "awgn", "hard", s6),
                    (5, "awgn", "soft", s4), ("nasa-k7", "awgn", "soft", s4)]
    for ck, ch, dm, p in golden_cases:
        code = get_code(ck)
        e, f = mc_chain_viterbi(code, 128, 2, 11, p, ch, block_lanes=128,
                                demapper=dm, device=dev)
        key = f"{code.name}_{ch}_{dm}"
        diff = int(((e.cpu().numpy() != gold[key + "_e"])
                    | (f.cpu().numpy() != gold[key + "_f"])).sum())
        print(f"fused golden {key}: {diff}/128 lanes differ")
        require(diff == 0 if ch == "bsc" else diff <= 1,
                f"fused golden {key}: {diff} lanes differ")

    def compare(code, batch, nsteps, seed, p, ch, dm, variant=""):
        kw = dict(channel=ch, block_lanes=1024, demapper=dm, device=dev, variant=variant)
        e, f = mc_chain_viterbi(code, batch, nsteps, seed, p, **kw)
        e_r, f_r = mc_chain_viterbi_ref(code, batch, nsteps, seed, p, **kw)
        lanes = int(((e != e_r) | (f != f_r)).sum())
        err = float(torch.maximum((e - e_r).abs(), (f - f_r).abs()).max())
        stats["mc_chain"] = max(stats["mc_chain"], err)
        print(f"fused kernel vs plain {code.name} {ch}/{dm}{' ' + variant if variant else ''} "
              f"batch {batch}: {lanes}/{batch} lanes differ, max |counter diff| {err:g}, "
              f"bit errors {int(e.sum())}")
        exact = ch == "bsc" or variant   # fast_demap: lane for lane
        require(lanes == 0 if exact else lanes <= batch // 100,
                f"fused kernel vs plain {code.name} {ch}/{dm} {variant}: {lanes} lanes differ")
        return int(e.sum())

    for name in ("k3-r12", "k4-r12", "k9-r12"):
        compare(get_code(name), 8192, 2, 7, 0.05, "bsc", "soft")
    for ck, dm, p in ((0, "soft", s6), (0, "hard", s6), (5, "soft", s4),
                      ("nasa-k7", "soft", s4)):
        compare(get_code(ck), 8192, 2, 7, p, "awgn", dm)
    # at the main path's shape: 2^20 lanes, tile 1024; codes 1 (the compat
    # quirk) and 5 (M = 8) through the register table too
    for ck in (0, 1, 5):
        compare(get_code(ck), 1 << 20, 1, 5, 0.0125, "bsc", "soft")
    compare(get_code(0), 1 << 20, 1, 5, float(awgn_sigma(8.0)), "awgn", "soft")
    # fast_demap (the linear demapper): code 0 (QPSK, constant-modulus) and
    # code 5 (8-QAM, each point's |p|^2 kept), soft and snap, at 2^16 lanes
    for ck in (0, 5):
        for dm in ("soft", "hard"):
            lin = compare(get_code(ck), 1 << 16, 2, 9, s4, "awgn", dm, "fast_demap")
            exact, _ = mc_chain_viterbi(get_code(ck), 1 << 16, 2, 9, s4, "awgn",
                                        demapper=dm, device=dev)
            print(f"  fast_demap {get_code(ck).name}/{dm}: {lin} bit errors, the exact "
                  f"demapper on the same streams {int(exact.sum())}")
    n = 1 << 24
    ds, dc = sincos_mismatches(n, 5, dev)
    print(f"sincosf vs sinf, cosf on {n} Box-Muller angles 2 pi u (salt 2): {ds} sines and "
          f"{dc} cosines differ")
    require(ds == 0 and dc == 0, "sincosf differs from the pair sinf, cosf")


SEQ_PHASE3 = {  # (code, channel, point, demapper[, timeout_per_bit]); 1024 lanes x 2
    "stack": [(0, "bsc", 0.05, "soft"), (0, "awgn", 6.0, "soft"), (0, "awgn", 5.0, "hard"),
              (5, "awgn", 4.0, "soft"), ("wspr-k32", "awgn", 4.0, "soft"),
              ("wspr-k32", "bsc", 0.02, "soft"), ("k9-r12", "awgn", 4.0, "soft"),
              ("k15-r14-16qam", "awgn", 8.0, "soft")],
    "fano": [(0, "awgn", 2.0, "soft", 40), (0, "bsc", 0.05, "soft", 60),
             (0, "awgn", 4.0, "hard", 40), (5, "awgn", 3.0, "soft", 50),
             ("wspr-k32", "awgn", 5.0, "soft", 25), ("wspr-k32", "bsc", 0.02, "soft", 30),
             ("k9-r12", "bsc", 0.03, "soft", 50), ("k15-r14-16qam", "awgn", 5.0, "soft", 50)],
}


def decode_supplied(decoder: str, code, syms, soft: bool, timeout_per_bit: int):
    """Kernel 9 or 10 on supplied frames: (bits [B, L], the plain machine's
    other outputs by name).  Not synchronised."""
    from convolutional_codes_tpu_torch.ops import fano_cuda, stack_cuda
    if decoder == "fano":
        return fano_cuda.fano_decode_cuda(code, syms, soft, timeout_per_bit, with_diag=True)
    bits, metric, iters = stack_cuda.stack_machine_cuda(code, syms, soft)
    return bits, {"metric": metric, "iters": iters}


def decode_plain(decoder: str, code, syms, soft: bool, timeout_per_bit: int):
    """The plain machine on the same frames, with the same outputs."""
    from convolutional_codes_tpu_torch.ops import fano, stack
    if decoder == "fano":
        return fano.fano_machine(code, syms, soft, timeout_per_bit)
    bits, metric, iters = stack.stack_machine(code, syms, soft)
    return bits, {"metric": metric, "iters": iters}


def supplied_diff(torch, got, want):
    """(names of the outputs where kernel 9 or 10 and the plain machine
    differ, largest absolute difference over all of them)."""
    pairs = [("bits", got[0], want[0])] + [(k, got[1][k], v) for k, v in want[1].items()]
    bad = [k for k, a, b in pairs if not torch.equal(a.to(b.dtype), b)]
    err = max(float((a.double() - b.double()).abs().max()) for _, a, b in pairs)
    return bad, err


def check_sequential_kernels(torch, dev, stats):
    """Kernels 9-10 on every stack/Fano golden (bit-exact); kernels 7-8 per
    lane against their plain versions, and kernels 9-10 against the plain
    machines on the same frames (exact)."""
    import glob
    from convolutional_codes_tpu_torch import get_code
    from convolutional_codes_tpu_torch.ops import (
        fano_cuda, fano_mc, mc_datagen, stack_cuda, stack_mc)
    from convolutional_codes_tpu_torch.ops.channels import awgn_sigma
    from convolutional_codes_tpu_torch.ops.fano import FANO_TIMEOUT

    files = sorted(glob.glob(os.path.join(GOLDENS, "stack_*.npz"))
                   + glob.glob(os.path.join(GOLDENS, "fano_*.npz")))
    for path in files:
        g = np.load(path)
        name = os.path.basename(path)
        code = get_code(0 if "fma" in name else int(name.split("_")[2]))
        soft = "dists" in g
        x = torch.as_tensor(g["dists"] if soft else g["received"], device=dev)
        decode = (stack_cuda.stack_decode_cuda if name.startswith("stack")
                  else fano_cuda.fano_decode_cuda)
        out = decode(code, x, soft)
        torch.cuda.synchronize()
        require(np.array_equal(out.cpu().numpy(), g["decoded"]), f"kernels 9-10 on golden {name}")
    print(f"stack/Fano goldens through kernels 9-10: {len(files)}/{len(files)} files bit-exact "
          "(incl. fano_fma_regression.npz)")

    for decoder, cases in SEQ_PHASE3.items():
        mc, ref = ((stack_mc.mc_stack, stack_mc.mc_stack_ref) if decoder == "stack"
                   else (fano_mc.mc_fano, fano_mc.mc_fano_ref))
        kernel = "kernel 9" if decoder == "stack" else "kernel 10"
        for ck, channel, point, demapper, *tpb in cases:
            code = get_code(ck)
            param = float(awgn_sigma(point)) if channel == "awgn" else point
            soft, tpb = channel == "awgn", (tpb[0] if tpb else FANO_TIMEOUT)
            kw = {"timeout_per_bit": tpb} if decoder == "fano" else {}
            lanes, fpl, seed = 1024, 2, 42
            tag = f"{decoder} kernel vs plain {code.name} {channel}/{demapper}"
            k = mc(code, lanes, fpl, seed, param, channel, demapper, device=dev, **kw)
            # the kernel's own frames through the plain machine
            gids = torch.arange(lanes * fpl, device=dev)
            bits, syms = mc_datagen.frames_cuda(code, gids, seed, param, channel, demapper)
            plain = decode_plain(decoder, code, syms, soft, tpb)
            own = torch.zeros_like(k)
            stack_mc.count_errors(own, gids // fpl, plain[0], bits, plain[1]["iters"])
            own_diff = int((k != own).any(0).sum())
            require(own_diff == 0, f"{tag} on the kernel's own frames: {own_diff} lanes differ")
            stats["mc_" + decoder] = max(stats["mc_" + decoder], float((k - own).abs().max()))
            # kernel 9 or 10 on the same frames: all of them, the first 1000 and 5
            for n in (lanes * fpl, 1000, 5):
                got = decode_supplied(decoder, code, syms[:n], soft, tpb)
                torch.cuda.synchronize()
                bad, err = supplied_diff(torch, got, (plain[0][:n], {
                    key: v[:n] for key, v in plain[1].items()}))
                require(not bad, f"{kernel} vs plain {code.name} {channel}/{demapper} "
                                 f"B={n}: {bad} differ")
                stats[decoder + "_decode"] = max(stats[decoder + "_decode"], err)
            fb, fs = mc_datagen.frames_host(code, gids, seed, param, channel, demapper, dev)
            require(torch.equal(fb, bits), f"{tag}: frame bits differ")
            same9 = (f"{kernel} = plain at B={lanes * fpl}, 1000 and 5 (bits, metric, "
                     f"{'diagnostics, ' if decoder == 'fano' else ''}iterations)")
            if channel == "bsc":
                # the plain datagen's frames are the kernel's: own is the plain version's count
                require(torch.equal(fs, syms), f"{tag}: BSC frames differ")
                print(f"{tag}: 0/{lanes} lanes differ (exact), bit errors {int(k[0].sum())}, "
                      f"iterations {int(k[2].sum())}; {same9}")
                continue
            # the plain version on its own datagen's frames (its log/sqrt/sin/cos
            # may differ from the kernels' in the last ulp: lanes counted)
            r = ref(code, lanes, fpl, seed, param, channel, demapper, device=dev, **kw)
            diff = int((k != r).any(0).sum())
            print(f"{tag}: 0/{lanes} lanes differ on the kernel's own frames (exact); "
                  f"{diff}/{lanes} lanes differ on the plain datagen's frames; "
                  f"bit errors {int(k[0].sum())} vs {int(r[0].sum())}; {same9}")


#: kernels 8 and 10 at the edges of their launch plan: (code, channel,
#: point, timeout_per_bit, lanes, frames per lane); None is code 0's
#: polynomials with block_length 600 (T = 602 > 454: node records in device
#: memory)
FANO_EDGES = [(0, "bsc", 0.05, 20, 16384, 3), (None, "awgn", 4.0, 5, 256, 2),
              (None, "bsc", 0.03, 5, 256, 2)]
#: the compat-rewired extension codes (bench.py's ``*_compat_vs_c`` rows),
#: as STACK_COMPAT: (code, channel, point), 256 lanes x 2, timeout 50 per
#: bit (the plain machine walks every timed-out frame to its budget)
FANO_COMPAT = [("k9-r12", "awgn", 8.0), ("k9-r12", "bsc", 0.01),
               ("k15-r14-16qam", "awgn", 14.0), ("k15-r14-16qam", "bsc", 0.005)]


def check_fano_edges(torch, dev, stats):
    """Kernels 8 and 10 against the plain machine at FANO_EDGES (more frames
    than resident threads, frames too long for shared memory) and on the
    compat-rewired codes (FANO_COMPAT), exact: per-lane counters, and
    every output of every frame."""
    from convolutional_codes_tpu_torch import get_code
    from convolutional_codes_tpu_torch.models.codebook import PARITY_COMPAT
    from convolutional_codes_tpu_torch.ops import fano, fano_cuda, fano_mc, mc_datagen, stack_mc
    from convolutional_codes_tpu_torch.ops.channels import awgn_sigma

    cases = [(ck, get_code(0).replace(name="k3-r12-long", block_length=600) if ck is None
              else get_code(ck), ch, pt, tpb, lanes, fpl)
             for ck, ch, pt, tpb, lanes, fpl in FANO_EDGES]
    cases += [("compat", get_code(ck).replace(name=f"{ck}-compat", parity=PARITY_COMPAT), ch,
               pt, 50, 256, 2) for ck, ch, pt in FANO_COMPAT]
    for ck, code, channel, point, tpb, lanes, fpl in cases:
        soft = channel == "awgn"
        param = float(awgn_sigma(point)) if soft else point
        T = code.num_block_symbols
        plan, resident = fano_mc.fano_plan(T), {}
        for mc in (True, False):
            occ = fano_mc.occupancy(mc, plan, dev.index)
            resident[mc] = occ["sms"] * occ["blocks_per_sm"] * plan.threads
        gids = torch.arange(lanes * fpl, device=dev)
        bits, syms = mc_datagen.frames_cuda(code, gids, 17, param, channel)
        plain = fano.fano_machine(code, syms, soft, tpb)
        own = torch.zeros((3, lanes), dtype=torch.int64, device=dev)
        stack_mc.count_errors(own, gids // fpl, plain[0], bits, plain[1]["iters"])
        k = fano_mc.mc_fano(code, lanes, fpl, 17, param, channel, timeout_per_bit=tpb,
                            device=dev)
        diff = int((k != own).any(0).sum())
        stats["mc_fano"] = max(stats["mc_fano"], float((k - own).abs().max()))
        got = fano_cuda.fano_decode_cuda(code, syms, soft, tpb, with_diag=True)
        torch.cuda.synchronize()
        bad, err = supplied_diff(torch, got, plain)
        stats["fano_decode"] = max(stats["fano_decode"], err)
        print(f"kernels 8/10 {code.name} T={T} {channel} {point:g}, {lanes} lanes x {fpl} "
              f"({lanes * fpl} frames; records in {'shared' if plan.nodes_shared else 'device'}"
              f" memory; resident threads: kernel 8 {resident[True]}, kernel 10 "
              f"{resident[False]}): kernel 8 {diff}/{lanes} lanes differ from the plain "
              f"machine, kernel 10 outputs {'equal' if not bad else bad}; timed out "
              f"{int(plain[1]['timed_out'].sum())}")
        require(diff == 0 and not bad, f"kernels 8/10 vs plain at {code.name} {channel}")
        require(ck is not None or not plan.nodes_shared, "long frames not in device memory")
        require(ck in (None, "compat") or lanes * fpl > max(resident.values()),
                "fewer frames than resident threads")


#: kernels 7 and 9 at the edges of their launch plan: (code, channel, point,
#: lanes, frames per lane); None is code 0's polynomials with block_length
#: 900 (T = 902: path bits in device memory).  More frames than resident
#: walks, lanes not a multiple of a block, one frame a lane at 5 and 1000
#: lanes.
STACK_EDGES = [(0, "bsc", 0.05, 16384, 3), (0, "awgn", 4.0, 1021, 2),
               (None, "awgn", 4.0, 256, 2), (None, "bsc", 0.03, 256, 2),
               (0, "awgn", 3.0, 5, 1), (0, "awgn", 3.0, 1000, 1)]
#: the compat-rewired extension codes (bench.py's ``*_compat_vs_c`` rows):
#: (code, channel, point), 256 lanes x 2
STACK_COMPAT = [("k9-r12", "awgn", 8.0), ("k9-r12", "bsc", 0.01),
                ("k15-r14-16qam", "awgn", 14.0), ("k15-r14-16qam", "bsc", 0.005)]


def check_stack_edges(torch, dev, stats):
    """Kernels 7 and 9 against the plain machine at STACK_EDGES and on the
    compat-rewired codes (STACK_COMPAT), each under its code's plan:
    per-lane counters on the kernel's own frames and every output of every
    frame exact; on BSC also against the plain version on its own datagen's
    frames, which equal the kernel's."""
    from convolutional_codes_tpu_torch import get_code
    from convolutional_codes_tpu_torch.models.codebook import PARITY_COMPAT
    from convolutional_codes_tpu_torch.ops import mc_datagen, stack, stack_cuda, stack_mc
    from convolutional_codes_tpu_torch.ops.channels import awgn_sigma

    cases = [(get_code(0).replace(name="k3-r12-long", block_length=900) if ck is None
              else get_code(ck), ch, pt, lanes, fpl) for ck, ch, pt, lanes, fpl in STACK_EDGES]
    cases += [(get_code(ck).replace(name=f"{ck}-compat", parity=PARITY_COMPAT), ch, pt, 256, 2)
              for ck, ch, pt in STACK_COMPAT]
    for code, channel, point, lanes, fpl in cases:
        soft = channel == "awgn"
        param = float(awgn_sigma(point)) if soft else point
        gids = torch.arange(lanes * fpl, device=dev)
        bits, syms = mc_datagen.frames_cuda(code, gids, 23, param, channel)
        plain = stack.stack_machine(code, syms, soft)
        own = torch.zeros((3, lanes), dtype=torch.int64, device=dev)
        stack_mc.count_errors(own, gids // fpl, plain[0], bits, plain[2])
        if not soft:   # the plain version's own frames are the kernel's
            require(torch.equal(stack_mc.mc_stack_ref(code, lanes, fpl, 23, param, channel,
                                                      device=dev), own),
                    f"{code.name} BSC: the plain datagen's counters differ")
        plan = stack_mc.code_plan(code)
        k = stack_mc.mc_stack(code, lanes, fpl, 23, param, channel, device=dev)
        got = stack_cuda.stack_machine_cuda(code, syms, soft)
        torch.cuda.synchronize()
        diff = int((k != own).any(0).sum())
        stats["mc_stack"] = max(stats["mc_stack"], float((k - own).abs().max()))
        bad, err = supplied_diff(torch, (got[0], {"metric": got[1], "iters": got[2]}),
                                 (plain[0], {"metric": plain[1], "iters": plain[2]}))
        stats["stack_decode"] = max(stats["stack_decode"], err)
        walks = {mc: stack_mc.occupancy(mc, plan, dev.index)["blocks_per_sm"]
                 * plan.threads * SMS for mc in (True, False)}
        print(f"kernels 7/9 {code.name} T={code.num_block_symbols} {channel} {point:g}, "
              f"{lanes} lanes x {fpl} ({lanes * fpl} frames, iterations max "
              f"{int(plain[2].max())}; path bits in "
              f"{'shared' if plan.bits_shared else 'device'} memory, resident walks "
              f"{walks[True]}/{walks[False]}): kernel 7 {diff}/{lanes} lanes differ from the "
              f"plain machine, kernel 9 outputs {'equal' if not bad else bad}")
        require(diff == 0 and not bad, f"kernels 7/9 vs plain at {code.name} {channel}")
        if (lanes, fpl) == STACK_EDGES[0][3:]:
            require(lanes * fpl > walks[True], "fewer frames than resident walks")
        require(code.block_length != 900 or not plan.bits_shared,
                "long frames' path bits not in device memory")


#: kernels 7 and 8 with a lane offset: (channel, point); code 0, lane0 =
#: LANE0_LANES lanes into a point of twice as many, 2 frames a lane, Fano
#: timeout 40 per bit
LANE0_CASES = [("awgn", 4.0), ("bsc", 0.03)]
LANE0_LANES = 4096


def check_lane_offset(torch, dev, stats):
    """Kernels 7 and 8 with ``lane0`` != 0: per lane against their plain
    versions with the same lane0 (on the kernel's own frames: exact; on
    BSC also on the plain datagen's frames, which are the kernel's), and
    against the matching lane slice of one launch of twice the lanes."""
    from convolutional_codes_tpu_torch import get_code
    from convolutional_codes_tpu_torch.ops import fano_mc, mc_datagen, stack_mc
    from convolutional_codes_tpu_torch.ops.channels import awgn_sigma

    code, lanes, fpl, seed = get_code(0), LANE0_LANES, 2, 77
    for decoder in ("stack", "fano"):
        mc, ref = ((stack_mc.mc_stack, stack_mc.mc_stack_ref) if decoder == "stack"
                   else (fano_mc.mc_fano, fano_mc.mc_fano_ref))
        kw = {"timeout_per_bit": 40} if decoder == "fano" else {}
        for channel, point in LANE0_CASES:
            soft = channel == "awgn"
            param = float(awgn_sigma(point)) if soft else point
            k = mc(code, lanes, fpl, seed, param, channel, device=dev, lane0=lanes, **kw)
            whole = mc(code, 2 * lanes, fpl, seed, param, channel, device=dev, **kw)
            f = torch.arange(lanes * fpl, device=dev)
            bits, syms = mc_datagen.frames_cuda(code, lanes * fpl + f, seed, param, channel)
            plain = decode_plain(decoder, code, syms, soft, kw.get("timeout_per_bit", 0))
            own = torch.zeros_like(k)
            stack_mc.count_errors(own, f // fpl, plain[0], bits, plain[1]["iters"])
            torch.cuda.synchronize()
            diff = int((k != own).any(0).sum())
            sliced = int((k != whole[:, lanes:]).any(0).sum())
            stats["mc_" + decoder] = max(stats["mc_" + decoder], float((k - own).abs().max()))
            if not soft:
                require(torch.equal(ref(code, lanes, fpl, seed, param, channel, device=dev,
                                        lane0=lanes, **kw), own),
                        f"{decoder} lane0 BSC: the plain datagen's counters differ")
            print(f"kernel {7 if decoder == 'stack' else 8} lane0={lanes}, {lanes} lanes x "
                  f"{fpl}, code 0 {channel} {point:g}: {diff}/{lanes} lanes differ from the "
                  f"plain machine on frames {lanes * fpl}..{2 * lanes * fpl - 1}, {sliced}/"
                  f"{lanes} from lanes {lanes}.. of one {2 * lanes}-lane launch; bit errors "
                  f"{int(k[0].sum())}")
            require(diff == 0 and sliced == 0 and int(k[0].sum()) > 0,
                    f"{decoder} lane0 {channel}: kernel differs")


LONGFRAME_CASES = [  # tests/test_fused_longframe.py:41-51: (code, channel, point, demapper)
    ("k3-75", "bsc", 0.0125, "soft"), ("k3-75", "awgn", 4.0, "soft"),
    ("k3-75", "awgn", 4.0, "hard"), ("nasa-k7", "awgn", 3.0, "soft"),
    ("k9-r12", "awgn", 1.5, "soft")]
#: the real-data decode shapes of bench.py:394-398, (frames B, symbols T)
LONGFRAME_DECODE_SHAPES = ((128, 65536), (1024, 16384))


def payload_errors(torch, code, stream_bits, dists, W, hard):
    """Per-lane payload bit errors of one whole-stream decode by kernels 4-5
    from zero start metrics (tests/test_fused_longframe.py's
    monolithic_counts): ``dists`` [B, span, M], payload rows W .. span-W."""
    from convolutional_codes_tpu_torch.ops import longframe_cuda as lc
    from convolutional_codes_tpu_torch.utils.bitops import first_argmin

    B, span = stream_bits.shape
    d_tmb = dists.permute(1, 2, 0).contiguous()
    fm, dec = lc.stream_acs_cuda(code, d_tmb, torch.zeros((code.num_states, B),
                                                         device=dists.device), hard)
    out, _ = lc.stream_traceback_cuda(code, dec, first_argmin(fm, dim=0).to(torch.int32))
    pay = slice(W, span - W)
    return (out.T[:, pay] != stream_bits[:, pay]).sum(1, dtype=torch.int32)


def check_longframe_kernels(torch, dev, stats):
    """Kernels 4-6: the streaming ACS and traceback bit-exact against their
    plain versions; the long-frame MC kernel per lane against its plain
    version and against a whole-stream decode of the same stream by
    kernels 4-5.  (Phase 5 holds all three against their plain versions
    at the main path's shapes.)"""
    from convolutional_codes_tpu_torch import get_code
    from convolutional_codes_tpu_torch.ops import fused_longframe as fl
    from convolutional_codes_tpu_torch.ops import longframe_cuda as lc
    from convolutional_codes_tpu_torch.ops.channels import awgn_sigma
    from convolutional_codes_tpu_torch.ops.viterbi import HARD_METRIC_SAT
    from convolutional_codes_tpu_torch.utils.bitops import first_argmin

    g = torch.Generator(device=dev).manual_seed(2025)
    B = 128
    # every S from 4 to 256: the step is pipelined from S = 8 to 64
    for name in ("k3-75", "k4-r12", "k5-r12", "k6-r12", "nasa-k7", "k8-r12", "k9-r12"):
        code = k8_code() if name == "k8-r12" else get_code(name)
        M, S = code.points_per_symbol, code.num_states
        # soft from random start metrics at T = 8192 and 4097 (odd, not a
        # whole number of chunks); tie-heavy hard integer metrics from the
        # pinned start at T = 7777
        for hard, T in ((False, 8192), (True, 7777), (False, 4097)):
            if hard:
                d = torch.randint(0, code.symlen_out + 1, (T, M, B), generator=g,
                                  device=dev).to(torch.float32)
                init = torch.full((S, B), float(HARD_METRIC_SAT), device=dev)
                init[0] = 0.0
            else:
                d = torch.rand((T, M, B), generator=g, device=dev) * 8.0
                init = torch.rand((S, B), generator=g, device=dev) * 8.0
            fm, dec = lc.stream_acs_cuda(code, d, init, hard)
            fm_r, dec_r = lc.stream_acs_ref(code, d, init, hard)
            err = float((fm - fm_r).abs().max())
            require(err == 0.0 and torch.equal(dec, dec_r),
                    f"stream ACS kernel vs plain {name} hard={hard}: max err {err}, "
                    f"{int((dec != dec_r).sum())} decision words differ")
            start = first_argmin(fm, dim=0).to(torch.int32)
            bits, carry = lc.stream_traceback_cuda(code, dec, start)
            bits_r, carry_r = lc.stream_traceback_ref(code, dec, start)
            require(torch.equal(bits, bits_r) and torch.equal(carry, carry_r),
                    f"stream traceback kernel vs plain {name} hard={hard}")
            hi, mid = lc.stream_traceback_cuda(code, dec[T // 2:].contiguous(), start)
            lo, carry0 = lc.stream_traceback_cuda(code, dec[:T // 2].contiguous(), mid)
            require(torch.equal(torch.cat([lo, hi]), bits) and torch.equal(carry0, carry),
                    f"two-segment stream traceback {name} hard={hard}")
            stats["stream_acs"] = max(stats["stream_acs"], err)
            stats["stream_traceback"] = max(stats["stream_traceback"],
                                            float((bits - bits_r).abs().max()))
        print(f"stream kernels vs plain {name} (S={S}, B={B}): soft T=8192 and 4097, hard "
              "T=7777 bit-exact, two-segment traceback through the carry equal (tolerance 0)")
    # kernel 4's two-step body (S = 64, M = 2-16): at M = 4 a frame of one
    # chunk of 37 steps (18 pairs and a radix-2 step), at M = 2, 8 and 16
    # last chunks of an odd number of steps, soft and tie-heavy hard
    for code, T in ((get_code("nasa-k7"), 37), (k7_code(1), 1001), (k7_code(3), 1001),
                    (k7_code(4), 1001)):
        for hard in (False, True):
            S, M = code.num_states, code.points_per_symbol
            if hard:
                d = torch.randint(0, code.symlen_out + 1, (T, M, B), generator=g,
                                  device=dev).to(torch.float32)
                init = torch.full((S, B), float(HARD_METRIC_SAT), device=dev)
                init[0] = 0.0
            else:
                d = torch.rand((T, M, B), generator=g, device=dev) * 8.0
                init = torch.rand((S, B), generator=g, device=dev) * 8.0
            got = lc.stream_acs_cuda(code, d, init, hard)
            want = lc.stream_acs_ref(code, d, init, hard)
            require(all(torch.equal(a, w) for a, w in zip(got, want)),
                    f"stream ACS kernel vs plain {code.name} (M={M}) T={T} hard={hard}")
    print(f"stream ACS two-step body vs plain (S=64, B={B}): M=4 T=37, M=2, 8, 16 T=1001, "
          "soft and hard, bit-exact (tolerance 0)")

    lanes, W, Wn, nsteps = 1024, 128, 256, 3
    for ck, channel, point, dem in LONGFRAME_CASES:
        code = get_code(ck)
        param = float(awgn_sigma(point)) if channel == "awgn" else point
        kw = dict(channel=channel, demapper=dem, window=Wn, warmup=W)
        be, we = fl.mc_longframe_viterbi(code, lanes, nsteps, 7, param, device=dev, **kw)
        be_r, we_r = fl.mc_longframe_viterbi_ref(code, lanes, nsteps, 7, param, device=dev,
                                                 **kw)
        diff = int(((be != be_r) | (we != we_r)).sum())
        stats["mc_longframe"] = max(stats["mc_longframe"], float(
            torch.maximum((be - be_r).abs(), (we - we_r).abs()).max()))
        bits, dists = fl.stream_segment_host(code, torch.arange(lanes, device=dev), 7, param,
                                             channel, -W, 2 * W + nsteps * Wn, dem)
        mono = payload_errors(torch, code, bits, dists, W, channel == "bsc")
        mono_diff = int((be != mono).sum())
        tag = f"long-frame kernel {code.name} {channel}/{dem}"
        print(f"{tag}: {diff}/{lanes} lanes differ from the plain version, "
              f"{mono_diff}/{lanes} from the whole-stream decode by kernels 4-5; "
              f"bit errors {int(be.sum())} (plain {int(be_r.sum())}, whole-stream "
              f"{int(mono.sum())})")
        limit = 0 if channel == "bsc" else lanes // 100
        require(diff <= limit, f"{tag} vs plain: {diff} lanes differ")
        require(mono_diff <= limit, f"{tag} vs whole-stream decode: {mono_diff} lanes differ")


def random_decisions(torch, S, T, B, gen):
    """Uniformly random packed decisions [T, nwords, B] int32 (bits >= S
    are 0, as the ACS kernel writes them): every survivor path is possible."""
    words = torch.randint(-2 ** 31, 2 ** 31, (T, (S + 31) // 32, B), generator=gen,
                          device=gen.device, dtype=torch.int64)
    if S < 32:
        words &= (1 << S) - 1
    return words.to(torch.int32)


def check_traceback_designs(torch, dev, stats):
    """Kernels 5 (from given start states) and 2 (from the first state of
    least final metric; integer metrics: ties) on both designs, each forced
    through the plan, against their plain versions, bit for bit: at the
    segment edges (T = L-1, L, L+1) and at T = 7777, at B = 1 and at the
    plan's crossover B; and a traceback of two segments chained through
    the carry on the segment design."""
    from convolutional_codes_tpu_torch import get_code
    from convolutional_codes_tpu_torch.ops import longframe_cuda as lc
    from convolutional_codes_tpu_torch.ops import viterbi_cuda as vc

    gen = torch.Generator(device=dev).manual_seed(2026)
    L = vc.SEGMENT_ROWS
    for name in ("k3-75", "nasa-k7", "k9-r12"):
        code = get_code(name)
        S = code.num_states
        for B in (1, vc.frame_walk_min_frames(S)):
            for T in (L - 1, L, L + 1, 7777):
                dec = random_decisions(torch, S, T, B, gen)
                start = torch.randint(0, S, (B,), generator=gen, device=dev, dtype=torch.int32)
                fm = torch.randint(0, 3, (S, B), generator=gen, device=dev).to(torch.float32)
                want = lc.stream_traceback_ref(code, dec, start) + vc.traceback_ref(code, dec, fm)
                for plan in (vc.TracebackPlan("frame", T), vc.TracebackPlan("segments", L)):
                    got = (lc.stream_traceback_cuda(code, dec, start, plan)
                           + vc.traceback_cuda(code, dec, fm, plan))
                    same = all(torch.equal(a, b) for a, b in zip(got, want))
                    require(same, f"traceback {plan} vs plain {name} B={B} T={T}")
                    stats["stream_traceback"] = max(stats["stream_traceback"], float(
                        (got[0] - want[0]).abs().max()))
                    stats["traceback"] = max(stats["traceback"], float(
                        (got[2] - want[2]).abs().max()))
                del dec
        print(f"traceback designs vs plain {name} (S={S}): per frame and segments of {L}, "
              f"T in ({L - 1}, {L}, {L + 1}, 7777), B = 1 and the crossover, "
              "start states and argmin: bit-exact (tolerance 0)")
        T, B = 7777, 128
        dec = random_decisions(torch, S, T, B, gen)
        start = torch.randint(0, S, (B,), generator=gen, device=dev, dtype=torch.int32)
        seg = vc.TracebackPlan("segments", L)
        bits, carry = lc.stream_traceback_cuda(code, dec, start, seg)
        hi, mid = lc.stream_traceback_cuda(code, dec[T // 2:].contiguous(), start, seg)
        lo, carry0 = lc.stream_traceback_cuda(code, dec[:T // 2].contiguous(), mid, seg)
        require(torch.equal(torch.cat([lo, hi]), bits) and torch.equal(carry0, carry)
                and torch.equal(bits, lc.stream_traceback_ref(code, dec, start)[0]),
                f"two-segment traceback on the segment design {name}")


def k7_code(symlen: int):
    """A K = 7 code of 2^symlen points (rate 1/symlen: (171), (133, 171,
    165), (117, 127, 155, 171) octal), for kernel 4's two-step body at M =
    2, 8 and 16 beside nasa-k7's 4."""
    from convolutional_codes_tpu_torch.models.codebook import Code
    polys = {1: (0o171,), 3: (0o133, 0o171, 0o165), 4: (0o117, 0o127, 0o155, 0o171)}[symlen]
    return Code(name=f"k7-r1{symlen}", symlen_out=symlen, constraint_length=7,
                block_length=40, polynomials=polys)


def k8_code():
    """A 128-state code (K = 8, rate 1/2, true parity; none of the shipped
    codes has 128 states) for kernel 6's groups of 4 threads a lane."""
    from convolutional_codes_tpu_torch.models.codebook import Code
    return Code(name="k8-r12", symlen_out=2, constraint_length=8, block_length=40,
                polynomials=(0b10100111, 0b11111001))   # octal (247, 371), d_free 10


def check_longframe_lanes(torch, dev, stats):
    """Kernel 6 at 1021 lanes, which no block of 128 and no thread group
    divides, with windows of 255 + 2 x 64 = 383 symbols (odd; 319 stored
    rows, no whole number of packed words), on LONGFRAME_CASES and on a
    128-state code (groups of 4 threads a lane; k9-r12 has groups of 8),
    against its plain version and a whole-stream decode by kernels 4-5:
    BSC exact, AWGN at most 1% of lanes different."""
    from convolutional_codes_tpu_torch import get_code
    from convolutional_codes_tpu_torch.ops import fused_longframe as fl
    from convolutional_codes_tpu_torch.ops.channels import awgn_sigma

    lanes, W, Wn, nsteps = 1021, 64, 255, 2
    for ck, channel, point, dem in LONGFRAME_CASES + [("k8-r12", "awgn", 3.0, "soft")]:
        code = k8_code() if ck == "k8-r12" else get_code(ck)
        param = float(awgn_sigma(point)) if channel == "awgn" else point
        kw = dict(channel=channel, demapper=dem, window=Wn, warmup=W)
        be_r, we_r = fl.mc_longframe_viterbi_ref(code, lanes, nsteps, 7, param, device=dev,
                                                 **kw)
        bits, dists = fl.stream_segment_host(code, torch.arange(lanes, device=dev), 7, param,
                                             channel, -W, 2 * W + nsteps * Wn, dem)
        mono = payload_errors(torch, code, bits, dists, W, channel == "bsc")
        limit = 0 if channel == "bsc" else lanes // 100
        be, we = fl.mc_longframe_viterbi(code, lanes, nsteps, 7, param, device=dev, **kw)
        diff = int(((be != be_r) | (we != we_r)).sum())
        mono_diff = int((be != mono).sum())
        stats["mc_longframe"] = max(stats["mc_longframe"], float(
            torch.maximum((be - be_r).abs(), (we - we_r).abs()).max()))
        tag = (f"long-frame kernel {code.name} {channel}/{dem}, "
               f"{fl.threads_per_lane(code.num_states)} thread(s) a lane")
        print(f"{tag}, {lanes} lanes: {diff} differ from the plain version, "
              f"{mono_diff} from the whole-stream decode")
        require(diff <= limit, f"{tag} vs plain: {diff} lanes differ")
        require(mono_diff <= limit, f"{tag} vs whole-stream decode: {mono_diff}")


#: phase 3's random user codes: (K, symlen, parity) of each draw, the rest
#: (polynomials with the top bit set, block length 8-48 with one at 8,
#: stack/Fano metrics and weights) drawn from RANDOM_CODE_SEED.  K covers
#: every S of CC_DISPATCH (4 .. 256), symlen 2-8, both parity modes with
#: compat at K >= 5 (the quirk's register bits), and (S, M) pairs no
#: registered code uses (S = 128 with M = 8, S = 256 with M = 16, S = 64
#: with M = 32, S = 128 with M = 256; the last two with WIDE_BITS'
#: constellations)
RANDOM_CODE_PLAN = [(3, 3, "true"), (4, 4, "compat"), (5, 2, "compat"), (6, 3, "compat"),
                    (7, 4, "true"), (8, 3, "compat"), (9, 2, "true"), (9, 4, "compat"),
                    (7, 5, "compat"), (8, 8, "true")]
RANDOM_CODE_SEED = 2610
#: the big-K code of the check (kernels 9-10): K 28-32, rate 1/2
RANDOM_BIG_K_SEED = 2611
#: kernels 7-8's points in the check, 256 lanes x 1 frame (the plain stack
#: machine has no budget: clean points keep its walks short)
RANDOM_SEQ_POINTS = (("bsc", 0.01), ("awgn", 8.0))


#: symbol widths beyond the registered constellations (1-4 bits) that the
#: checks register rect_points for, as a user of codes of rate 1/5 to 1/8
#: would register their own
WIDE_BITS = (5, 8)


def rect_points(bits: int):
    """A rectangular 2^ceil(b/2) x 2^floor(b/2) grid of unit average power
    (float32 [2^b, 2])."""
    nx, ny = 1 << ((bits + 1) // 2), 1 << (bits // 2)
    pts = np.array([(x, y) for x in np.arange(nx) * 2 - (nx - 1)
                    for y in np.arange(ny) * 2 - (ny - 1)], np.float64)
    return (pts / np.sqrt((pts ** 2).sum(1).mean())).astype(np.float32)


def register_wide_constellations() -> None:
    """Register rect_points for WIDE_BITS in the port (where not yet)."""
    from convolutional_codes_tpu_torch.models import constellations
    for bits in WIDE_BITS:
        constellations.register_constellation(bits, rect_points(bits), overwrite=True)


def random_codes():
    """The drawn codes of the random-code check: RANDOM_CODE_PLAN's and one
    big-K code, each a ``Code`` of the port."""
    from convolutional_codes_tpu_torch.models.codebook import Code

    rng = np.random.default_rng(RANDOM_CODE_SEED)
    codes = []
    for i, (K, symlen, parity) in enumerate(RANDOM_CODE_PLAN):
        polys = tuple(int(rng.integers(1, 1 << K)) | (1 << (K - 1)) for _ in range(symlen))
        wrong = -int(rng.integers(5, 60))
        codes.append(Code(
            name=f"random-{i}", symlen_out=symlen, constraint_length=K,
            block_length=8 if i == 0 else int(rng.integers(8, 49)), polynomials=polys,
            bit_metrics=(1, wrong), fano_bit_metrics=(1, wrong - 5),
            metric_weight=-float(rng.integers(5, 26)),
            fano_metric_weight=-float(rng.integers(40, 221)), parity=parity))
    rng = np.random.default_rng(RANDOM_BIG_K_SEED)
    K = int(rng.integers(28, 33))
    polys = tuple(int(rng.integers(1, 1 << K)) | (1 << (K - 1)) for _ in range(2))
    wrong = -int(rng.integers(20, 50))
    codes.append(Code(name="random-big-k", symlen_out=2, constraint_length=K,
                      block_length=int(rng.integers(12, 20)), polynomials=polys,
                      bit_metrics=(1, wrong), fano_bit_metrics=(1, wrong - 8),
                      metric_weight=-9.0, fano_metric_weight=-13.0, parity="compat"))
    return codes


def oracle_frames(code, n: int, seed: int, sigma: float = 0.4, flip: float = 0.04):
    """n frames of random info bits through the C oracle's encoder (held
    equal to the port's), as noisy soft distances [n, T, M] float32 (the
    constellation's points plus Gaussian noise, squared distances over the
    demapper's ndist) and hard symbols [n, T] int32 (each coded bit flipped
    with probability ``flip``), from numpy."""
    import torch
    from convolutional_codes_tpu_torch.models.constellations import get_constellation
    from convolutional_codes_tpu_torch.ops.encoder import encode
    from convolutional_codes_tpu_torch.utils import native

    rng = np.random.default_rng(seed)
    T, M = code.num_block_symbols, code.points_per_symbol
    bits = rng.integers(0, 2, (n, code.block_length))
    syms = native.encode_blocks(code, bits)
    require(np.array_equal(encode(code, torch.as_tensor(bits)).numpy(), syms),
            f"{code.name}: the port's encoder differs from the oracle's")
    const = np.asarray(get_constellation(code.symlen_out), np.float32)
    d = (const[syms] + rng.normal(0.0, sigma, (n, T, 2)).astype(np.float32))[:, :, None] - const
    dists = ((d * d).sum(-1) / ((const[0] - const[1]) ** 2).sum()).astype(np.float32)
    flips = (rng.random((n, T, code.symlen_out)) < flip) << np.arange(code.symlen_out)
    return dists, (syms ^ flips.sum(-1)).astype(np.int32)


#: run in a child process by ``oracle_stack_isolated``: argv = the
#: repository and a directory holding jobs.pkl, a list of (code, frames,
#: soft); writes out.pkl, the C oracle's stack bits of each job
ORACLE_STACK_WORKER = r"""
import pickle
import sys
sys.path.insert(0, sys.argv[1])
from convolutional_codes_tpu_torch.utils import native
with open(f"{sys.argv[2]}/jobs.pkl", "rb") as f:
    jobs = pickle.load(f)
out = [(native.stack_soft_blocks if soft else native.stack_hard_blocks)(code, x)
       for code, x, soft in jobs]
with open(f"{sys.argv[2]}/out.pkl", "wb") as f:
    pickle.dump(out, f)
"""


def oracle_stack_isolated(jobs):
    """The C oracle's stack decode of each (code, frames, soft) job, in a
    child process: on the stack's alias corner (ROADMAP Q3) the oracle
    writes a byte past its row, which must not reach this process's
    memory."""
    import pickle
    with tempfile.TemporaryDirectory() as tmp:
        with open(os.path.join(tmp, "jobs.pkl"), "wb") as f:
            pickle.dump(jobs, f)
        proc = subprocess.run([sys.executable, "-c", ORACLE_STACK_WORKER, ROOT, tmp],
                              capture_output=True, text=True, timeout=600)
        require(proc.returncode == 0, f"the oracle's stack decode failed: {proc.stderr[-2000:]}")
        with open(os.path.join(tmp, "out.pkl"), "rb") as f:
            return pickle.load(f)


def check_random_codes(torch, dev, stats):
    """Random user codes (RANDOM_CODE_PLAN and a big-K code) through every
    kernel whose limits admit them: kernels 1-2 and 10 against the C
    oracle (``utils/native.py``) bit for bit on noisy frames, kernel 9
    against the plain machine (and the oracle's differing frames counted:
    the stack's alias corner, where the oracle and the JAX package part
    ways, ROADMAP Q3; the oracle's stack decode runs in a child process,
    ``oracle_stack_isolated``), kernels 4-5
    against the plain streaming decode on terminated streams, kernels 3, 6,
    7 and 8 against their plain versions (BSC counters exact, AWGN lanes
    that differ counted; 0 expected).  A kernel is skipped only where the
    JAX package's counterpart refuses the code too: kernel 3 above 8
    points (``fused_mc_eligible``).  The codes of 5 and 8 coded bits a
    symbol run with WIDE_BITS' constellations registered."""
    from convolutional_codes_tpu_torch.models.trellis import quirk_mask_low
    from convolutional_codes_tpu_torch.ops import fano_cuda, fano_mc, stack_mc
    from convolutional_codes_tpu_torch.ops import fused_chain as fc
    from convolutional_codes_tpu_torch.ops import fused_longframe as fl
    from convolutional_codes_tpu_torch.ops import mc_datagen
    from convolutional_codes_tpu_torch.ops import viterbi_cuda as vc
    from convolutional_codes_tpu_torch.ops.channels import awgn_sigma
    from convolutional_codes_tpu_torch.ops.viterbi import (
        KERNEL_MAX_STATES, viterbi_decode_hard, viterbi_decode_soft)
    from convolutional_codes_tpu_torch.parallel.streaming import long_frame_decode_stream
    from convolutional_codes_tpu_torch.utils import native

    require(native.available(), "the C oracle does not build (gcc)")
    t_all = time.time()
    register_wide_constellations()
    codes = random_codes()
    frames = [oracle_frames(c, 512, c.constraint_length + 7 * c.points_per_symbol)
              for c in codes]
    stack_oracle = iter(oracle_stack_isolated(
        [(c, x, soft) for c, (d, rx) in zip(codes, frames) for soft, x in ((True, d), (False, rx))]))
    print(f"the C oracle's stack decode of the random codes in a child process "
          f"[{time.time() - t_all:.1f} s with the frames]")
    for code, (dists, rx) in zip(codes, frames):
        t0 = time.time()
        S, M, T = code.num_states, code.points_per_symbol, code.num_block_symbols
        quirk = code.parity == "compat" and any(
            p & quirk_mask_low(code.constraint_length) for p in code.polynomials)
        print(f"random code {code.name}: K={code.constraint_length} (S={S}) symlen="
              f"{code.symlen_out} (M={M}) L={code.block_length} T={T} polys="
              f"{[oct(p) for p in code.polynomials]} parity={code.parity}"
              f"{' (the quirk bites)' if quirk else ''} bit_metrics={code.bit_metrics} "
              f"fano_bit_metrics={code.fano_bit_metrics} metric_weight={code.metric_weight} "
              f"fano_metric_weight={code.fano_metric_weight}")
        done = []
        # kernels 1-2: the Viterbi decoders on the oracle's frames
        if S <= KERNEL_MAX_STATES:
            n = (vc.acs_forward_cuda.launches, vc.traceback_cuda.launches)
            vs = viterbi_decode_soft(code, torch.as_tensor(dists, device=dev))
            vh, vm = viterbi_decode_hard(code, torch.as_tensor(rx, device=dev))
            torch.cuda.synchronize()
            require((vc.acs_forward_cuda.launches, vc.traceback_cuda.launches)
                    == (n[0] + 2, n[1] + 2), f"{code.name}: kernels 1-2 did not launch")
            ob, (hb, hm) = native.viterbi_soft_blocks(code, dists), native.viterbi_hard_blocks(
                code, rx)
            require(np.array_equal(vs.cpu().numpy(), ob), f"{code.name}: kernels 1-2 soft")
            require(np.array_equal(vh.cpu().numpy(), hb) and np.array_equal(vm.cpu().numpy(), hm),
                    f"{code.name}: kernels 1-2 hard (bits or path metrics)")
            done.append("1-2 = oracle (512 frames, soft; hard bits and metrics)")
            # kernels 4-5: a terminated stream of 3,000 symbols, soft and hard
            g = torch.Generator(device=dev).manual_seed(code.constraint_length)
            _, d = awgn_frames(torch, code, 16, 3000, 3.0, g)
            xor = torch.randint(0, M, (16, 3000, 1), generator=g, device=dev) ^ torch.arange(
                M, device=dev)
            hd = sum((xor >> k) & 1 for k in range(code.symlen_out)).to(torch.float32)
            for hard, x in ((False, d), (True, hd)):
                got = long_frame_decode_stream(code, x, hard)
                want = long_frame_decode_stream(code, x.cpu(), hard)
                require(torch.equal(got.cpu(), want), f"{code.name}: kernels 4-5 hard={hard}")
            done.append("4-5 = plain (16 x 3000, soft and hard)")
        # kernels 9-10: 512 noisy frames, soft and hard: kernel 9 against the
        # plain machine (every output) and the oracle's bits, kernel 10
        # against the oracle (bits and timeouts)
        alias = []
        for soft, x in ((True, dists), (False, rx)):
            xt = torch.as_tensor(x, device=dev)
            got, want = decode_supplied("stack", code, xt, soft, 0), decode_plain(
                "stack", code, xt, soft, 0)
            fb, diag = fano_cuda.fano_decode_cuda(code, xt, soft, 1000, with_diag=True)
            torch.cuda.synchronize()
            bad, _ = supplied_diff(torch, got, want)
            require(not bad, f"{code.name}: kernel 9 soft={soft} vs the plain machine: {bad}")
            so = next(stack_oracle)
            alias.append(int((got[0].cpu().numpy() != so).any(1).sum()))
            fo, ft = (native.fano_soft_blocks if soft else native.fano_hard_blocks)(code, x, 1000)
            require(np.array_equal(fb.cpu().numpy(), fo)
                    and np.array_equal(diag["timed_out"].cpu().numpy().astype(np.int8), ft),
                    f"{code.name}: kernel 10 soft={soft} (bits or timeouts)")
        done.append(f"9 = plain (512 frames, soft and hard; {alias} frames off the oracle: the "
                    f"alias corner, ROADMAP Q3); 10 = oracle (timeouts at 1000 a bit: "
                    f"{int(ft.sum())} hard)")
        sigma, p = float(awgn_sigma(4.0)), 0.03
        # kernel 3: S <= 256 and M <= 8, as the JAX package's fused_mc_eligible
        # (wider codes take the modular chain, kernels 1-2, there as here);
        # kernel 6: S <= 256, any M, as the JAX package's kernel
        if S > fc.MAX_STATES:
            done.append(f"1-6 skipped: S = {S} (the JAX package's Viterbi kernels take S <= 256)")
        else:
            for ch, prm in (("bsc", p), ("awgn", sigma)):
                if M <= fc.MAX_POINTS:
                    kw = dict(channel=ch, block_lanes=1024, device=dev)
                    e, f = fc.mc_chain_viterbi(code, 8192, 2, 17, prm, **kw)
                    e_r, f_r = fc.mc_chain_viterbi_ref(code, 8192, 2, 17, prm, **kw)
                    lanes = int(((e != e_r) | (f != f_r)).sum())
                    require(lanes == 0 if ch == "bsc" else lanes <= 8192 // 100,
                            f"{code.name}: kernel 3 {ch}, {lanes} lanes differ")
                    stats["mc_chain"] = max(stats["mc_chain"], float((e - e_r).abs().max()))
                    done.append(f"3 {ch} {lanes}/8192 lanes off ({int(e.sum())} bit errors)")
                kw = dict(channel=ch, window=256, warmup=64, device=dev)
                be, we = fl.mc_longframe_viterbi(code, 1024, 2, 17, prm, **kw)
                be_r, we_r = fl.mc_longframe_viterbi_ref(code, 1024, 2, 17, prm, **kw)
                lanes = int(((be != be_r) | (we != we_r)).sum())
                require(lanes == 0 if ch == "bsc" else lanes <= 1024 // 100,
                        f"{code.name}: kernel 6 {ch}, {lanes} lanes differ")
                stats["mc_longframe"] = max(stats["mc_longframe"], float(
                    (be - be_r).abs().max()))
                done.append(f"6 {ch} {lanes}/1024 off ({int(be.sum())})")
            if M > fc.MAX_POINTS:
                done.append(f"3: M = {M} > 8 takes the modular chain (kernels 1-2), as the JAX "
                            "package's fused_mc_eligible sends it")
        # kernels 7-8: per lane against the plain machine on the kernel's own
        # frames (exact), and the plain datagen's counters (BSC: exact)
        for decoder, mc, ref in (("stack", stack_mc.mc_stack, stack_mc.mc_stack_ref),
                                 ("fano", fano_mc.mc_fano, fano_mc.mc_fano_ref)):
            kw = {"timeout_per_bit": 50} if decoder == "fano" else {}
            for ch, prm in RANDOM_SEQ_POINTS:
                prm = float(awgn_sigma(prm)) if ch == "awgn" else prm
                k = mc(code, 256, 1, 19, prm, ch, device=dev, **kw)
                gids = torch.arange(256, device=dev)
                bits, syms = mc_datagen.frames_cuda(code, gids, 19, prm, ch)
                plain = decode_plain(decoder, code, syms, ch == "awgn", kw.get("timeout_per_bit"))
                own = torch.zeros_like(k)
                stack_mc.count_errors(own, gids, plain[0], bits, plain[1]["iters"])
                r = ref(code, 256, 1, 19, prm, ch, device=dev, **kw)
                own_diff, ref_diff = int((k != own).any(0).sum()), int((k != r).any(0).sum())
                require(own_diff == 0 and (ch == "awgn" or ref_diff == 0),
                        f"{code.name}: kernel {7 if decoder == 'stack' else 8} {ch}: "
                        f"{own_diff} lanes off on its own frames, {ref_diff} off the plain")
                stats["mc_" + decoder] = max(stats["mc_" + decoder],
                                             float((k - own).abs().max()))
                done.append(f"{7 if decoder == 'stack' else 8} {ch} {ref_diff}/256 off")
        print(f"  {code.name}: kernels {'; '.join(done)} [{time.time() - t0:.1f} s]")
    print(f"random user codes: every kernel equal to the oracle or its plain version "
          f"[{time.time() - t_all:.1f} s]")


def run_main_path(torch, dev, gold, tmp):
    """The CLI's two code-0 sweeps and the modular chain; returns the
    z-checked rows."""
    from convolutional_codes_tpu_torch import get_code
    from convolutional_codes_tpu_torch.ops.channels import awgn_sigma
    from convolutional_codes_tpu_torch.parallel.montecarlo import sharded_accumulate
    from convolutional_codes_tpu_torch.sim import cli
    from convolutional_codes_tpu_torch.sim.chain import make_point_step
    from convolutional_codes_tpu_torch.sim.sweep import PointRecord
    from convolutional_codes_tpu_torch.utils.records import read_jsonl

    results = []
    for channel, scale in (("awgn", "0.1"), ("bsc", "0.01")):
        path = os.path.join(tmp, f"{channel}_viterbi_0.jsonl")
        rc = cli.main([channel, "--code", "0", "--decoder", "viterbi",
                       "--frames", "1048576", "--bits-scale", scale, "--jsonl", path])
        require(rc == 0, f"cli {channel} returned {rc}")
        results += [(channel, r) for r in read_jsonl(path, PointRecord)]

    code = get_code(0)
    frames, nsteps = 16384, 4
    for channel, point, param in (("awgn", 4.0, float(awgn_sigma(4.0))),
                                  ("bsc", 0.05, 0.05)):
        step = make_point_step(code, channel, "viterbi", frames=frames, device=dev)
        gen = torch.Generator(device=dev).manual_seed(31)
        t0 = time.time()
        be, fe, nb = sharded_accumulate(step, nsteps, gen, param)
        wall = time.time() - t0
        results.append((channel, PointRecord(
            code=code.name, channel=channel, decoder="viterbi-modular",
            demapper="soft", point=point, param=param, bits=nb, bit_errors=be,
            frame_errors=fe, frames=nb // code.block_length, ber=be / nb,
            fer=fe / (nb // code.block_length), wall_s=wall, bits_per_s=nb / wall)))
    return results


def traced_point(torch, tmp):
    """One more CLI point of the Viterbi path (code 0, AWGN 8 dB, its
    sweep's tier), run outside the launch counters' window, untraced and
    then with ``--trace``: the trace must hold kernel 3
    (``mc_chain_kernel``) among its CUDA kernels, which shows that CUPTI
    sees the kernels launched from the ctypes-bound libraries."""
    import glob
    from convolutional_codes_tpu_torch.sim import cli

    args = ["awgn", "--code", "0", "--decoder", "viterbi", "--frames", "1048576",
            "--bits-scale", "0.1", "--points", "8"]
    walls = {}
    for traced in (False, True):
        t0 = time.time()
        extra = ["--trace", os.path.join(tmp, "trace")] if traced else []
        require(cli.main(args + extra) == 0, "traced cli")
        walls[traced] = time.time() - t0
    files = glob.glob(os.path.join(tmp, "trace", "point_8", "*.pt.trace.json"))
    require(len(files) == 1, f"--trace wrote {files}")
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    chain = [e for e in kernels if "mc_chain_kernel" in e.get("name", "")]
    named = any(e.get("name") == "sweep_point_8" for e in events)
    print(f"  --trace: the trace of point 8 ({os.path.getsize(files[0])} bytes): "
          f"{len(kernels)} CUDA kernel events, {len(chain)} of mc_chain_kernel "
          f"({sum(e.get('dur', 0) for e in chain) / 1e3:.3f} ms of device time), "
          f"sweep_point_8 {'named' if named else 'MISSING'}; wall {walls[True]:.3f} s traced "
          f"(the profiler's start included), {walls[False]:.3f} s not")
    require(chain and named, "the trace does not name mc_chain_kernel and sweep_point_8")


def run_sequential_path(torch, dev, tmp, decoder: str, scale: str, grid_idx):
    """A stack or Fano main path: the CLI's code-0 AWGN sweep at a reduced
    ``--bits-scale``, then the sweep's own point function at the recording
    spec of results/bsc_<decoder>_0.jsonl (code 0, BSC, seed 1234, base 8e8,
    default grid) for the grid indices given; each of those must reproduce
    its committed counters exactly.  Returns the AWGN rows for the z-check."""
    from convolutional_codes_tpu_torch import get_code
    from convolutional_codes_tpu_torch.sim import cli
    from convolutional_codes_tpu_torch.parallel.mesh import one_slot
    from convolutional_codes_tpu_torch.sim.sweep import (
        BSC_CROSSOVER_GRID, PointRecord, SweepSpec, seq_plan, sequential_points, target_bits)
    from convolutional_codes_tpu_torch.utils.records import read_jsonl

    path = os.path.join(tmp, f"awgn_{decoder}_0.jsonl")
    rc = cli.main(["awgn", "--code", "0", "--decoder", decoder, "--bits-scale", scale,
                   "--jsonl", path])
    require(rc == 0, f"cli awgn {decoder} returned {rc}")
    results = [("awgn", r) for r in read_jsonl(path, PointRecord)]

    code = get_code(0)
    spec = SweepSpec(code=0, channel="bsc", decoder=decoder, seed=1234, base_bits=8e8)
    with open(os.path.join(ROOT, "results", f"bsc_{decoder}_0.jsonl")) as f:
        recorded = [json.loads(line) for line in f if line.strip()]
    for i in grid_idx:
        point = BSC_CROSSOVER_GRID[i]
        t0 = time.time()
        [(be, fe, nb, wb, ww)] = sequential_points(spec, code, [(i, point, float(point))],
                                                   one_slot(dev))
        wall = time.time() - t0
        rec = recorded[i]
        lanes, fpl = seq_plan(target_bits(spec, point), code.block_length)
        same = (be, fe, nb) == (rec["bit_errors"], rec["frame_errors"], rec["bits"])
        print(f"  bsc {decoder} p={point:g} ({lanes} lanes x {fpl}): bits={nb} "
              f"bit_errors={be} frame_errors={fe} vs recorded {rec['bits']} "
              f"{rec['bit_errors']} {rec['frame_errors']}: {'equal' if same else 'DIFFERENT'}; "
              f"wall {wall:.2f} s, warm {wb / ww if ww else float('nan'):.4e} bits/s")
        require(same, f"bsc {decoder} point {point}: counters differ from results/")
    return results


#: BASELINE configs 0 and 2 at bench.py:384-389's shapes:
#: (code, channel, point, lanes, windows); 1920-symbol windows, 128-symbol halos
LONGFRAME_CONFIGS = (("k3-75", "bsc", 0.0125, 131072, 4), ("nasa-k7", "awgn", 6.0, 65536, 2))


def awgn_frames(torch, code, B, T, snr_db, gen):
    """Terminated frames of T symbols through the port's encoder, mapper,
    AWGN channel and soft demapper on the generator's device: (info bits
    [B, T-K+1], distances [B, T, M])."""
    from convolutional_codes_tpu_torch.ops.channels import awgn, awgn_sigma
    from convolutional_codes_tpu_torch.ops.demapper import soft_demap
    from convolutional_codes_tpu_torch.ops.encoder import encode_stream
    from convolutional_codes_tpu_torch.ops.mapper import map_symbols

    bits = torch.randint(0, 2, (B, T - code.constraint_length + 1), generator=gen,
                         device=gen.device, dtype=torch.int32)
    rx = awgn(gen, map_symbols(code, encode_stream(code, bits)), awgn_sigma(snr_db))
    return bits, soft_demap(code.symlen_out, rx)


def run_longframe_path(torch, dev):
    """BASELINE configs 0 and 2 through ``streaming_mc_accumulate`` (kernel
    6), then the exact decode of supplied K=7 AWGN 6 dB frames through
    ``long_frame_decode_stream`` (kernels 4-5) at both real-data shapes."""
    from convolutional_codes_tpu_torch import get_code
    from convolutional_codes_tpu_torch.ops.channels import awgn_sigma
    from convolutional_codes_tpu_torch.parallel.streaming import (
        long_frame_decode_stream, streaming_mc_accumulate)

    for n, (ck, channel, point, lanes, windows) in enumerate(LONGFRAME_CONFIGS):
        code = get_code(ck)
        param = float(awgn_sigma(point)) if channel == "awgn" else point
        be, we, nb = streaming_mc_accumulate(code, lanes, windows, 4321 + n, param, channel,
                                             device=dev)
        ber = int(be.sum()) / nb
        print(f"  config {'02'[n]}: {code.name} {channel} {point:g}: {lanes} lanes x {windows} "
              f"windows, bits={nb} bit_errors={int(be.sum())} BER={ber:.4e} "
              f"windows with errors {int(we.sum())}")
        # the channel's raw error rate: p, or uncoded QPSK at 6 dB (2.4e-3)
        raw = point if channel == "bsc" else 2.4e-3
        require(nb == lanes * windows * 1920 and ber < raw / 10,
                f"long-frame config {ck}: BER {ber:.4e}")

    code = get_code("nasa-k7")
    gen = torch.Generator(device=dev).manual_seed(77)
    for B, T in LONGFRAME_DECODE_SHAPES:
        bits, d = awgn_frames(torch, code, B, T, 6.0, gen)
        out = long_frame_decode_stream(code, d)
        L = bits.shape[1]
        wrong = out[:, :L] != bits
        bad = int(wrong.any(1).sum())
        print(f"  decode supplied frames nasa-k7 AWGN 6 dB [{B}, {T}, 4]: bits={B * L} "
              f"bit_errors={int(wrong.sum())} BER={int(wrong.sum()) / (B * L):.4e} "
              f"frames with errors {bad}/{B}")
        require(bad <= B // 20, f"decode of [{B}, {T}] frames: {bad} frames with errors")


#: the supplied-frame path's shape (bench.py:211-227,427, the
#: awgn_stack_k3_soft_pool row): code 0, AWGN soft 8 dB, frames per step
SUPPLIED_FRAMES = 131072
#: (decoder, chain steps) at that shape
SUPPLIED_AWGN = (("stack", 2), ("fano", 1))
#: one BSC point per decoder: crossover, frames, Fano budget per bit (small
#: enough for the plain machine's walk on timed-out frames)
SUPPLIED_BSC = (0.05, 16384, 60)


def run_supplied_path(torch, dev):
    """The modular chain's stack and Fano steps on supplied symbols (kernels
    9-10): code 0 AWGN 8 dB at SUPPLIED_FRAMES frames per step under
    ``sharded_accumulate`` (returned for the z-check), then one BSC point per
    decoder whose counters must equal the plain machine's on the same
    frames, regenerated from the same seed by the chain's ``chain_frames``."""
    from convolutional_codes_tpu_torch import get_code
    from convolutional_codes_tpu_torch.ops.channels import awgn_sigma
    from convolutional_codes_tpu_torch.ops.fano import FANO_TIMEOUT
    from convolutional_codes_tpu_torch.parallel.montecarlo import sharded_accumulate
    from convolutional_codes_tpu_torch.sim.chain import chain_frames, make_point_step
    from convolutional_codes_tpu_torch.sim.sweep import PointRecord

    code = get_code(0)
    L, sigma = code.block_length, float(awgn_sigma(8.0))
    results = []
    for decoder, nsteps in SUPPLIED_AWGN:
        step = make_point_step(code, "awgn", decoder, frames=SUPPLIED_FRAMES, device=dev)
        gen = torch.Generator(device=dev).manual_seed(61)
        t0 = time.time()
        be, fe, nb = sharded_accumulate(step, nsteps, gen, sigma)
        torch.cuda.synchronize()
        wall = time.time() - t0
        results.append((decoder, PointRecord(
            code=code.name, channel="awgn", decoder=decoder, demapper="soft", point=8.0,
            param=sigma, bits=nb, bit_errors=be, frame_errors=fe, frames=nb // L,
            ber=be / nb, fer=fe / (nb // L), wall_s=wall, bits_per_s=nb / wall)))

    p, B, tpb_fano = SUPPLIED_BSC
    for decoder in ("stack", "fano"):
        tpb = tpb_fano if decoder == "fano" else FANO_TIMEOUT
        step = make_point_step(code, "bsc", decoder, frames=B, timeout_per_bit=tpb, device=dev)
        be, fe, _ = step(torch.Generator(device=dev).manual_seed(62), p)
        be, fe = int(be), int(fe)
        bits, rx = chain_frames(code, "bsc", B, torch.Generator(device=dev).manual_seed(62), p)
        dec = decode_plain(decoder, code, rx, False, tpb)[0]
        errs = dec != bits
        want = (int(errs.sum()), int(errs.any(1).sum()))
        budget = f", timeout {tpb} per bit" if decoder == "fano" else ""
        print(f"  bsc {decoder} p={p:g} ({B} frames{budget}): kernel bit_errors={be} "
              f"frame_errors={fe}, plain machine on the same frames {want[0]} {want[1]}: "
              f"{'equal' if (be, fe) == want else 'DIFFERENT'}")
        require((be, fe) == want, f"bsc {decoder} chain step: kernel counters differ from plain")
    return results


#: the mesh path's sequential grid: 8192 global lanes, code 0, two points
#: (seeds SEQ_GRID_SEEDS) per channel in two slices of one and two frames a lane
SEQ_GRID = (("awgn", 4.0), ("bsc", 0.03))
SEQ_GRID_SEEDS = (101, 102)
#: the headline's per-device shape: 2^20 lanes, MESH_FUSED_STEPS in-kernel steps
MESH_FUSED_STEPS = 4
#: the mesh layer's cost: (frames a step, steps, repeats, rounds) a slot;
#: the sweep's 4096 frames a step, a window of tens of ms at one slot
MESH_SCALING = (4096, 32, 5, 7)


def run_mesh_path(torch, dev):
    """The mesh layer on slots that repeat the card: every leg's counters
    against its serial runs, exactly (the sequential grid, the fused
    kernel on a frames mesh and a sweep x frames grid, the time-range
    sharded long-frame Monte-Carlo, the halo'd time-block decode against
    the exact decode, grid sweeps against frames-only and mesh-less
    sweeps), then the mesh layer's cost on one card.  Returns the sweeps'
    rows for the z-check."""
    from convolutional_codes_tpu_torch import get_code
    from convolutional_codes_tpu_torch.ops.channels import awgn_sigma
    from convolutional_codes_tpu_torch.ops.fano_mc import mc_fano
    from convolutional_codes_tpu_torch.ops.fused_chain import mc_chain_viterbi
    from convolutional_codes_tpu_torch.ops.fused_longframe import mc_longframe_viterbi
    from convolutional_codes_tpu_torch.ops.stack_mc import mc_stack
    from convolutional_codes_tpu_torch.parallel.distributed import measure_scaling
    from convolutional_codes_tpu_torch.parallel.mesh import make_mesh
    from convolutional_codes_tpu_torch.parallel.montecarlo import (
        device_seed, fused_grid_accumulate, fused_mc_accumulate)
    from convolutional_codes_tpu_torch.parallel.seq_grid import seq_mc_grid
    from convolutional_codes_tpu_torch.parallel.streaming import (
        long_frame_decode_stream, streaming_mc_accumulate, streaming_viterbi_decode)
    from convolutional_codes_tpu_torch.sim.sweep import SweepSpec, run_sweep

    mesh = lambda shape: make_mesh(shape, devices=[dev] * math.prod(shape.values()))
    grid, code = mesh({"sweep": 2, "frames": 2}), get_code(0)
    t0 = time.time()
    for decoder, mc in (("stack", mc_stack), ("fano", mc_fano)):
        for channel, point in SEQ_GRID:
            param = float(awgn_sigma(point)) if channel == "awgn" else point
            # a cold slice of one frame a lane and a warm one of two, side by side
            slices = [(1, SEQ_GRID_SEEDS), (2, [s ^ 0x2A5A5A5A for s in SEQ_GRID_SEEDS])]
            got = seq_mc_grid(decoder, code, 8192, slices, [param] * 2, grid, channel=channel)
            got = [[[int(b), int(f)] for b, f in zip(sl.bit_errors, sl.frame_errors)]
                   for sl in got]
            serial = [[mc(code, 8192, fpl, s, param, channel, device=dev)[:2].sum(1).tolist()
                       for s in seeds] for fpl, seeds in slices]
            print(f"  seq_mc_grid {decoder} code 0 {channel} {point:g}, 8192 lanes x 2 points "
                  f"x (1, 2) frames on {grid.shape}: bit/frame errors {got}, serial {serial}")
            require(got == serial and min(b for sl in got for b, _ in sl) > 0,
                    f"seq_mc_grid {decoder} {channel} differs from the serial runs")

    sigma8, B = float(awgn_sigma(8.0)), 1 << 20
    got = fused_mc_accumulate(code, MESH_FUSED_STEPS, 9, sigma8, B, mesh({"frames": 4}))
    serial = [mc_chain_viterbi(code, B, MESH_FUSED_STEPS, device_seed(9, d), sigma8,
                               device=dev) for d in range(4)]
    want = (sum(int(b.sum(dtype=torch.int64)) for b, _ in serial),
            sum(int(f.sum(dtype=torch.int64)) for _, f in serial),
            4 * B * code.block_length * MESH_FUSED_STEPS)
    print(f"  fused_mc_accumulate frames=4, {B} lanes x {MESH_FUSED_STEPS} steps a slot: {got}, "
          f"four serial kernel-3 calls {want}")
    require(got == want and got[0] > 0, "fused_mc_accumulate on the mesh differs")
    seeds = [[11, 12], [13, 14]]
    params = [float(awgn_sigma(6.0)), sigma8]
    gb, gf, _ = fused_grid_accumulate(code, MESH_FUSED_STEPS, seeds, params, B, grid)
    for r in range(2):
        outs = [mc_chain_viterbi(code, B, MESH_FUSED_STEPS, s, params[r], device=dev)
                for s in seeds[r]]
        want = [sum(int(x[i].sum(dtype=torch.int64)) for x in outs) for i in (0, 1)]
        require([int(gb[r]), int(gf[r])] == want, f"fused_grid_accumulate point {r} differs")
    print(f"  fused_grid_accumulate {grid.shape}: bit errors {gb.tolist()} = 2 x 2 serial calls")

    k7, (_, channel, point, lanes, _) = get_code("nasa-k7"), LONGFRAME_CONFIGS[1]
    be, we, nb = streaming_mc_accumulate(k7, lanes, 4, 4323, float(awgn_sigma(point)), channel,
                                         mesh=mesh({"seq": 4}))
    rbe, rwe = mc_longframe_viterbi(k7, lanes, 4, 4323, float(awgn_sigma(point)), channel,
                                    device=dev)
    lanes_diff = int(((be != rbe.long().cpu()) | (we != rwe.long().cpu())).sum())
    print(f"  streaming_mc_accumulate seq=4, config 2's shape ({lanes} lanes x 4 windows): "
          f"{lanes_diff}/{lanes} lanes differ from one launch; bit errors {int(be.sum())}")
    require(lanes_diff == 0 and nb == lanes * 4 * 1920, "streaming_mc_accumulate on the mesh")

    gen = torch.Generator(device=dev).manual_seed(78)
    _, d = awgn_frames(torch, k7, 128, 65536, 6.0, gen)
    sharded = streaming_viterbi_decode(k7, d, mesh({"seq": 4}), warmup=128)
    exact = long_frame_decode_stream(k7, d)
    nbad = int((sharded != exact).sum())
    print(f"  streaming_viterbi_decode seq=4, nasa-k7 [128, 65536] 6 dB, warmup 128: "
          f"{nbad} bits differ from long_frame_decode_stream")
    require(nbad == 0, "streaming_viterbi_decode differs from the exact decode")
    halo_across_processes(torch, dev, d[:32, :16384].contiguous())

    results = []
    spec = SweepSpec(code=0, channel="awgn", decoder="viterbi", points=(8.0, 10.0),
                     frames_per_step=1 << 20, base_bits=8e7, seed=5)
    recs = [run_sweep(spec, mesh=mesh(s), verbose=False)
            for s in ({"sweep": 2, "frames": 2}, {"frames": 2})]
    stack = SweepSpec(code=0, channel="awgn", decoder="stack", base_bits=8e6, seed=6)
    recs += [run_sweep(stack, mesh=mesh({"frames": 4}), verbose=False),
             run_sweep(stack, verbose=False, device=dev)]
    for what, a, b in (("viterbi sweep x frames vs frames", recs[0], recs[1]),
                       ("stack frames=4 vs no mesh", recs[2], recs[3])):
        same = [(r.bits, r.bit_errors, r.frame_errors) for r in a] == \
            [(r.bits, r.bit_errors, r.frame_errors) for r in b]
        print(f"  run_sweep {what}: {len(a)} points, counters {'equal' if same else 'DIFFER'}")
        require(same, f"run_sweep {what}")
    results += [("awgn", r) for r in recs[0] + recs[2]]
    print(f"  mesh legs: {time.time() - t0:.1f} s")

    card = card_line()
    counts, rounds = (1, 2, 4), []
    for _ in range(MESH_SCALING[3]):   # interleaved: drift falls on every D alike
        pts = measure_scaling(frames_per_device=MESH_SCALING[0], nsteps=MESH_SCALING[1],
                              device_counts=list(counts), repeats=MESH_SCALING[2],
                              devices=[dev] * max(counts))
        rounds.append({p.devices: statistics.median(p.walls) for p in pts})
    for d in counts:
        walls = sorted(r[d] for r in rounds)
        ratios = sorted(r[d] / (d * r[1]) for r in rounds)
        q = statistics.quantiles(walls, n=4)
        print(f"  mesh layer on one card [{card}]: {d} slots of {dev}, {MESH_SCALING[0]} frames "
              f"x {MESH_SCALING[1]} steps a slot, {len(rounds)} rounds of {MESH_SCALING[2]} "
              f"repeats: round medians min {walls[0] * 1e3:.3f} / quartiles {q[0] * 1e3:.3f} "
              f"{q[1] * 1e3:.3f} {q[2] * 1e3:.3f} / max {walls[-1] * 1e3:.3f} ms; overhead "
              f"wall(D) / (D * wall(1)) per round {[round(x, 4) for x in ratios]}, median "
              f"{statistics.median(ratios):.4f} (slots share the card: this is the layer's "
              f"cost, not scaling)")
    return results


#: run by each of two processes in ``halo_across_processes``: argv = the
#: repository, rank, port, directory of the stream; one slot of cuda:0 each
HALO_WORKER = r"""
import sys
import numpy as np
import torch
import torch.distributed as dist
sys.path.insert(0, sys.argv[1])
rank, port, path = int(sys.argv[2]), sys.argv[3], sys.argv[4]
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=2, rank=rank)
from convolutional_codes_tpu_torch import get_code
from convolutional_codes_tpu_torch.ops import longframe_cuda as lc
from convolutional_codes_tpu_torch.parallel.mesh import make_mesh
from convolutional_codes_tpu_torch.parallel.streaming import streaming_viterbi_decode
dev = torch.device("cuda", 0)
d = torch.as_tensor(np.load(f"{path}/dists.npy"), device=dev)
mesh = make_mesh({"seq": 2}, devices=[dev])
bits = streaming_viterbi_decode(get_code("nasa-k7"), d, mesh, warmup=128)
torch.cuda.synchronize()
np.save(f"{path}/bits{rank}.npy", bits.cpu().numpy())
print("rank", rank, "of", mesh.world, "launches", lc.stream_acs_cuda.launches,
      lc.stream_traceback_cuda.launches)
dist.destroy_process_group()
"""


def halo_across_processes(torch, dev, d):
    """The time-block decode on a seq mesh of two processes, one slot of the
    card each, over gloo (NCCL refuses two ranks on one card): the halos
    cross between the processes by point-to-point sends (through the host),
    and each process's bits must equal the one-process decode over two
    slots and the exact decode."""
    import socket
    from convolutional_codes_tpu_torch import get_code
    from convolutional_codes_tpu_torch.parallel.mesh import make_mesh
    from convolutional_codes_tpu_torch.parallel.streaming import (
        long_frame_decode_stream, streaming_viterbi_decode)

    k7 = get_code("nasa-k7")
    with tempfile.TemporaryDirectory() as tmp:
        np.save(os.path.join(tmp, "dists.npy"), d.cpu().numpy())
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = str(s.getsockname()[1])
        t0 = time.time()
        procs = [subprocess.Popen([sys.executable, "-c", HALO_WORKER, ROOT, str(r), port, tmp],
                                  stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                 for r in range(2)]
        outs = []
        for p in procs:
            try:
                outs.append(p.communicate(timeout=300))
            finally:
                p.kill()
        wall = time.time() - t0
        for p, (out, err) in zip(procs, outs):
            require(p.returncode == 0, f"halo worker failed: {err[-2000:]}")
            print(f"  {out.strip()}")
        got = [torch.as_tensor(np.load(os.path.join(tmp, f"bits{r}.npy"))) for r in range(2)]
    one = streaming_viterbi_decode(k7, d, make_mesh({"seq": 2}, devices=[dev] * 2),
                                   warmup=128).cpu()
    exact = long_frame_decode_stream(k7, d).cpu()
    off = [int((g != one).sum()) for g in got]
    print(f"  streaming_viterbi_decode on 2 processes x 1 slot of {dev} (gloo), nasa-k7 "
          f"{list(d.shape[:2])}: {off} bits differ from the one-process decode over 2 slots, "
          f"which is {int((one != exact).sum())} bits off the exact decode; {wall:.1f} s with "
          "the processes' start")
    require(off == [0, 0] and torch.equal(one, exact), "the halo exchange across processes")


def check_points(results, gold, row="ber_coded_a"):
    for channel, r in results:
        z = z_score(r, channel, row, gold)
        ztxt = "n/a (published 0)" if z is None else f"{z:+.2f}"
        print(f"  {channel} {r.decoder} point={r.point:g} bits={r.bits} "
              f"errors={r.bit_errors} BER={r.ber:.4e} z={ztxt} "
              f"warm bits/s={r.bits_per_s:.4e}")
        require(z is None or abs(z) < Z_MAX,
                f"{channel} point {r.point}: BER {r.ber:.4e}, z={ztxt}")


def measure(torch, dev, card, clock, sass):
    """Headline throughput and each kernel's time beside its plain version,
    its bound and its time before its last redesign (``sass``: read_sass's
    counts)."""
    from convolutional_codes_tpu_torch import get_code
    from convolutional_codes_tpu_torch.ops import viterbi_cuda as vc
    from convolutional_codes_tpu_torch.ops.channels import awgn_sigma
    from convolutional_codes_tpu_torch.ops.fused_chain import (
        mc_chain_viterbi, mc_chain_viterbi_ref)
    from convolutional_codes_tpu_torch.ops.viterbi import BIG_METRIC

    code = get_code(0)
    L = code.block_length
    sigma = float(awgn_sigma(8.0))
    B, nsteps, calls = 1 << 20, 16, 4
    times = {}

    mc_chain_viterbi(code, B, nsteps, 1, sigma, device=dev)       # warm-up
    torch.cuda.synchronize()
    t0 = time.time()
    errs = [mc_chain_viterbi(code, B, nsteps, 100 + i, sigma, device=dev)[0]
            for i in range(calls)]
    torch.cuda.synchronize()
    dt = time.time() - t0
    bits = B * L * nsteps * calls
    rate = bits / dt
    ber = sum(int(e.sum()) for e in errs) / bits
    times["mc_chain"] = dt * 1e3 / (calls * nsteps)
    print(f"headline [{card}]: fused kernel, code 0 at 8 dB, {B} lanes x {nsteps} "
          f"steps x {calls} calls: {rate:.6e} info bits/s "
          f"({rate / C_CORE_BITS_PER_S:.1f}x the 6.6e6 C core; before: "
          f"{BEFORE_MS['headline']:.6e}), BER {ber:.6e} vs published "
          f"{PUBLISHED_BER_8DB:.4e}, {times['mc_chain']:.4f} ms per step (before: "
          f"{BEFORE_MS['mc_chain']:.4f} ms)")

    plain = {}
    for variant in ("", "fast_demap"):
        key = "mc_chain" + ("_" + variant if variant else "")
        mc_chain_viterbi_ref(code, B, 1, 1, sigma, device=dev, variant=variant)   # warm-up
        torch.cuda.synchronize()
        t0 = time.time()
        mc_chain_viterbi_ref(code, B, 2, 100, sigma, device=dev, variant=variant)
        torch.cuda.synchronize()
        plain[key] = (time.time() - t0) * 1e3 / 2
        print(f"plain fused chain{' ' + variant if variant else ''} [{card}]: {B} lanes x 2 "
              f"steps: {plain[key]:.3f} ms per step, {B * L / plain[key] * 1e3:.6e} info bits/s")

    # fast_demap at the headline shape, beside the exact demapper above
    mc_chain_viterbi(code, B, nsteps, 1, sigma, device=dev, variant="fast_demap")
    torch.cuda.synchronize()
    t0 = time.time()
    errs_lin = [mc_chain_viterbi(code, B, nsteps, 100 + i, sigma, device=dev,
                                 variant="fast_demap")[0] for i in range(calls)]
    torch.cuda.synchronize()
    dt_lin = time.time() - t0
    times["mc_chain_fast_demap"] = dt_lin * 1e3 / (calls * nsteps)
    ber_lin = sum(int(e.sum()) for e in errs_lin) / bits
    print(f"headline fast_demap [{card}]: {bits / dt_lin:.6e} info bits/s, "
          f"{times['mc_chain_fast_demap']:.4f} ms per step (the exact demapper: {rate:.6e}, "
          f"{times['mc_chain']:.4f} ms), BER {ber_lin:.6e} (exact {ber:.6e}, same streams)")

    Bv = 262144
    T, M, S = code.num_block_symbols, code.points_per_symbol, code.num_states
    g = torch.Generator(device=dev).manual_seed(3)
    dists = torch.rand((T, M, Bv), generator=g, device=dev) * 8.0
    init = torch.full((S, Bv), BIG_METRIC, device=dev)
    init[0] = 0.0
    fm, dec = vc.acs_forward_cuda(code, dists, init, False)
    times["acs_forward"] = cuda_ms(lambda: vc.acs_forward_cuda(code, dists, init, False), 20)
    plain["acs_forward"] = cuda_ms(lambda: vc.acs_forward_ref(code, dists, init, False), 3)
    times["traceback"] = cuda_ms(lambda: vc.traceback_cuda(code, dec, fm), 20)
    designs = {}   # kernel 2 on both designs, timed beside the plan's call above
    for plan in (vc.TracebackPlan("frame", T), vc.TracebackPlan("segments", 16)):
        designs[plan] = (vc.traceback_cuda(code, dec, fm, plan),
                         cuda_ms(lambda: vc.traceback_cuda(code, dec, fm, plan), 20))
    plain["traceback"] = cuda_ms(lambda: vc.traceback_ref(code, dec, fm), 3)
    nw = (S + 31) // 32
    bound = {   # (ms, what bounds it): each input read once, each output written once
        "acs_forward": ((T * M + 2 * S + T * nw) * 4 * Bv / HBM_BYTES_PER_S * 1e3, "bytes"),
        "traceback": ((T * nw + S + T + 1) * 4 * Bv / HBM_BYTES_PER_S * 1e3, "bytes"),
        # the operations per trellis symbol of the function (LANE_OPS)
        "mc_chain": (B * T * mc_chain_ops_per_symbol(code)
                     / (SMS * LANE_SLOTS_PER_SM * clock) * 1e3, "operations"),
        "mc_chain_fast_demap": (B * T * mc_chain_ops_per_symbol(code, lin=True)
                                / (SMS * LANE_SLOTS_PER_SM * clock) * 1e3, "operations"),
    }
    for k in ("acs_forward", "traceback"):
        before = BEFORE_MS[k]
        print(f"{k} [{card}]: code 0, B={Bv}: kernel {times[k]:.4f} ms (before: "
              f"{before:.4f} ms), plain {plain[k]:.4f} ms, bound {bound[k][0]:.4f} ms "
              f"({bound[k][1]})")
    want = vc.traceback_ref(code, dec, fm)
    for plan, (got, pms) in designs.items():
        require(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
                f"traceback (kernel 2) {plan} vs plain at B={Bv}")
        print(f"traceback [{card}]: code 0, B={Bv}, T={T}, {plan}"
              f"{' (the plan)' if plan == vc.traceback_plan(Bv, T, S) else ''}: {pms:.4f} ms "
              f"(before: {BEFORE_MS['traceback']:.4f} ms; bound {bound['traceback'][0]:.4f} ms), "
              "bits and metric equal to the plain version")
    issue_ms = B * T * sass["mc_chain_instr"] / (SMS * LANE_SLOTS_PER_SM * clock) * 1e3
    print(f"mc_chain bound: {bound['mc_chain'][0]:.4f} ms per step (operations: "
          f"{mc_chain_ops_per_symbol(code):.1f} per symbol, LANE_OPS); issue time of "
          f"this build {issue_ms:.4f} ms ({sass['mc_chain_instr']:.1f} SASS instructions every "
          f"symbol issues); kernel {times['mc_chain']:.4f} ms, "
          f"{bound['mc_chain'][0] / times['mc_chain']:.1%} of the bound")
    lin = "mc_chain_fast_demap"
    issue_lin = (B * T * sass["mc_chain_fast_demap_instr"]
                 / (SMS * LANE_SLOTS_PER_SM * clock) * 1e3)
    print(f"mc_chain fast_demap bound: {bound[lin][0]:.4f} ms per step (operations: "
          f"{mc_chain_ops_per_symbol(code, lin=True):.1f} per symbol, the linear form); issue "
          f"time of this build {issue_lin:.4f} ms ({sass['mc_chain_fast_demap_instr']:.1f} SASS "
          f"instructions every symbol issues); kernel {times[lin]:.4f} ms, "
          f"{bound[lin][0] / times[lin]:.1%} of the bound; plain {plain[lin]:.3f} ms")
    return times, plain, bound


#: operations of one lane's trellis symbol in kernel 3's function, counted
#: from the algorithm and not from a build: a counter hash (lowbias32 twice,
#: 3 shifts, 3 xors and 2 multiplies each, the index's multiply-add and the
#: salt's xor), a uniform from its bits (shift, convert, multiply, add), one
#: ACS state (two branch-metric reads, two adds, a compare, a select, the
#: decision bit), one traceback row (the survivor bit, the decoded bit, the
#: next state), and Box-Muller's logf, sqrtf and sincosf at the lengths of
#: their single-precision fast paths (estimated: about 20, 7 and 22)
LANE_OPS = {"hash": 18, "uniform": 4, "acs_state": 8, "traceback_row": 9,
            "transcendentals": 20 + 7 + 22}


def lin_demap_ops(code) -> int:
    """Operations of fast_demap's linear distance vector (the JAX package's
    ``dist_vec_lin``): one product per unique nonzero |I| and |Q|
    coordinate, one signed sum or negation a point, and a point's |p|^2
    added where the constellation is not constant-modulus."""
    from convolutional_codes_tpu_torch.models.constellations import get_constellation

    pts = np.asarray(get_constellation(code.symlen_out), np.float64)
    mods = {round(float(x * x + y * y), 9) for x, y in pts}
    uniq = len({abs(x) for x in pts[:, 0] if x}) + len({abs(y) for y in pts[:, 1] if y})
    return uniq + len(pts) * (1 if len(mods) == 1 else 2)


def mc_chain_ops_per_symbol(code, lin: bool = False) -> float:
    """Operations per lane and trellis symbol of kernel 3's function on
    AWGN with soft metrics (LANE_OPS): the info bit's hash and mask on the
    rows below L; the encoder register and its expected symbol (5); two
    uniforms; Box-Muller (the transcendentals, 2 pi u and -2 log u, then r
    c and r s, scaled by sigma and added to the point: 10 more); a distance
    a point (2 subtractions, 2 squares, an add, a scale), or with ``lin``
    the linear form's (:func:`lin_demap_ops`); the ACS of every state; one
    traceback row."""
    o = LANE_OPS
    ops = code.block_length / code.num_block_symbols * (o["hash"] + 1) + 5
    ops += 2 * (o["hash"] + o["uniform"]) + o["transcendentals"] + 10
    ops += lin_demap_ops(code) if lin else 6 * code.points_per_symbol
    return ops + o["acs_state"] * code.num_states + o["traceback_row"]


#: operations of the stack walk's function, the bound of kernels 7 and 9
#: (counted, not measured).  The pick of an iteration's first max and first
#: min at its least, as the kept best/worst of 8 groups of 8 slots needs
#: it: per live group, for its kept max and its kept min each a read, a
#: compare and two selects (8); the winners' two slots read and the
#: rewritten group's max, min and slots stored (6); and that group rescanned,
#: per live slot a read, two compares and four selects (7).  The group the
#: best path sits in is written every iteration; a second one, the
#: duplicate's, is not counted.  Per iteration besides: the best path's node
#: (a read, its two fields, the symbol accepted: 6), per branch its register
#: (2), per coded bit of its expected symbol 4 (and, popcount, parity,
#: place), its metric (soft: a read, a product, an add; hard: a read and 5),
#: the two slots written (two metric adds, two node words, four stores, the
#: capacity test: 12), and per word of the path copied a read, an or and a
#: write.  A wide code's Monte-Carlo walk (symlen 5-8) keeps the received
#: point, so each branch also computes its distance to the expected point
#: (two reads, two subtracts, two products, an add, the scale: 8)
STACK_OPS = {"pick_group": 8, "pick": 6, "pick_slot": 7, "node": 6, "branch": 2,
             "coded_bit": 4, "soft_metric": 3, "hard_metric": 6, "write": 12, "path_word": 3,
             "wide_distance": 8}
#: slots of a stack walk, and of one group of its pick
STACK_DEPTH, STACK_GROUP = 64, 8


def stack_pick_ops(iters, frames: int) -> float:
    """The pick's operations (STACK_OPS) summed over the iterations of walks
    of ``iters`` iterations, where iteration i has min(i, 64) live slots:
    exact where each entry is one walk; where each entry sums ``frames``
    walks, the least that sum can be (a walk's count, interpolated between
    whole iterations, is convex in its iterations, since no iteration counts
    less than the one before)."""
    o, n = STACK_OPS, np.arange(1, STACK_DEPTH + 1)
    per = (o["pick_group"] * -(-n // STACK_GROUP) + o["pick"]
           + o["pick_slot"] * np.minimum(n, STACK_GROUP))   # iteration n's count
    done = np.concatenate([[0], np.cumsum(per)])           # the first k iterations'
    x = iters.double().cpu().numpy() / frames
    k = np.minimum(np.floor(x), STACK_DEPTH).astype(np.int64)
    return float((done[k] + (x - k) * per[np.minimum(k, STACK_DEPTH - 1)]).sum()) * frames


def datagen_ops_per_symbol(code, channel: str) -> float:
    """Kernel 7's datagen a symbol (LANE_OPS): the info bit's hash, the
    encoder register and expected symbol (5); on AWGN two uniforms,
    Box-Muller (as kernel 3's) and per point a distance (6), its metric
    (product, add) and its store; on BSC a uniform and a compare per coded
    bit and per point a hard metric (5) and its store.  A wide code's walk
    keeps the received row and computes no per-point term (stack_ops counts
    its branches' distances)."""
    from convolutional_codes_tpu_torch.ops.sequential_common import is_wide
    o, M = LANE_OPS, (0 if is_wide(code) else code.points_per_symbol)
    ops = o["hash"] + 1 + 5
    if channel == "awgn":
        return ops + 2 * (o["hash"] + o["uniform"]) + o["transcendentals"] + 10 + 9 * M
    return ops + code.symlen_out * (o["hash"] + o["uniform"] + 2) + 6 * M


def stack_ops(code, channel: str, iters, frames: int, mc: bool) -> float:
    """Operations of the stack walk's function (STACK_OPS) over walks of
    ``iters`` iterations (each entry ``frames`` walks); with ``mc`` also
    each frame's datagen and the count of its bit errors (a hash, a mask,
    a compare and an add per info bit)."""
    from convolutional_codes_tpu_torch.ops.sequential_common import is_wide
    o = STACK_OPS
    metric = o["soft_metric"] if channel == "awgn" else o["hard_metric"]
    if mc and channel == "awgn" and is_wide(code):
        metric += o["wide_distance"]
    per_iter = (o["node"] + 2 * (o["branch"] + o["coded_bit"] * code.symlen_out + metric)
                + o["write"] + o["path_word"] * -(-code.block_length // 32))
    ops = stack_pick_ops(iters, frames) + per_iter * float(iters.sum())
    if mc:
        ops += iters.numel() * frames * (
            code.num_block_symbols * datagen_ops_per_symbol(code, channel)
            + code.block_length * (LANE_OPS["hash"] + 3))
    return ops


SEQ_RATES = [("stack", "k9-r12", 4.0), ("stack", "k9-r12", 8.0),
             ("fano", "k15-r14-16qam", 8.0), ("stack", 0, 8.0), ("fano", 0, 8.0),
             ("stack", 0, 0.0), ("fano", 0, 0.0)]


def warp_divergence(iters) -> float:
    """Sum over groups of 32 entries of 32 times the group's largest count,
    over the sum of counts (1 when every entry of a group walks as long);
    ``iters`` holds a multiple of 32 entries.  Over per-frame iterations it
    is what one thread a frame would cost a warp (PR 7's kernel 9; kernels
    7-10 now take frames from a queue); over kernel 7's per-lane sums of
    ``fpl`` frames it says little, since a lane's frames average out."""
    return float(iters.view(-1, 32).amax(dim=1).sum()) * 32 / float(iters.sum())


def stack_plan_text(mc: bool, code, dev) -> str:
    """Kernel 7's (``mc``) or 9's launch plan for ``code``: path bits'
    storage, threads per block, resident walks per SM, shared bytes
    per block, registers and local bytes per thread."""
    from convolutional_codes_tpu_torch.ops import stack_mc
    plan = stack_mc.code_plan(code)
    occ = stack_mc.occupancy(mc, plan, dev.index)
    return (f"plan: path bits in {'shared' if plan.bits_shared else 'device'} memory, "
            f"{plan.threads} threads/block, {occ['blocks_per_sm']} blocks/SM "
            f"({occ['blocks_per_sm'] * plan.threads} walks/SM), {plan.smem_bytes} shared "
            f"bytes/block, {occ['registers']} registers, {occ['local_bytes']} local bytes")


def plan_text(mc: bool, code, dev) -> str:
    """Kernel 8's (``mc``) or 10's launch plan for ``code``: threads per
    block, resident blocks per SM, shared bytes per block, registers and
    local bytes per thread."""
    from convolutional_codes_tpu_torch.ops import fano_mc
    plan = fano_mc.fano_plan(code.num_block_symbols)
    occ = fano_mc.occupancy(mc, plan, dev.index)
    where = f"records in {'shared' if plan.nodes_shared else 'device'} memory"
    return (f"plan: {where}, {plan.threads} threads/block, "
            f"{occ['blocks_per_sm']} blocks/SM "
            f"({occ['blocks_per_sm'] * plan.threads} walks/SM), {plan.smem_bytes} shared "
            f"bytes/block, {occ['registers']} registers, {occ['local_bytes']} local bytes")


def iteration_bound_ms(name: str, iters, clock: float, code=None, frames: int = 1) -> float:
    """Least time for the walks of ``iters`` iterations at the card's
    instruction rate: the Fano walks at INSTR_PER_ITER, kernel 7 (AWGN soft,
    ``frames`` walks an entry) at its function's operations (stack_ops)."""
    rate = SMS * LANE_SLOTS_PER_SM * clock
    if name == "mc_stack":
        return stack_ops(code, "awgn", iters, frames, True) / rate * 1e3
    return float(iters.sum()) * INSTR_PER_ITER[name] / rate * 1e3


def frame_divergence(torch, code, seed: int, sigma: float, dev) -> str:
    """Kernel 9 on the first 8192 frames of a kernel 7 row (the same hash
    frames): the per-frame divergence of their iterations (warp_divergence)
    and their largest and median."""
    from convolutional_codes_tpu_torch.ops import mc_datagen, stack_cuda
    _, syms = mc_datagen.frames_cuda(code, torch.arange(8192, device=dev), seed, sigma, "awgn")
    iters = stack_cuda.stack_machine_cuda(code, syms, True)[2]
    return (f"per-frame divergence {warp_divergence(iters):.3f} (first 8192 frames through "
            f"kernel 9: iterations max {int(iters.max())}, median "
            f"{float(iters.double().median()):.0f})")


def measure_sequential(torch, dev, card, clock):
    """Kernels 7-8 at full width (8192 lanes, timeout 10000 per bit, warm
    calls, fresh seeds, walls of about 2 s), the plain version at 64 lanes,
    and each kernel (median of 20 launches) beside its plain version at 256
    lanes x 1 frame."""
    from convolutional_codes_tpu_torch import get_code
    from convolutional_codes_tpu_torch.ops.channels import awgn_sigma
    from convolutional_codes_tpu_torch.ops.fano_mc import mc_fano, mc_fano_ref
    from convolutional_codes_tpu_torch.ops.stack_mc import mc_stack, mc_stack_ref

    fns = {"stack": (mc_stack, mc_stack_ref), "fano": (mc_fano, mc_fano_ref)}
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for n, (decoder, ck, snr) in enumerate(SEQ_RATES):
        mc, ref = fns[decoder]
        code, sigma, lanes = get_code(ck), float(awgn_sigma(snr)), 8192
        mc(code, lanes, 1, 1, sigma, device=dev)   # warm-up: plan, scratch
        torch.cuda.synchronize()
        t0 = time.time()
        mc(code, lanes, 1, 1, sigma, device=dev)
        torch.cuda.synchronize()
        fpl = max(1, min(4096, int(2.0 / max(time.time() - t0, 1e-4))))
        start.record()
        out = mc(code, lanes, fpl, 1000 + n, sigma, device=dev)
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end)
        bits = lanes * fpl * code.block_length
        rate = bits / ms * 1e3
        iters = out[2]
        before = ""
        if decoder == "fano":
            spread = plan_text(True, code, dev)
        else:
            spread = (f"per-lane divergence of {fpl}-frame sums {warp_divergence(iters):.3f}; "
                      f"{frame_divergence(torch, code, 1000 + n, sigma, dev)}; "
                      f"{stack_plan_text(True, code, dev)}")
            prior = BEFORE_STACK[(ck, snr)]
            before = (f" (PR 7: {prior:.6e} info bits/s, {bits / prior * 1e3:.3f} ms at these "
                      f"frames)")
        if decoder == "fano" and snr < 4.0:
            # timeout-bound: every frame walks 10000 * T SEARCH steps, which
            # the lockstep plain machine would take minutes over
            plain_txt = "plain: not measured (timeout-bound)"
        else:
            t0 = time.time()
            ref(code, 64, 1, 1000 + n, sigma, device=dev)
            torch.cuda.synchronize()
            plain_s = time.time() - t0
            plain_txt = (f"plain 64 lanes x 1: {plain_s * 1e3:.1f} ms "
                         f"({64 * code.block_length / plain_s:.4e} info bits/s)")
        print(f"{decoder} {code.name} AWGN soft {snr:g} dB [{card}]: {lanes} lanes x {fpl} "
              f"frames: {rate:.6e} info bits/s ({rate / C_CORE_SEQ_BITS_PER_S[decoder]:.1f}x "
              f"the {C_CORE_SEQ_BITS_PER_S[decoder]:.2g} C core at 0 dB), BER "
              f"{float(out[0].sum()) / bits:.6e}, kernel {ms:.3f} ms per launch{before}, "
              f"iterations {int(iters.sum())} (max lane {int(iters.max())}, {spread}), "
              f"bound {iteration_bound_ms('mc_' + decoder, iters, clock, code, fpl):.3f} ms; "
              f"{plain_txt}")

    code0, sigma8 = get_code(0), float(awgn_sigma(8.0))
    times, plain, bound = {}, {}, {}
    for decoder, (mc, ref) in fns.items():
        name = "mc_" + decoder
        out = mc(code0, 256, 1, 5, sigma8, device=dev)
        times[name] = cuda_median_ms(lambda: mc(code0, 256, 1, 5, sigma8, device=dev), 20)
        ref(code0, 256, 1, 5, sigma8, device=dev)
        torch.cuda.synchronize()
        t0 = time.time()
        ref(code0, 256, 1, 5, sigma8, device=dev)
        torch.cuda.synchronize()
        plain[name] = (time.time() - t0) * 1e3
        bound[name] = (iteration_bound_ms(name, out[2], clock, code0), "operations")
        per = ("its function's operations, STACK_OPS" if decoder == "stack"
               else f"x {INSTR_PER_ITER[name]} instructions")
        prior = f", PR 7 {BEFORE_STACK[name]:.4f} ms" if decoder == "stack" else ""
        print(f"{name} [{card}]: code 0 AWGN 8 dB, 256 lanes x 1 frame: kernel "
              f"{times[name]:.4f} ms (median of 20 launches{prior}), plain {plain[name]:.4f} ms, "
              f"bound {bound[name][0]:.4f} ms ({int(out[2].sum())} iterations, {per})")
    return times, plain, bound


#: codes of phase 5's comparison of kernel 8's node storages: T from 42 to
#: 214 nodes, and 16-QAM beside k15-r12 (the same T, 4x the symbols)
FANO_PLAN_CODES = (0, "wspr-k32", "k9-r12", "nasa-k7", "k15-r12", "k15-r14-16qam")


def compare_fano_plans(torch, dev, card):
    """Kernel 8 at 8192 lanes, AWGN soft 8 dB, at FANO_PLAN_CODES under its
    own plan (node records in shared memory at these T) and with the records
    in device memory (GLOBAL_THREADS per block), on the same frames, timed
    own, device, device, own (CUDA events, one launch each); the counters
    must be equal."""
    from convolutional_codes_tpu_torch import get_code
    from convolutional_codes_tpu_torch.ops import fano_mc
    from convolutional_codes_tpu_torch.ops.channels import awgn_sigma
    from convolutional_codes_tpu_torch.ops.fano import FANO_TIMEOUT

    glob = fano_mc.FanoPlan(fano_mc.GLOBAL_THREADS, 0, False)
    sigma, lanes = float(awgn_sigma(8.0)), 8192
    for n, ck in enumerate(FANO_PLAN_CODES):
        code = get_code(ck)
        own = fano_mc.fano_plan(code.num_block_symbols)
        run = lambda fpl, plan: cuda_call(lambda: fano_mc._launch(
            code, lanes, fpl, 2000 + n, sigma, "awgn", "soft", FANO_TIMEOUT, dev, plan=plan))
        run(1, own)
        run(1, glob)
        fpl = max(1, min(4096, int(500.0 / max(run(1, own)[1], 0.01))))
        outs, ms = zip(*(run(fpl, plan) for plan in (own, glob, glob, own)))
        require(all(torch.equal(o, outs[0]) for o in outs),
                f"kernel 8 {code.name}: the node storages' counters differ")
        occ = {p: fano_mc.occupancy(True, p, dev.index) for p in (own, glob)}
        walks = {p: occ[p]["blocks_per_sm"] * p.threads for p in (own, glob)}
        print(f"kernel 8 node storage [{card}]: {code.name} (T={code.num_block_symbols}, "
              f"M={code.points_per_symbol}) AWGN soft 8 dB, {lanes} lanes x {fpl}: "
              f"shared ({own.threads} threads/block, {walks[own]} walks/SM) {ms[0]:.3f} / "
              f"{ms[3]:.3f} ms, device memory ({glob.threads} threads/block, {walks[glob]} "
              f"walks/SM) {ms[1]:.3f} / {ms[2]:.3f} ms, counters equal")


#: kernels 9-10 in phase 5, AWGN soft 8 dB: (decoder, code, frames); the
#: first row of each decoder is the supplied-frame path's shape
SUPPLIED_RATES = (("stack", 0, SUPPLIED_FRAMES), ("fano", 0, SUPPLIED_FRAMES),
                  ("stack", "k9-r12", SUPPLIED_FRAMES), ("fano", "k15-r14-16qam", 16384))


def measure_supplied(torch, dev, card, clock, stats):
    """Kernels 9-10 at SUPPLIED_RATES' shapes on the modular chain's frames:
    kernel time (CUDA events, median of 20 launches), decode-only and chain info bits/s, BER,
    iterations, warp divergence (kernel 9) and the bound; the plain machine
    on the same whole batch, timed and held exactly against the kernel.
    Each kernel also alone on its slowest frame, and its launch plan."""
    from convolutional_codes_tpu_torch import get_code
    from convolutional_codes_tpu_torch.ops.channels import awgn_sigma
    from convolutional_codes_tpu_torch.ops.fano import FANO_TIMEOUT
    from convolutional_codes_tpu_torch.sim.chain import chain_frames, make_point_step

    times, plain, bound = {}, {}, {}
    slots = SMS * LANE_SLOTS_PER_SM * clock
    sigma = float(awgn_sigma(8.0))
    for n, (decoder, ck, B) in enumerate(SUPPLIED_RATES):
        code, name = get_code(ck), decoder + "_decode"
        T, M, L = code.num_block_symbols, code.points_per_symbol, code.block_length
        bits, d = chain_frames(code, "awgn", B, torch.Generator(device=dev).manual_seed(70 + n),
                               sigma)
        run = lambda x: decode_supplied(decoder, code, x, True, FANO_TIMEOUT)
        run(d)
        torch.cuda.synchronize()
        got = run(d)
        ms = cuda_median_ms(lambda: run(d), 20)
        iters = got[1]["iters"]
        ber = float((got[0] != bits).sum()) / bits.numel()
        step = make_point_step(code, "awgn", decoder, frames=B, device=dev)
        gen = torch.Generator(device=dev).manual_seed(90 + n)
        step(gen, sigma)
        torch.cuda.synchronize()
        t0 = time.time()
        chain_bits = step(gen, sigma)[2]
        torch.cuda.synchronize()
        chain_s = time.time() - t0
        # bytes: the distances read once; bits, metric, iterations (and the
        # Fano timeout_left and depth) written once
        out_bytes = L * 4 + 4 + 8 + (8 if decoder == "fano" else 0)
        bytes_ms = B * (T * M * 4 + out_bytes) / HBM_BYTES_PER_S * 1e3
        if decoder == "stack":
            ops_ms = stack_ops(code, "awgn", iters, 1, False) / slots * 1e3
            est = "its function's operations, STACK_OPS"
        else:
            ops_ms = float(iters.sum()) * INSTR_PER_ITER[name] / slots * 1e3
            est = f"{INSTR_PER_ITER[name]} instructions an iteration (SASS)"
        b_ms = (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")
        t0 = time.time()
        want = decode_plain(decoder, code, d, True, FANO_TIMEOUT)
        torch.cuda.synchronize()
        plain_ms = (time.time() - t0) * 1e3
        bad, err = supplied_diff(torch, got, want)
        require(not bad, f"{name} vs plain at {code.name} B={B}: {bad} differ")
        stats[name] = max(stats[name], err)
        spread = ("" if decoder == "fano"
                  else f", per-frame divergence {warp_divergence(iters):.3f}")
        prior = (f" (PR 7: {BEFORE_STACK[name][ck]:.3f} ms)"
                 if decoder == "stack" and ck in BEFORE_STACK[name] else "")
        print(f"{name} [{card}]: {code.name} AWGN soft 8 dB, B={B}: kernel {ms:.3f} ms per "
              f"launch (median of 20){prior}, decode {B * L / ms * 1e3:.6e} info bits/s, chain "
              f"{chain_bits / chain_s:.6e} "
              f"info bits/s ({chain_s * 1e3:.1f} ms per step), BER {ber:.6e}, iterations "
              f"{int(iters.sum())} (max frame {int(iters.max())}, median "
              f"{float(iters.double().median()):.0f}{spread}), bound {b_ms[0]:.4f} ms "
              f"({b_ms[1]}; operations "
              f"{ops_ms:.4f} ms at {est}, bytes "
              f"{bytes_ms:.4f} ms); plain machine on the same {B} frames: {plain_ms:.1f} ms, "
              f"outputs equal")
        plan_line = (plan_text if decoder == "fano" else stack_plan_text)(False, code, dev)
        print(f"  {slowest_alone(torch, decoder, code, d, got)}; {plan_line}")
        if name not in times:
            times[name], plain[name], bound[name] = ms, plain_ms, b_ms
        del got, d, bits
    return times, plain, bound


def slowest_alone(torch, decoder: str, code, d, got) -> str:
    """Kernel 9 or 10 launched again on the batch's slowest frame alone (the
    serial chain of one walk: ns per iteration), held against the first
    launch (``got``)."""
    from convolutional_codes_tpu_torch.ops.fano import FANO_TIMEOUT
    iters = got[1]["iters"]
    j = int(iters.argmax())
    alone, alone_ms = cuda_call(lambda: decode_supplied(decoder, code, d[j:j + 1], True,
                                                        FANO_TIMEOUT))
    require(torch.equal(alone[0][0], got[0][j]) and int(alone[1]["iters"][0]) == int(iters[j]),
            f"{decoder} decode of its slowest frame alone differs")
    return (f"slowest frame alone (B=1, {int(iters[j])} iterations): {alone_ms:.3f} ms, "
            f"{alone_ms * 1e6 / int(iters[j]):.1f} ns per iteration")


def longframe_instr_per_symbol(code, channel: str) -> int:
    """Estimated lane-instructions per window symbol of kernel 6 (not
    measured: ncu does not run on the card's machine): ~8 per state for
    the ACS, ~20 per coordinate hash (1 + symlen on BSC, 3 on AWGN), ~80
    for log/sqrt/sin/cos and ~4 per point for the distances on AWGN, and
    ~30 for the encoder, the decision stores and the traceback."""
    if channel == "bsc":
        stage = 20 * (1 + code.symlen_out) + 3 * code.points_per_symbol
    else:
        stage = 60 + 80 + 4 * code.points_per_symbol
    return 8 * code.num_states + stage + 30


def measure_longframe(torch, dev, card, clock, stats, sass):
    """Kernel 6 at BASELINE configs 0 and 2 (warm calls, fresh seeds, walls
    of about 2 s), kernels 4-5 at both real-data decode shapes, each beside
    its bound and its plain version, whose outputs on the same inputs the
    kernels must match: kernel 6 exactly on BSC (at most 1% of lanes
    different on AWGN), kernels 4-5 bit for bit.  Kernel 4 also at B = 1,
    where one warp's chain is all that runs (B = 128 puts one such warp on
    each SM), with ``sass["stream_acs_instr"]``, its SASS instructions a
    step."""
    from convolutional_codes_tpu_torch import get_code
    from convolutional_codes_tpu_torch.ops import fused_longframe as fl
    from convolutional_codes_tpu_torch.ops import longframe_cuda as lc
    from convolutional_codes_tpu_torch.ops import viterbi_cuda as vc
    from convolutional_codes_tpu_torch.ops.channels import awgn_sigma
    from convolutional_codes_tpu_torch.ops.fused_longframe import (
        mc_longframe_viterbi, mc_longframe_viterbi_ref)
    from convolutional_codes_tpu_torch.ops.viterbi import BIG_METRIC
    from convolutional_codes_tpu_torch.utils.bitops import first_argmin

    times, plain, bound = {}, {}, {}
    slots = SMS * LANE_SLOTS_PER_SM * clock
    window, Tw = 1920, 1920 + 2 * 128
    for n, (ck, channel, point, lanes, windows) in enumerate(LONGFRAME_CONFIGS):
        code = get_code(ck)
        param = float(awgn_sigma(point)) if channel == "awgn" else point
        kw = dict(channel=channel, device=dev)
        run = lambda seed: mc_longframe_viterbi(code, lanes, windows, seed, param, **kw)
        run(1)
        torch.cuda.synchronize()
        t0 = time.time()
        run(2)
        torch.cuda.synchronize()
        calls = max(2, int(2.0 / max(time.time() - t0, 1e-4)))
        t0 = time.time()
        outs = [run(100 + i) for i in range(calls)]
        torch.cuda.synchronize()
        dt = time.time() - t0
        bits = lanes * windows * window * calls
        ms = dt * 1e3 / calls
        ops_ms = (lanes * windows * Tw * longframe_instr_per_symbol(code, channel)
                  / slots * 1e3)
        rows, nw, _ = fl.decision_scratch_shape(code.num_states, window, 128, lanes)
        bytes_ms = lanes * windows * rows * nw * 4 * 2 / HBM_BYTES_PER_S * 1e3
        print(f"long-frame config {'02'[n]} [{card}]: kernel 6, {code.name} {channel} "
              f"{point:g}, {lanes} lanes x {windows} windows x {calls} calls: "
              f"{bits / dt:.6e} info bits/s, BER {sum(int(o[0].sum()) for o in outs) / bits:.6e}, "
              f"{ms:.3f} ms per launch (before: {BEFORE_MS['mc_longframe'][n]:.3f} ms); bound "
              f"{max(ops_ms, bytes_ms):.3f} ms (operations "
              f"{ops_ms:.3f} ms at ~{longframe_instr_per_symbol(code, channel)} instr./symbol "
              f"estimated, decision bytes {bytes_ms:.3f} ms)")
        (be_r, we_r), plain_ms = cuda_call(
            lambda: mc_longframe_viterbi_ref(code, lanes, windows, 100, param, **kw))
        be, we = outs[0]
        diff = int(((be != be_r) | (we != we_r)).sum())
        stats["mc_longframe"] = max(stats["mc_longframe"], float(
            torch.maximum((be - be_r).abs(), (we - we_r).abs()).max()))
        print(f"plain long-frame chain [{card}]: same shape and seed, one call {plain_ms:.1f} ms; "
              f"{diff}/{lanes} lanes differ from the kernel, bit errors {int(be.sum())} "
              f"(plain {int(be_r.sum())})")
        require(diff <= (0 if channel == "bsc" else lanes // 100),
                f"long-frame kernel vs plain at config {'02'[n]}: {diff} lanes differ")
        del outs
        if n == 0:
            times["mc_longframe"], plain["mc_longframe"] = ms, plain_ms
            bound["mc_longframe"] = ((ops_ms, "operations") if ops_ms >= bytes_ms
                                     else (bytes_ms, "bytes"))
        del be_r, we_r

    code = get_code("nasa-k7")
    S, M, nw = code.num_states, code.points_per_symbol, (code.num_states + 31) // 32
    g = torch.Generator(device=dev).manual_seed(5)
    for n, (B, T) in enumerate(LONGFRAME_DECODE_SHAPES):
        d = torch.rand((T, M, B), generator=g, device=dev) * 8.0
        init = torch.full((S, B), BIG_METRIC, device=dev)
        init[0] = 0.0
        fm, dec = lc.stream_acs_cuda(code, d, init, False)
        start = first_argmin(fm, dim=0).to(torch.int32)
        bits, carry = lc.stream_traceback_cuda(code, dec, start)
        k = {"stream_acs": cuda_ms(lambda: lc.stream_acs_cuda(code, d, init, False), 10),
             "stream_traceback": cuda_ms(lambda: lc.stream_traceback_cuda(code, dec, start), 10)}
        (fm_r, dec_r), p_acs = cuda_call(lambda: lc.stream_acs_ref(code, d, init, False))
        (bits_r, carry_r), p_tb = cuda_call(lambda: lc.stream_traceback_ref(code, dec, start))
        err = float((fm - fm_r).abs().max())
        same = (err == 0.0 and torch.equal(dec, dec_r) and torch.equal(bits, bits_r)
                and torch.equal(carry, carry_r))
        stats["stream_acs"] = max(stats["stream_acs"], err)
        stats["stream_traceback"] = max(stats["stream_traceback"],
                                        float((bits - bits_r).abs().max()))
        p = {"stream_acs": p_acs, "stream_traceback": p_tb}
        b = {"stream_acs": max(((T * M + 2 * S + T * nw) * 4 * B / HBM_BYTES_PER_S * 1e3,
                                "bytes"), (8 * S * T * B / slots * 1e3, "operations")),
             "stream_traceback": ((T * nw + 2 + T) * 4 * B / HBM_BYTES_PER_S * 1e3, "bytes")}
        print(f"stream kernels [{card}]: nasa-k7 B={B} T={T} ({T} dependent steps): "
              f"stream_acs {k['stream_acs']:.4f} ms (before: "
              f"{BEFORE_MS['stream_acs'][B]:.4f} ms; plain {p['stream_acs']:.1f} ms, bound "
              f"{b['stream_acs'][0]:.4f} ms {b['stream_acs'][1]}), stream_traceback "
              f"{k['stream_traceback']:.4f} ms (plain {p['stream_traceback']:.1f} ms, bound "
              f"{b['stream_traceback'][0]:.4f} ms bytes); decode "
              f"{B * (T - 6) / (k['stream_acs'] + k['stream_traceback']) * 1e3:.4e} info bits/s; "
              f"fm, decisions, bits and carry {'equal to' if same else 'DIFFERENT from'} the "
              f"plain versions (max |fm diff| {err:g})")
        require(same, f"stream kernels vs plain at B={B}, T={T}")
        for plan in (vc.TracebackPlan("frame", T), vc.TracebackPlan("segments", 64),
                     vc.TracebackPlan("segments", 128), vc.TracebackPlan("segments", 256)):
            got = lc.stream_traceback_cuda(code, dec, start, plan)
            require(torch.equal(got[0], bits_r) and torch.equal(got[1], carry_r),
                    f"stream traceback {plan} vs plain at B={B}, T={T}")
            pms = cuda_ms(lambda: lc.stream_traceback_cuda(code, dec, start, plan), 10)
            print(f"stream_traceback [{card}] B={B} T={T} {plan}"
                  f"{' (the plan)' if plan == vc.traceback_plan(B, T, S) else ''}: "
                  f"{pms:.4f} ms (before: {BEFORE_MS['stream_traceback'][B]:.4f} ms; bound "
                  f"{b['stream_traceback'][0]:.4f} ms), bits and carry equal to the plain version")
        if n == 0:
            for name in ("stream_acs", "stream_traceback"):
                times[name], plain[name], bound[name] = k[name], p[name], b[name]
            # one frame: a warp's dependent chain alone
            d1, i1 = d[:, :, :1].contiguous(), init[:, :1].contiguous()
            one = lc.stream_acs_cuda(code, d1, i1, False)
            ms1 = cuda_ms(lambda: lc.stream_acs_cuda(code, d1, i1, False), 5)
            require(torch.equal(one[0], fm[:, :1]) and torch.equal(one[1], dec[:, :, :1]),
                    "stream ACS at B = 1 differs from the same frame at B = 128")
            cycles = ms1 * 1e-3 * clock / T
            print(f"stream_acs [{card}]: nasa-k7 B=1 T={T}: {ms1:.4f} ms (before: "
                  f"{BEFORE_MS['stream_acs'][1]:.4f} ms; B={B}: "
                  f"{k['stream_acs'] / ms1:.3f} x this), {cycles:.1f} cycles a step at the "
                  f"maximum clock for {sass['stream_acs_instr']:.1f} SASS instructions "
                  f"({cycles / sass['stream_acs_instr']:.2f} cycles an instruction); equal "
                  f"to the frame at B={B}")
        del d, dec, dec_r
    return times, plain, bound


#: kernel 6 at S = 128 and 256 (thread groups of 4 and 8): config 2's
#: shape and channel (65,536 lanes x 2 windows, AWGN 6 dB) with wider codes
WIDE_LONGFRAME = (("k8-r12", 65536, 2), ("k9-r12", 65536, 2))


def measure_longframe_wide(torch, dev, card, fl, plain: bool):
    """Kernel 6 of the package ``fl`` (ops.fused_longframe) at
    WIDE_LONGFRAME, ms per launch (CUDA events, mean of 3 warm calls), the
    bit errors; with ``plain``, held against the plain version on the same
    seed (at most 1% of lanes different).  Also run on an older tree of the
    repo (``--wide-longframe DIR``) to time the layout it had there."""
    from convolutional_codes_tpu_torch import get_code
    from convolutional_codes_tpu_torch.ops.channels import awgn_sigma

    sigma = float(awgn_sigma(6.0))
    for ck, lanes, windows in WIDE_LONGFRAME:
        code = k8_code() if ck == "k8-r12" else get_code(ck)
        run = lambda seed: fl.mc_longframe_viterbi(code, lanes, windows, seed, sigma,
                                                   channel="awgn", device=dev)
        be, we = run(100)
        ms = cuda_ms(lambda: run(101), 3)
        layout = (f"{fl.threads_per_lane(code.num_states)} thread(s) a lane"
                  if hasattr(fl, "threads_per_lane") else "one thread a lane")
        line = (f"long-frame wide [{card}]: kernel 6, {code.name} (S={code.num_states}) AWGN 6 "
                f"dB, {lanes} lanes x {windows} windows, {layout}: {ms:.3f} ms per launch, "
                f"bit errors {int(be.sum())}")
        if plain:
            be_r, we_r = fl.mc_longframe_viterbi_ref(code, lanes, windows, 100, sigma,
                                                     channel="awgn", device=dev)
            diff = int(((be != be_r) | (we != we_r)).sum())
            line += (f" (plain {int(be_r.sum())}), {diff}/{lanes} lanes differ from the "
                     "plain version")
            require(diff <= lanes // 100, f"long-frame {code.name} vs plain: {diff} lanes differ")
            del be_r, we_r
        print(line)


def measure_traceback_crossover(torch, dev, card):
    """Kernel 5 on both designs (forced through the plan) where the plan
    switches between them: nasa-k7 at B = 1, T = 65,536, and T = 4,096 at
    B = 1,024 .. 65,536 for S = 4, 32, 64 and 256, each held bit for bit
    against the plain version on the same random decisions."""
    from convolutional_codes_tpu_torch import get_code
    from convolutional_codes_tpu_torch.ops import longframe_cuda as lc
    from convolutional_codes_tpu_torch.ops import viterbi_cuda as vc

    gen = torch.Generator(device=dev).manual_seed(8)
    shapes = [("nasa-k7", 1, 65536)] + [
        (name, B, 4096) for name in ("k3-75", "k6-r12", "nasa-k7", "k9-r12")
        for B in (1024, 4096, 6144, 8192, 16384, 65536)]
    for name, B, T in shapes:
        code = get_code(name)
        S = code.num_states
        dec = random_decisions(torch, S, T, B, gen)
        start = torch.randint(0, S, (B,), generator=gen, device=dev, dtype=torch.int32)
        want = lc.stream_traceback_ref(code, dec, start)
        bound = (T * ((S + 31) // 32) + 2 + T) * 4 * B / HBM_BYTES_PER_S * 1e3
        line = []
        for plan in (vc.TracebackPlan("frame", T), vc.TracebackPlan("segments", vc.SEGMENT_ROWS)):
            got = lc.stream_traceback_cuda(code, dec, start, plan)
            require(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
                    f"stream traceback {plan} vs plain {name} B={B} T={T}")
            ms = cuda_ms(lambda: lc.stream_traceback_cuda(code, dec, start, plan), 5)
            line.append(f"{plan.design} {ms:.4f} ms")
        print(f"stream_traceback crossover [{card}] {name} (S={S}) B={B} T={T}: "
              f"{', '.join(line)}; plan: {vc.traceback_plan(B, T, S).design}; bound "
              f"{bound:.4f} ms (bytes); both equal to the plain version")
        del dec


#: (code, B, T, hard) of kernel 1 (code 0) and kernel 4 in ``--kernel-times``:
#: kernel 1's shape, one frame alone (B = 1: one warp's chain), both decode
#: shapes soft and hard, and B = 128 frames at every S from 4 to 256
KERNEL4_TIMES = ((0, 262144, 42, False), ("nasa-k7", 1, 65536, False),
                 ("nasa-k7", 128, 65536, False),
                 ("nasa-k7", 1024, 16384, False), ("nasa-k7", 128, 65536, True),
                 ("nasa-k7", 1024, 16384, True), ("k3-75", 128, 16384, False),
                 ("k4-r12", 128, 16384, False), ("k5-r12", 128, 16384, False),
                 ("k6-r12", 128, 16384, False), ("k8-r12", 128, 16384, False),
                 ("k9-r12", 128, 16384, False))


#: kernel 7 in ``--kernel-times``: phase 5's four stack rows at 8192 lanes
#: with fewer frames a lane, (code, Eb/N0, frames per lane)
KERNEL7_TIMES = (("k9-r12", 4.0, 32), ("k9-r12", 8.0, 256), (0, 8.0, 1024), (0, 0.0, 64))


def sequential_times(torch, dev, ref_path) -> None:
    """Kernels 7-10 in ``--kernel-times``: kernel 7 at KERNEL7_TIMES, kernel
    9 on the chain's code-0 and k9-r12 frames at B = 131,072 (held against
    the plain machine on them), kernel 8 at code 0 AWGN 8 dB (8192 lanes x
    64) and kernel 10 at code 0, B = 131,072.  Kernels 7, 8 and 10's
    outputs go to ``ref_path`` when it does not exist yet, else they must
    equal what it holds (another tree's, same seeds)."""
    from convolutional_codes_tpu_torch import get_code
    from convolutional_codes_tpu_torch.ops.channels import awgn_sigma
    from convolutional_codes_tpu_torch.ops.fano_cuda import fano_decode_cuda
    from convolutional_codes_tpu_torch.ops.fano_mc import mc_fano
    from convolutional_codes_tpu_torch.ops.stack_cuda import stack_machine_cuda
    from convolutional_codes_tpu_torch.ops.stack_mc import mc_stack
    from convolutional_codes_tpu_torch.sim.chain import chain_frames

    outs = {}
    for ck, snr, fpl in KERNEL7_TIMES:
        code, sigma = get_code(ck), float(awgn_sigma(snr))
        run = lambda: mc_stack(code, 8192, fpl, 500, sigma, device=dev)
        outs[f"kernel 7 {code.name} {snr:g} dB"] = run().cpu()
        ms = cuda_ms(run, 2)
        print(f"  kernel 7: {code.name} AWGN soft {snr:g} dB, 8192 lanes x {fpl}: {ms:.3f} ms "
              f"per launch ({8192 * fpl * code.block_length / ms * 1e3:.6e} info bits/s)")
    sigma8 = float(awgn_sigma(8.0))
    for n, ck in enumerate((0, "k9-r12")):
        code = get_code(ck)
        _, d = chain_frames(code, "awgn", SUPPLIED_FRAMES,
                            torch.Generator(device=dev).manual_seed(70 + 2 * n), sigma8)
        run = lambda: stack_machine_cuda(code, d, True)
        got = run()
        ms = cuda_ms(run, 10)
        bad, _ = supplied_diff(torch, (got[0], {"metric": got[1], "iters": got[2]}),
                               decode_plain("stack", code, d, True, 0))
        require(not bad, f"kernel 9 {code.name}: {bad} differ from the plain machine")
        print(f"  kernel 9: {code.name} AWGN soft 8 dB, B={SUPPLIED_FRAMES}: {ms:.4f} ms, "
              f"equal to the plain machine")
        del d
    code = get_code(0)
    run = lambda: mc_fano(code, 8192, 64, 500, sigma8, device=dev)
    outs["kernel 8 code 0 8 dB"] = run().cpu()
    print(f"  kernel 8: code 0 AWGN soft 8 dB, 8192 lanes x 64: {cuda_ms(run, 2):.3f} ms")
    _, d = chain_frames(code, "awgn", SUPPLIED_FRAMES, torch.Generator(device=dev).manual_seed(71),
                        sigma8)
    run = lambda: fano_decode_cuda(code, d, True, with_diag=True)
    bits, diag = run()
    outs["kernel 10 code 0 8 dB"] = torch.stack([bits.sum(1).long(), diag["iters"]]).cpu()
    print(f"  kernel 10: code 0 AWGN soft 8 dB, B={SUPPLIED_FRAMES}: {cuda_ms(run, 5):.4f} ms")
    if ref_path is None:
        return
    if not os.path.exists(ref_path):
        torch.save(outs, ref_path)
        print(f"  outputs of kernels 7, 8 and 10 saved to {ref_path}")
        return
    ref = torch.load(ref_path)
    require(ref.keys() == outs.keys() and all(torch.equal(ref[k], v) for k, v in outs.items()),
            f"kernels 7, 8, 10: outputs differ from {ref_path}")
    print(f"  outputs of kernels 7, 8 and 10 equal to {ref_path}'s")


def wide_code():
    """K = 7, rate 1/8 (256 points, WIDE_BITS' constellation): nasa-k7's
    polynomials and six more, for the times of the kernels' large-M paths.
    Its sequential metrics suit rate 1/8, as the registered codes' suit
    theirs: hard (1, -7), the ratio of Fano's bit metrics log2(2(1-p)) - R
    and log2(2p) - R at p = 0.01 (0.86 : -5.77); soft weight -0.25, so that
    the correct path's 1 + w * dist stays positive in expectation at the
    12 dB of measure_wide (E[dist] = 2 sigma^2 / ndist = 2.68 there)."""
    from convolutional_codes_tpu_torch.models.codebook import Code
    return Code(name="k7-r18", symlen_out=8, constraint_length=7, block_length=40,
                polynomials=(0o171, 0o133, 0o165, 0o117, 0o127, 0o155, 0o135, 0o147),
                bit_metrics=(1, -7), fano_bit_metrics=(1, -7), metric_weight=-0.25,
                fano_metric_weight=-0.25)


def used_columns(code) -> int:
    """Distinct expected symbols of the code's transitions: the columns of
    M distances a trellis step reads (at most 2S)."""
    from convolutional_codes_tpu_torch.models.tables import code_tables
    return len(np.unique(code_tables(code).esym_prev_np))


#: kernel 4 at M = 256 (wide_code, soft): frames and steps
LARGE_M_STREAM = (128, 16384)
#: kernel 6 at M = 256 (wide_code): config 2's lanes, windows and point
LARGE_M_LONGFRAME = (65536, 2, "awgn", 6.0)


def wide_stream_acs(torch, dev):
    """Kernel 4 at M = 256 (LARGE_M_STREAM): (run, its inputs)."""
    from convolutional_codes_tpu_torch.ops import longframe_cuda as lc
    from convolutional_codes_tpu_torch.ops.viterbi import BIG_METRIC
    code = wide_code()
    B, T = LARGE_M_STREAM
    g = torch.Generator(device=dev).manual_seed(9)
    d = torch.rand((T, code.points_per_symbol, B), generator=g, device=dev) * 8.0
    init = torch.full((code.num_states, B), BIG_METRIC, device=dev)
    init[0] = 0.0
    return (lambda: lc.stream_acs_cuda(code, d, init, False)), (d, init)


def wide_longframe(dev):
    """Kernel 6 at M = 256 (LARGE_M_LONGFRAME): run(seed)."""
    from convolutional_codes_tpu_torch.ops import fused_longframe as fl
    from convolutional_codes_tpu_torch.ops.channels import awgn_sigma
    code = wide_code()
    lanes, windows, channel, point = LARGE_M_LONGFRAME
    param = float(awgn_sigma(point)) if channel == "awgn" else point
    return lambda seed: fl.mc_longframe_viterbi(code, lanes, windows, seed, param,
                                                channel=channel, device=dev)


def walk_read_bytes(iters, code, decoder: str) -> float:
    """Bytes that kernel 9 or 10 must move on [B, T, M] frames whose walks
    took ``iters`` iterations: per iteration the two branches' distances,
    each in a sector of SECTOR_BYTES, but no more than a frame's T x M
    floats; and per frame its bits, metric and iterations (and Fano's
    timeout_left and depth) written once."""
    T, M, L = code.num_block_symbols, code.points_per_symbol, code.block_length
    reads = float(iters.double().mul(2 * SECTOR_BYTES).clamp(max=T * M * 4).sum())
    return reads + iters.numel() * (L * 4 + 4 + 8 + (8 if decoder == "fano" else 0))


def measure_wide(torch, dev, card, clock) -> None:
    """The kernels' paths for codes of 32-256 points at wide_code (rate
    1/8, S = 64, M = 256), each beside its bound: kernel 1 (16,384 blocks)
    and kernel 4 (LARGE_M_STREAM) equal to their plain versions, kernel 6
    (LARGE_M_LONGFRAME) at most 1% of lanes off the plain version on 1024
    lanes, kernels 7-8 (8192 lanes x 1, AWGN 12 dB) per lane equal to
    mc_stack_ref / mc_fano_ref on 256 lanes, and kernels 9-10 (16,384
    chain frames, AWGN 12 dB) equal to the plain machines on their first
    256 frames; the Fano checks at a budget of 100 a bit, so that no plain
    walk runs for minutes.  The walks' iterations a bit and largest walk
    are printed beside the budget.  Bounds as the rest of phase 5: bytes
    once at HBM_BYTES_PER_S (kernels 1, 4: the step's used_columns of the
    M distances; kernels 9-10 walk_read_bytes), lane-operations (8 S a
    step; kernel 6 longframe_instr_per_symbol; the walks their
    iterations), the larger of the two."""
    from convolutional_codes_tpu_torch.ops import fano_cuda, fano_mc, stack_cuda, stack_mc
    from convolutional_codes_tpu_torch.ops import fused_longframe as fl
    from convolutional_codes_tpu_torch.ops import longframe_cuda as lc
    from convolutional_codes_tpu_torch.ops import viterbi_cuda as vc
    from convolutional_codes_tpu_torch.ops.channels import awgn_sigma
    from convolutional_codes_tpu_torch.ops.fano import FANO_TIMEOUT
    from convolutional_codes_tpu_torch.ops.viterbi import BIG_METRIC
    from convolutional_codes_tpu_torch.sim.chain import chain_frames

    t_all = time.time()
    register_wide_constellations()
    code = wide_code()
    S, M, T = code.num_states, code.points_per_symbol, code.num_block_symbols
    cols, rate = used_columns(code), SMS * LANE_SLOTS_PER_SM * clock
    print(f"large-M paths on {code.name} (S={S}, M={M}, {cols} columns a step) [{card}]")
    # kernel 1: the modular chain's ACS on 16,384 blocks
    B = 16384
    g = torch.Generator(device=dev).manual_seed(8)
    d = torch.rand((T, M, B), generator=g, device=dev) * 8.0
    init = torch.full((S, B), BIG_METRIC, device=dev)
    init[0] = 0.0
    run = lambda: vc.acs_forward_cuda(code, d, init, False)
    require(all(torch.equal(a, w) for a, w in zip(run(), vc.acs_forward_ref(code, d, init,
                                                                            False))),
            "kernel 1 at M = 256 differs from the plain version")
    ms = cuda_ms(run, 20)
    nbytes = 4 * B * (T * cols + 2 * S + T * ((S + 31) // 32))
    ops = 8 * S * T * B / rate
    print(f"  kernel 1: B={B} T={T}: {ms:.4f} ms; bound "
          f"{max(nbytes / HBM_BYTES_PER_S, ops) * 1e3:.4f} ms (bytes "
          f"{nbytes / HBM_BYTES_PER_S * 1e3:.4f}, ops {ops * 1e3:.4f}); equal to the plain version")
    del d, init
    # kernel 4: long frames
    run, (d, init) = wide_stream_acs(torch, dev)
    Bw, Tw = LARGE_M_STREAM
    d2 = d[:2049].contiguous()
    require(all(torch.equal(a, w) for a, w in zip(lc.stream_acs_cuda(code, d2, init, False),
                                                  lc.stream_acs_ref(code, d2, init, False))),
            "kernel 4 at M = 256 differs from the plain version")
    run()
    ms = cuda_ms(run, 5)
    nbytes = 4 * Bw * (Tw * cols + 2 * S + Tw * ((S + 31) // 32))
    ops = 8 * S * Tw * Bw / rate
    print(f"  kernel 4: B={Bw} T={Tw}: {ms:.4f} ms; bound "
          f"{max(nbytes / HBM_BYTES_PER_S, ops) * 1e3:.4f} ms (bytes "
          f"{nbytes / HBM_BYTES_PER_S * 1e3:.4f}, ops {ops * 1e3:.4f}); equal to the plain "
          "version on 2,049 steps")
    del d, d2, init
    # kernel 6: the long-frame chain at config 2's lanes
    run = wide_longframe(dev)
    lanes, windows, channel, point = LARGE_M_LONGFRAME
    param = float(awgn_sigma(point))
    be, we = fl.mc_longframe_viterbi(code, 1024, 1, 31, param, channel=channel, device=dev)
    be_r, we_r = fl.mc_longframe_viterbi_ref(code, 1024, 1, 31, param, channel=channel,
                                             device=dev)
    off = int(((be != be_r) | (we != we_r)).sum())
    require(off <= 1024 // 100, f"kernel 6 at M = 256: {off} of 1024 lanes differ")
    run(100)
    ms = cuda_ms(lambda: run(101), 2)
    Tw6 = 1920 + 2 * 128
    ops = lanes * windows * Tw6 * longframe_instr_per_symbol(code, channel) / rate
    print(f"  kernel 6: {channel} {point:g} dB, {lanes} lanes x {windows} windows: {ms:.3f} ms "
          f"({lanes * windows * 1920 / ms * 1e3:.4e} info bits/s); bound {ops * 1e3:.3f} ms "
          f"(ops, est.); {off}/1024 lanes off the plain version")
    # kernels 7-8 and 9-10
    sigma, L, budget = float(awgn_sigma(12.0)), code.block_length, FANO_TIMEOUT * T
    for name, mc, ref in (("7 stack", stack_mc.mc_stack, stack_mc.mc_stack_ref),
                          ("8 Fano", fano_mc.mc_fano, fano_mc.mc_fano_ref)):
        kw = {} if name[0] == "7" else {"timeout_per_bit": 100}
        got = mc(code, 256, 1, 41, sigma, device=dev, **kw)
        want = ref(code, 256, 1, 41, sigma, device=dev, **kw)
        require(torch.equal(got, want), f"kernel {name} at M = 256 differs from its plain "
                f"version on {int((got != want).any(0).sum())} of 256 lanes")
        out = mc(code, 8192, 1, 41, sigma, device=dev)
        ms = cuda_ms(lambda: mc(code, 8192, 1, 42, sigma, device=dev), 2)
        bound = iteration_bound_ms("mc_stack" if name[0] == "7" else "mc_fano_wide",
                                   out[2].cpu(), clock, code)
        print(f"  kernel {name}: AWGN 12 dB, 8192 lanes x 1: {ms:.3f} ms "
              f"({8192 * L / ms * 1e3:.4e} info bits/s), {int(out[2].sum())} iterations "
              f"({float(out[2].sum()) / (8192 * L):.3f} a bit, largest walk "
              f"{int(out[2].max())} of the Fano budget {budget}); bound {bound:.4f} ms (ops); "
              f"{int(out[0].sum())} bit errors; equal to the plain version on 256 lanes")
    _, d = chain_frames(code, "awgn", B, torch.Generator(device=dev).manual_seed(43), sigma)
    head = d[:256].contiguous()
    for name, decoder, run, check in (
            ("9 stack", "stack", lambda: stack_cuda.stack_machine_cuda(code, d, True),
             lambda: stack_cuda.stack_machine_cuda(code, head, True)),
            ("10 Fano", "fano", lambda: fano_cuda.fano_decode_cuda(code, d, True, FANO_TIMEOUT,
                                                                   with_diag=True),
             lambda: fano_cuda.fano_decode_cuda(code, head, True, 100, with_diag=True))):
        got = check()
        got = (got[0], {"metric": got[1], "iters": got[2]}) if decoder == "stack" else got
        bad, _ = supplied_diff(torch, got, decode_plain(decoder, code, head, True, 100))
        require(not bad, f"kernel {name} at M = 256: {bad} differ from the plain machine")
        got = run()
        iters = (got[2] if decoder == "stack" else got[1]["iters"]).cpu()
        ms = cuda_ms(run, 5)
        bytes_ms = walk_read_bytes(iters, code, decoder) / HBM_BYTES_PER_S * 1e3
        ops_ms = (stack_ops(code, "awgn", iters, 1, False) if decoder == "stack"
                  else float(iters.sum()) * INSTR_PER_ITER["fano_decode_wide"]) / rate * 1e3
        print(f"  kernel {name}: AWGN 12 dB, B={B}: {ms:.4f} ms "
              f"({B * L / ms * 1e3:.4e} info bits/s of decode), {int(iters.sum())} iterations "
              f"({float(iters.sum()) / (B * L):.3f} a bit, largest walk {int(iters.max())}); "
              f"bound {max(bytes_ms, ops_ms):.4f} ms "
              f"({'bytes' if bytes_ms >= ops_ms else 'operations'}; bytes {bytes_ms:.4f} ms "
              f"read by the walks, operations {ops_ms:.4f} ms); equal to the plain machine "
              "on 256 frames")
    del d, head
    print(f"large-M paths measured [{time.time() - t_all:.1f} s]")


def kernel_times(torch, dev, card, ref_path=None) -> None:
    """Kernels 1, 3, 4 and 6-10 of the package first on sys.path at phase
    5's shapes, device milliseconds (CUDA events, mean of warm launches) on
    the same inputs from any tree: kernel 3 at the headline shape per MC
    step, kernel 1 and kernel 4 at KERNEL4_TIMES' shapes, kernel 6 at
    configs 0 and 2, kernels 7-10 as ``sequential_times``."""
    import convolutional_codes_tpu_torch as pkg
    from convolutional_codes_tpu_torch import get_code
    from convolutional_codes_tpu_torch.ops import fused_longframe as fl
    from convolutional_codes_tpu_torch.ops import longframe_cuda as lc
    from convolutional_codes_tpu_torch.ops import viterbi_cuda as vc
    from convolutional_codes_tpu_torch.ops.channels import awgn_sigma
    from convolutional_codes_tpu_torch.ops.fused_chain import mc_chain_viterbi
    from convolutional_codes_tpu_torch.ops.viterbi import BIG_METRIC

    from convolutional_codes_tpu_torch.utils import build

    build.build_all()
    print(f"kernel times of {os.path.dirname(os.path.abspath(pkg.__file__))} [{card}]")
    code = get_code(0)
    sigma, B, nsteps = float(awgn_sigma(8.0)), 1 << 20, 16
    mc_chain_viterbi(code, B, nsteps, 1, sigma, device=dev)
    ms = cuda_ms(lambda: mc_chain_viterbi(code, B, nsteps, 100, sigma, device=dev), 4) / nsteps
    print(f"  kernel 3: code 0 AWGN 8 dB, {B} lanes x {nsteps} steps: {ms:.4f} ms per step "
          f"({B * code.block_length / ms * 1e3:.6e} info bits/s of device time)")
    if "variant" in inspect.signature(mc_chain_viterbi).parameters:   # trees with fast_demap
        run = lambda: mc_chain_viterbi(code, B, nsteps, 100, sigma, device=dev,
                                       variant="fast_demap")
        run()
        ms = cuda_ms(run, 4) / nsteps
        print(f"  kernel 3 fast_demap: same shape: {ms:.4f} ms per step "
              f"({B * code.block_length / ms * 1e3:.6e} info bits/s of device time)")
    for ck, B, T, hard in KERNEL4_TIMES:
        code = k8_code() if ck == "k8-r12" else get_code(ck)
        g = torch.Generator(device=dev).manual_seed(3)
        shape = (T, code.points_per_symbol, B)
        d = (torch.randint(0, code.symlen_out + 1, shape, generator=g, device=dev).float()
             if hard else torch.rand(shape, generator=g, device=dev) * 8.0)
        init = torch.full((code.num_states, B), BIG_METRIC, device=dev)
        init[0] = 0.0
        run = ((lambda: vc.acs_forward_cuda(code, d, init, hard)) if ck == 0
               else (lambda: lc.stream_acs_cuda(code, d, init, hard)))
        run()
        ms = cuda_ms(run, 200 if ck == 0 else 10)
        # held against the plain version, kernel 4 on the first 2,049 steps
        if ck == 0:
            got, want = run(), vc.acs_forward_ref(code, d, init, hard)
        else:
            d2 = d[:2049].contiguous()
            got = lc.stream_acs_cuda(code, d2, init, hard)
            want = lc.stream_acs_ref(code, d2, init, hard)
        require(all(torch.equal(a, w) for a, w in zip(got, want)),
                f"kernel {1 if ck == 0 else 4} differs from the plain version: {code.name}")
        print(f"  kernel {1 if ck == 0 else 4}: {code.name} (S={code.num_states}) "
              f"{'hard' if hard else 'soft'} B={B} T={T}: {ms:.4f} ms, equal to the plain "
              "version")
        del d, init
    for ck, channel, point, lanes, windows in LONGFRAME_CONFIGS:
        code = get_code(ck)
        param = float(awgn_sigma(point)) if channel == "awgn" else point
        run = lambda: fl.mc_longframe_viterbi(code, lanes, windows, 100, param,
                                              channel=channel, device=dev)
        run()
        print(f"  kernel 6: {code.name} {channel}, {lanes} lanes x {windows} windows: "
              f"{cuda_ms(run, 3):.3f} ms per launch")
    sequential_times(torch, dev, ref_path)
    if vc.KERNEL_MAX_POINTS < 256:
        print("  kernels 4 and 6 at M = 256: this tree refuses codes of more than "
              f"{vc.KERNEL_MAX_POINTS} points")
        return
    register_wide_constellations()
    run, _ = wide_stream_acs(torch, dev)
    run()
    B, T = LARGE_M_STREAM
    print(f"  kernel 4: {wide_code().name} (M=256) soft B={B} T={T}: {cuda_ms(run, 5):.4f} ms")
    run = wide_longframe(dev)
    run(100)
    lanes, windows, channel, _ = LARGE_M_LONGFRAME
    print(f"  kernel 6: {wide_code().name} (M=256) {channel}, {lanes} lanes x {windows} "
          f"windows: {cuda_ms(lambda: run(100), 3):.3f} ms per launch")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script needs "
              "an NVIDIA GPU", file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--wide-longframe"]:   # kernel 6 at S = 128, 256 of another tree
        sys.path.insert(0, os.path.abspath(sys.argv[2]))
        from convolutional_codes_tpu_torch.ops import fused_longframe as fl
        measure_longframe_wide(torch, torch.device("cuda", 0), card_line(), fl, False)
        return 0
    if sys.argv[1:2] == ["--kernel-times"]:   # kernels 1, 3, 4 and 6-10 of another tree
        sys.path.insert(0, os.path.abspath(sys.argv[2]))
        kernel_times(torch, torch.device("cuda", 0), card_line(),
                     sys.argv[3] if len(sys.argv) > 3 else None)
        return 0
    sys.path.insert(0, ROOT)
    t_start = time.time()
    dev = torch.device("cuda", 0)

    with phase("1 environment"):
        card = card_line()
        print(f"card: {card}")
        nvcc_out = subprocess.run(["/usr/local/cuda/bin/nvcc", "--version"],
                                  capture_output=True, text=True, timeout=60).stdout
        print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
              f"torch.version.cuda {torch.version.cuda}, "
              f"nvcc: {nvcc_out.strip().splitlines()[-1] if nvcc_out else 'missing'}")
        try:
            import triton
            print(f"triton {triton.__version__} imports")
        except ImportError as e:
            print(f"triton does not import: {e}")

    from convolutional_codes_tpu_torch.ops import fano_cuda, fano_mc, stack_cuda, stack_mc
    from convolutional_codes_tpu_torch.ops import viterbi_cuda as vc
    from convolutional_codes_tpu_torch.ops import fused_chain as fc
    from convolutional_codes_tpu_torch.ops import fused_longframe as fl
    from convolutional_codes_tpu_torch.ops import longframe_cuda as lc
    from convolutional_codes_tpu_torch.utils import build

    with phase("2 build"):
        build.build_all()
        for name in build.LIBRARIES:
            print(f"built {name}.cu in {build.build_seconds[name]:.1f} s")
        for name in ("fano_mc", "fano_mc_wide"):
            steps = fano_step_instr(build, name)
            print_ptxas(build.build_log.get(name, ""), name, steps)
            if name == "fano_mc":
                INSTR_PER_ITER["mc_fano"] = steps[("fano_mc_kernel", "SharedNodes")][1]
                INSTR_PER_ITER["fano_decode"] = steps[("fano_decode_kernel", "SharedNodes")][1]
            else:
                INSTR_PER_ITER["mc_fano_wide"] = steps[("fano_mc_kernel", "SharedNodes")][1]
                INSTR_PER_ITER["fano_decode_wide"] = steps[("fano_decode_kernel",
                                                            "SharedNodes")][1]
        for name in ("stack_mc", "stack_mc_wide"):
            print_ptxas_stack(build.build_log.get(name, ""), name)
        print_ptxas_longframe(build.build_log)
        sass = read_sass(build)

    wrappers = {"acs_forward": vc.acs_forward_cuda, "traceback": vc.traceback_cuda,
                "mc_chain": fc.mc_chain_viterbi, "mc_stack": stack_mc.mc_stack,
                "mc_fano": fano_mc.mc_fano, "stream_acs": lc.stream_acs_cuda,
                "stream_traceback": lc.stream_traceback_cuda,
                "mc_longframe": fl.mc_longframe_viterbi,
                "stack_decode": stack_cuda.stack_machine_cuda,
                "fano_decode": fano_cuda.fano_decode_cuda}
    stats = {k: 0.0 for k in wrappers}
    with phase("3 kernels against their plain versions"):
        check_viterbi_kernels(torch, dev, stats)
        check_fused_kernel(torch, dev, stats)
        check_sequential_kernels(torch, dev, stats)
        check_fano_edges(torch, dev, stats)
        check_stack_edges(torch, dev, stats)
        check_lane_offset(torch, dev, stats)
        check_longframe_kernels(torch, dev, stats)
        check_traceback_designs(torch, dev, stats)
        check_longframe_lanes(torch, dev, stats)
        check_random_codes(torch, dev, stats)
        for k, w in wrappers.items():
            require(w.launches > 0, f"kernel {k} was never launched")
        print("launches in the checks: " + ", ".join(
            f"{k}={w.launches}" for k, w in wrappers.items()))

    with open(os.path.join(GOLDENS, "published_curves.json")) as f:
        gold = json.load(f)
    paths = {  # path -> (the kernels it must launch, how to drive it, kernels it must not)
        "viterbi": (("acs_forward", "traceback", "mc_chain"),
                    lambda tmp: check_points(run_main_path(torch, dev, gold, tmp), gold), ()),
        "stack": (("mc_stack",), lambda tmp: check_points(run_sequential_path(
            torch, dev, tmp, "stack", "0.01", range(10, 17)), gold, "ber_coded_a_stack"), ()),
        "fano": (("mc_fano",), lambda tmp: check_points(run_sequential_path(
            torch, dev, tmp, "fano", "0.01", range(10, 14)), gold, "ber_coded_a_fano"), ()),
        "long frames": (("mc_longframe", "stream_acs", "stream_traceback"),
                        lambda tmp: run_longframe_path(torch, dev), ()),
        "supplied-frame stack/Fano": (
            ("stack_decode", "fano_decode"),
            lambda tmp: [check_points([("awgn", r)], gold, f"ber_coded_a_{d}")
                         for d, r in run_supplied_path(torch, dev)],
            ("mc_stack", "mc_fano")),
        "mesh": (("mc_chain", "mc_stack", "mc_fano", "mc_longframe", "stream_acs",
                  "stream_traceback"),
                 lambda tmp: [check_points([row], gold, "ber_coded_a" if
                                           row[1].decoder == "viterbi" else "ber_coded_a_stack")
                              for row in run_mesh_path(torch, dev)], ()),
    }
    launches = {}
    for path, (kernels, drive, absent) in paths.items():
        with phase(f"4 main path: {path}"), tempfile.TemporaryDirectory() as tmp:
            for w in wrappers.values():
                w.launches = 0
            drive(tmp)
            counts = {k: w.launches for k, w in wrappers.items()}
            print(f"launches on the {path} path: " + ", ".join(
                f"{k}={n}" for k, n in counts.items()))
            for k in kernels:
                require(counts[k] > 0, f"kernel {k} was not launched on the {path} path")
                launches[k] = launches.get(k, 0) + counts[k]
            for k in absent:
                require(counts[k] == 0, f"kernel {k} was launched on the {path} path")
    with phase("4 traced point"), tempfile.TemporaryDirectory() as tmp:
        traced_point(torch, tmp)

    with phase("5 throughput"):
        card, clock = card_line(), sm_clock_hz()
        print(f"max SM clock {clock / 1e6:.0f} MHz")
        times, plain, bound = measure(torch, dev, card, clock, sass)
        for measured in (measure_sequential(torch, dev, card, clock),
                         measure_longframe(torch, dev, card, clock, stats, sass),
                         measure_supplied(torch, dev, card, clock, stats)):
            for d in zip((times, plain, bound), measured):
                d[0].update(d[1])
        measure_longframe_wide(torch, dev, card, fl, True)
        measure_traceback_crossover(torch, dev, card)
        compare_fano_plans(torch, dev, card)
        measure_wide(torch, dev, card, clock)

    require("jax" not in sys.modules, "the port imported JAX")
    ref_pkg = sorted(m for m in sys.modules if m.split(".")[0] == "convolutional_codes_tpu")
    require(not ref_pkg, f"the port imported the JAX package: {ref_pkg}")
    print(f"total wall {time.time() - t_start:.1f} s")
    sources = {"acs_forward": ("longframe.cu", "viterbi_pallas.py:86"),
               "traceback": ("longframe.cu", "viterbi_pallas.py:207"),
               "mc_chain": ("fused_chain.cu", "fused_chain.py:400"),
               "mc_stack": ("stack_mc.cu", "stack_mc.py:84"),
               "mc_fano": ("fano_mc.cu", "fano_mc.py:65"),
               "stream_acs": ("longframe.cu", "longframe_pallas.py:142"),
               "stream_traceback": ("longframe.cu", "longframe_pallas.py:218"),
               "mc_longframe": ("longframe_mc.cu", "fused_longframe.py:84"),
               "stack_decode": ("stack_mc.cu", "stack_pallas.py:86"),
               "fano_decode": ("fano_mc.cu", "fano_pallas.py:52")}
    kernels = [{"name": k, "route": "cuda",
                "source": f"convolutional_codes_tpu_torch/csrc/{sources[k][0]}",
                "replaces": f"convolutional_codes_tpu/ops/{sources[k][1]}",
                "launches": launches[k], "max_abs_err": stats[k], "ms": times[k],
                "plain_ms": plain[k], "bound_ms": bound[k][0], "bound_by": bound[k][1],
                "library_ms": None}
               for k in wrappers]
    print(f"card: {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
