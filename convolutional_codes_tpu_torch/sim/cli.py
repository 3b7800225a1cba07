"""Command-line simulation drivers (the reference package's subcommands
and flags):

    python -m convolutional_codes_tpu_torch.sim.cli awgn    --code 0 --decoder viterbi
    python -m convolutional_codes_tpu_torch.sim.cli bsc     --code 0 --decoder viterbi
    python -m convolutional_codes_tpu_torch.sim.cli awgn    --code k9-r12 --decoder stack
    python -m convolutional_codes_tpu_torch.sim.cli bsc     --code 0 --decoder fano
    python -m convolutional_codes_tpu_torch.sim.cli uncoded --code 0
    python -m convolutional_codes_tpu_torch.sim.cli awgn    --code nasa-k7 --stream-window 1920 \
        --points 6 --frames 65536

The sweep runs on the CUDA device; without one the CLI exits with an
error, and ``--cpu`` selects the CPU explicitly.  ``--bits-scale`` shrinks
the reference-sized tiers (8e8-bit base) for quick runs.  Stack and Fano
points size their lanes from the tiers (``sim/sweep.seq_plan``), not from
``--frames``; ``--timeout-per-bit`` sets the Fano budget.
``--stream-window`` runs Viterbi points on long streaming frames (the
fused long-frame kernel): ``--frames`` streams, each decoded in
overlap-save windows of that many payload symbols with
``--stream-warmup`` halo symbols on both sides.

``--mesh`` takes the reference's syntax (``frames=8``, ``sweep=2,frames=4``):
the slots are the visible cards, and a shape that does not match them
raises; with ``--cpu`` the CPU fills as many slots as the shape asks.
"""

from __future__ import annotations

import argparse
import math
import sys

import torch

from convolutional_codes_tpu_torch.models.codebook import get_code
from convolutional_codes_tpu_torch.parallel.mesh import make_mesh
from convolutional_codes_tpu_torch.sim.sweep import SweepSpec, run_sweep
from convolutional_codes_tpu_torch.utils import records as rec


def _code_key(s: str):
    try:
        return int(s)
    except ValueError:
        return s


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="convolutional_codes_tpu_torch.sim")
    sub = p.add_subparsers(dest="channel", required=True)
    for name in ("awgn", "bsc", "uncoded"):
        sp = sub.add_parser(name)
        sp.add_argument("--code", type=_code_key, default=0,
                        help="code registry index or name (default 0)")
        if name != "uncoded":
            sp.add_argument("--decoder", choices=("viterbi", "stack", "fano"),
                            default="viterbi")
            sp.add_argument("--demapper", choices=("soft", "hard"), default="soft")
            sp.add_argument("--timeout-per-bit", type=int, default=10000,
                            help="Fano decode budget (reference TIMEOUT)")
            sp.add_argument("--stream-window", type=int, default=0,
                            help="payload symbols a window of long streaming frames "
                                 "(Viterbi; default 0: terminated blocks)")
            sp.add_argument("--stream-warmup", type=int, default=128,
                            help="halo symbols on each side of a stream window")
        sp.add_argument("--points", type=float, nargs="*", default=None,
                        help="sweep points (Eb/N0 dB or crossover probs)")
        sp.add_argument("--frames", type=int, default=4096,
                        help="frames (lanes) per step")
        sp.add_argument("--bits-per-point", type=float, default=None)
        sp.add_argument("--bits-scale", type=float, default=1.0,
                        help="scale the reference 8e8-bit tier base")
        sp.add_argument("--seed", type=int, default=0)
        sp.add_argument("--cpu", action="store_true",
                        help="run on the CPU (default: the CUDA device)")
        sp.add_argument("--mesh", type=str, default=None,
                        help="mesh shape, e.g. 'frames=8' or 'sweep=2,frames=4'")
        sp.add_argument("--jsonl", type=str, default=None)
        sp.add_argument("--octave", type=str, default=None)
        sp.add_argument("--checkpoint", type=str, default=None,
                        help="JSON checkpoint for resumable sweeps")
        sp.add_argument("--trace", type=str, default=None, metavar="DIR",
                        help="one profiler trace a point under DIR/point_<p> "
                             "(Chrome trace JSON; the card's kernels under CUDA)")
    return p


def parse_mesh(arg, device: str = "cuda"):
    """``"sweep=2,frames=4"`` -> a mesh over the visible cards, or over as
    many CPU slots as the shape asks (``device="cpu"``, sizes given)."""
    if not arg:
        return None
    shape = {}
    for part in arg.split(","):
        k, v = part.split("=")
        shape[k.strip()] = int(v)
    if device == "cpu":
        if any(v < 1 for v in shape.values()):
            raise ValueError(f"--cpu --mesh needs every axis size, got {arg!r}")
        return make_mesh(shape, devices=[torch.device("cpu")] * math.prod(shape.values()))
    return make_mesh(shape)


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        parser.error("no CUDA device is available; pass --cpu to run on the CPU")
    device = "cpu" if args.cpu else "cuda"
    spec = SweepSpec(
        code=args.code,
        channel=args.channel,
        decoder=getattr(args, "decoder", "viterbi"),
        demapper=getattr(args, "demapper", "soft"),
        points=args.points,
        frames_per_step=args.frames,
        bits_per_point=args.bits_per_point,
        base_bits=8e8 * args.bits_scale,
        seed=args.seed,
        timeout_per_bit=getattr(args, "timeout_per_bit", 10000),
        trace_dir=args.trace,
        stream_window=getattr(args, "stream_window", 0),
        stream_warmup=getattr(args, "stream_warmup", 128),
    )
    code = get_code(args.code)
    print(f"code {code.name}: K={code.constraint_length} "
          f"rate 1/{code.symlen_out} block={code.block_length} "
          f"polys={[oct(p) for p in code.polynomials]} parity={code.parity} "
          f"device={device}")
    if spec.stream_window:
        print(f"long streaming frames: {spec.frames_per_step} streams, windows of "
              f"{spec.stream_window} + 2 x {spec.stream_warmup} symbols")
    mesh = parse_mesh(args.mesh, device)
    if mesh is not None:
        print(f"mesh {mesh.shape} on {mesh.size} {device} slots")
    results = run_sweep(spec, mesh=mesh, checkpoint_path=args.checkpoint, device=device)
    if args.jsonl:
        rec.write_jsonl(results, args.jsonl)
    if args.octave:
        if args.channel == "uncoded":
            # uncoded rows run no decoder: name the export from the record
            # fields, so curve tooling cannot take it for a coded curve
            var = f"uncoded_{code.symlen_out}bit_argmin"
        else:
            var = f"{args.channel}_{spec.decoder}_{code.name}".replace("-", "_")
        rec.write_octave([(var, results)], args.octave)
    return 0


if __name__ == "__main__":
    sys.exit(main())
