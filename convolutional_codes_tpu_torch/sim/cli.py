"""Command-line simulation drivers (the reference package's subcommands
and flags):

    python -m convolutional_codes_tpu_torch.sim.cli awgn    --code 0 --decoder viterbi
    python -m convolutional_codes_tpu_torch.sim.cli bsc     --code 0 --decoder viterbi
    python -m convolutional_codes_tpu_torch.sim.cli uncoded --code 0

The sweep runs on the CUDA device; without one the CLI exits with an
error, and ``--cpu`` selects the CPU explicitly.  ``--bits-scale`` shrinks
the reference-sized tiers (8e8-bit base) for quick runs.
"""

from __future__ import annotations

import argparse
import sys

import torch

from convolutional_codes_tpu.models.codebook import get_code
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
                        help="mesh shape (not ported yet)")
        sp.add_argument("--jsonl", type=str, default=None)
        sp.add_argument("--octave", type=str, default=None)
        sp.add_argument("--checkpoint", type=str, default=None,
                        help="JSON checkpoint for resumable sweeps")
        sp.add_argument("--trace", type=str, default=None, metavar="DIR",
                        help="per-point profiler traces (not ported yet)")
    return p


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.mesh:
        raise NotImplementedError("--mesh: meshes are not ported yet "
                                  "(ROADMAP Q1 item 14)")
    if args.trace:
        raise NotImplementedError("--trace: profiler traces are not ported yet "
                                  "(ROADMAP Q1 item 15)")
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
    )
    code = get_code(args.code)
    print(f"code {code.name}: K={code.constraint_length} "
          f"rate 1/{code.symlen_out} block={code.block_length} "
          f"polys={[oct(p) for p in code.polynomials]} parity={code.parity} "
          f"device={device}")
    results = run_sweep(spec, checkpoint_path=args.checkpoint, device=device)
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
