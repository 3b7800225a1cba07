"""The decode loop: a closed loop of one receiver decoding batches of
received long frames through the port's ``long_frame_decode_stream``.

Set-up makes a pool of ``pool`` received batches from the run's seed, on
the device, with the plain reference's generator
(``benchmark/reference/decode.received_batch``; nothing of the port):
``frames`` frames of ``info_bits`` info bits and the K - 1 zero tail, their
soft distances on AWGN at ``point`` dB, float32 ``[frames, T, M]``, and the
sent info bits, uint8.  It then decodes batches 0 and 1 as the window
does, warm.

The window: batch ``i`` decodes pool entry ``i mod pool`` through the
workload's ``entry`` (``module:function``, looked up at each call) and
counts the bit errors of its info bits against the sent bits on the
device; the host then reads batch ``i - 1``'s count, once a batch (on a
card through pinned memory and an event after that batch, so the read does
not wait for batch ``i``), so that one batch is queued behind the one the
card decodes while the host reads (a receiver that hands over one batch
while the next decodes; the host's work shows where it outlasts the
card's).  Batches run back to back until
the window's seconds have passed; the last span reads the last batch's
count too.  Batch ``i``'s enqueue and batch ``i - 1``'s read are the span
``bench_point_<i>``.  ``info_bits_per_s`` is the info bits of every batch
over the wall from the first batch's enqueue to the last count's read.

``correct`` compares what the timed path produced.  The loop keeps the
output of ``sample.batches`` batches drawn from the seed among the
window's first ``pool`` (the last batch stands in for a drawn one the
window did not reach).  Each check's limit is 0:
  * ``shape_gap``: batches of the window whose output is not
    ``[frames, T]`` integer bits (shape and dtype), and kept outputs
    holding a value other than 0 and 1;
  * ``errors_gap``: each kept batch's counted errors against a recount
    from its kept output and the reference's sent bits;
  * ``frames_off``: frames of the kept batches whose T decoded bits differ
    from the reference's decode of the same received batch
    (``reference/decode.decode``), every frame compared; a frame missing
    from the output is off.
"""

from __future__ import annotations

import importlib
import random
import time
from typing import Dict, List, Tuple

from benchmark.reference import decode as ref
from benchmark.reference.common import CodeSpec

#: keys of a workload file this loop reads
KEYS = {"traffic", "loop", "entry", "point", "frames", "info_bits", "pool", "sample",
        "limits"}
CHECKS = ("shape_gap", "errors_gap", "frames_off")


def validate(wl: dict, cfg: dict) -> None:
    """Refuse a workload file this loop cannot run."""
    missing, extra = KEYS - set(wl), set(wl) - KEYS
    if missing or extra:
        raise ValueError(f"workload keys: missing {sorted(missing)}, unknown {sorted(extra)}")
    if ":" not in wl["entry"]:
        raise ValueError(f"entry {wl['entry']!r} is not module:function")
    if set(wl["limits"]) != set(CHECKS):
        raise ValueError(f"limits {sorted(wl['limits'])} against {CHECKS}")
    if set(wl["sample"]) != {"batches"}:
        raise ValueError("sample needs batches")
    if cfg["channel"] != "awgn" or cfg["demapper"] != "soft":
        raise ValueError("received frames are soft distances on AWGN")
    for k in ("frames", "info_bits", "pool"):
        if int(wl[k]) <= 0:
            raise ValueError(f"{k} must be positive")
    if not 0 < int(wl["sample"]["batches"]) <= int(wl["pool"]):
        raise ValueError("sample.batches: 1 to pool, drawn among the first pool batches")


def picks(wl: dict, seed: int) -> List[int]:
    """The window's batches whose output a run seeded ``seed`` keeps."""
    return sorted(random.Random(f"{int(seed)}:batches").sample(
        range(int(wl["pool"])), int(wl["sample"]["batches"])))


def is_bits(out) -> bool:
    """An integer tensor (not bool): what the check can hold as bits."""
    import torch
    return not (out.dtype.is_floating_point or out.dtype.is_complex or out.dtype == torch.bool)


def control_readings(cfg: dict, wl: dict, seed: int, device, low_dtype) -> dict:
    """The numbers the check compares with the reference computed in
    ``low_dtype`` (its channel, distances and path metrics) in the
    program's place, against the float32 reference, on the first batch a
    run seeded ``seed`` keeps."""
    code = CodeSpec.from_config(cfg)
    index = picks(wl, seed)[0]
    _, d32 = ref.received_batch(code, cfg, wl, seed, index, device)
    want = ref.decode(code, d32)
    del d32
    _, low = ref.received_batch(code, cfg, wl, seed, index, device, low_dtype)
    got = ref.decode(code, low)
    return {"frames_off": ref.frames_off(got, want)}


class Loop:
    def __init__(self, cfg: dict, wl: dict, device, seed: int):
        validate(wl, cfg)
        self.cfg, self.wl, self.device, self.seed = cfg, wl, device, int(seed)
        self.code = CodeSpec.from_config(cfg)
        self.B, self.L = int(wl["frames"]), int(wl["info_bits"])
        self.T = ref.frame_symbols(self.code, wl)
        self.records: List[dict] = []
        self.spans: List[Tuple[float, float]] = []
        self.kept: List[Tuple[dict, object]] = []

    # ---------------------------------------------------------------- set-up
    def setup(self) -> None:
        """Import the port, build its code from the configuration, make the
        pool and decode two warm batches."""
        from convolutional_codes_tpu_torch.models.codebook import Code

        c = self.cfg["code"]
        self.port_code = Code(
            name=c["name"], symlen_out=c["symlen_out"], constraint_length=c["constraint_length"],
            block_length=c["block_length"], polynomials=tuple(c["polynomials"]),
            bit_metrics=tuple(c["bit_metrics"]), fano_bit_metrics=tuple(c["fano_bit_metrics"]),
            metric_weight=c["metric_weight"], fano_metric_weight=c["fano_metric_weight"],
            parity=c["parity"])
        mod_name, self._fn = self.wl["entry"].split(":")
        self._module = importlib.import_module(mod_name)
        self.pool = [ref.received_batch(self.code, self.cfg, self.wl, self.seed, j, self.device)
                     for j in range(int(self.wl["pool"]))]
        warm = [self._decode(j % len(self.pool))[1] for j in (0, 1)]   # two in flight
        for errors in warm:
            self._read({}, errors)

    def _decode(self, j: int):
        """(output, the bit errors of its info bits, or ``None`` where its
        shape or dtype is not bits) of pool entry ``j``, enqueued.  On a
        card the count is copied to pinned host memory behind the batch,
        with an event after the copy, so that reading it waits for this
        batch alone and not for the batches enqueued since."""
        import torch
        sent, dists = self.pool[j]
        out = getattr(self._module, self._fn)(self.port_code, dists)
        if tuple(out.shape) != (self.B, self.T) or not is_bits(out):
            return out, None
        errors = (out[:, :self.L] != sent).sum()
        if self.device.type != "cuda":
            return out, errors
        host = torch.empty((), dtype=errors.dtype, pin_memory=True)
        host.copy_(errors, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return out, (host, done)

    @staticmethod
    def _read(rec: dict, errors) -> None:
        """Read a batch's count into its record (-1: not bits), which waits
        for the batch."""
        if isinstance(errors, tuple):
            errors[1].synchronize()
            errors = errors[0]
        rec["bit_errors"] = -1 if errors is None else int(errors)
        rec["shape_ok"] = errors is not None

    # ---------------------------------------------------------------- window
    def window(self, seconds: float, annotate) -> None:
        """Batches back to back until ``seconds`` have passed."""
        keep = set(picks(self.wl, self.seed))
        n_pool = int(self.wl["pool"])
        t_first = time.perf_counter()
        i, queued = 0, None   # the record and count of the batch before
        while True:
            t0 = time.perf_counter()
            rec = {"batch": i, "pool": i % n_pool, "frames": self.B, "bits": self.B * self.L}
            with annotate(f"bench_point_{i}"):
                out, errors = self._decode(i % n_pool)
                if queued is not None:
                    self._read(*queued)
                last = time.perf_counter() - t_first >= seconds
                if last:
                    self._read(rec, errors)
            t1 = time.perf_counter()
            self.spans.append((t0, t1))
            self.records.append(rec)
            queued = (rec, errors)
            if len(self.kept) < len(keep) and (i in keep or last):
                self.kept.append((rec, out))
            del out
            i += 1
            if last:
                break

    def attempted(self) -> int:
        return len(self.records)

    def end_to_end(self) -> Dict[str, float]:
        bits = sum(r["bits"] for r in self.records)
        return {"info_bits_per_s": bits / (self.spans[-1][1] - self.spans[0][0])}

    def release(self) -> None:
        """Bring the kept outputs to the host and free the pool before the
        reference runs."""
        import torch
        self.kept = [(rec, out.cpu()) for rec, out in self.kept]
        self.pool = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # ---------------------------------------------------------------- check
    def check(self) -> List[Tuple[str, float, float]]:
        """(name, number, limit) of every comparison, summed over the kept
        batches."""
        import torch
        totals = {name: 0 for name in CHECKS}
        totals["shape_gap"] = sum(not r["shape_ok"] for r in self.records)
        for rec, got in self.kept:
            sent, dists = ref.received_batch(self.code, self.cfg, self.wl, self.seed,
                                             rec["pool"], self.device)
            want = ref.decode(self.code, dists).cpu()
            del dists
            if is_bits(got) and not bool(((got == 0) | (got == 1)).all()):
                totals["shape_gap"] += 1
            # a wrong shape's count is -1: recount what overlaps
            rows, cols = (min(got.shape[0], self.B), min(got.shape[1], self.L)) \
                if got.dim() == 2 else (0, 0)
            recount = int((got[:rows, :cols].to(torch.int64)
                           != sent.cpu()[:rows, :cols].to(torch.int64)).sum()) if rows else 0
            totals["errors_gap"] += abs(recount - rec["bit_errors"])
            totals["frames_off"] += ref.frames_off(got, want)
        limits = self.wl["limits"]
        return [(name, totals[name], limits[name]) for name in CHECKS]
