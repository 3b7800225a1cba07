"""Structured sweep-result output: JSON lines + Octave/MATLAB tables.

The same formats as the reference package's ``utils/records.py`` (ported
rather than imported: that package's ``utils`` imports JAX), so records of
either package can be read, diffed and plotted together with the published
``results/*.m`` tables.
"""

from __future__ import annotations

import json
from typing import Iterable, List, TextIO


def read_jsonl(path, record_type=None) -> List:
    """Read a results .jsonl file back; ``record_type`` (e.g.
    ``sim.sweep.PointRecord``) rebuilds typed records, else plain dicts."""
    with open(path) as f:
        rows = [json.loads(line) for line in f if line.strip()]
    if record_type is None:
        return rows
    return [record_type(**r) for r in rows]


def write_jsonl(records, path_or_file) -> None:
    f: TextIO
    if isinstance(path_or_file, str):
        with open(path_or_file, "w") as f:
            write_jsonl(records, f)
        return
    f = path_or_file
    for r in records:
        f.write(json.dumps(r.to_dict() if hasattr(r, "to_dict") else r) + "\n")


def _fmt(x: float) -> str:
    return f"{x:.6g}"


def octave_rows(records, varname: str) -> str:
    """One x-axis row + one BER row (+ FER row), Octave-style."""
    recs: List = list(records)
    xs = " ".join(_fmt(r.point) for r in recs)
    bers = " ".join(_fmt(r.ber) for r in recs)
    fers = " ".join(_fmt(r.fer) for r in recs)
    return (f"x_{varname} = [{xs}];\n"
            f"{varname} = [{bers}];\n"
            f"{varname}_fer = [{fers}];\n")


def write_octave(groups: Iterable, path: str) -> None:
    """``groups``: iterable of (varname, records). Writes one .m file."""
    with open(path, "w") as f:
        f.write("% generated by convolutional_codes_tpu_torch sweep runner\n")
        for varname, records in groups:
            f.write(octave_rows(records, varname))
